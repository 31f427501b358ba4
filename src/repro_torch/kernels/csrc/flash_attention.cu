// Blocked online-softmax attention (causal, sliding window, GQA),
// hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:32 (_kernel, launched by
// flash_attention_bhsd :110), the Pallas TPU kernel of the reference
// package, and computes what it computes:
//
//   q (BHq, Sq, D), k and v (BHkv, Skv, D), one dtype; query row bh reads
//   KV row bh / (BHq / BHkv).  Scores q.k^T * scale (scale = 1/sqrt(D) of
//   the caller's D) in float32; masked (kv_pos >= Skv; kv_pos > q_pos if
//   causal; q_pos - kv_pos >= window if a window is given) to -1e30, not
//   -inf; an online softmax over KV tiles with m, l and acc in float32;
//   P.V at float32 accuracy; out = acc / max(l, 1e-30), rounded to q's
//   dtype.
//
// The -1e30 sentinel matters: with a window, a row can meet a wholly
// masked tile before its first valid one.  There p = exp(0) = 1 for every
// masked entry, and the correction exp(-1e30 - m) of the first valid tile
// wipes it out; -inf would give NaN.  Tiles wholly masked for every row of
// a query tile (past the causal diagonal, or wholly before every row's
// window) are never computed; that is exact for any row with at least one
// unmasked key (a skipped tile would only add exp(-1e30 - m) = 0, or
// terms the correction multiplies by 0).  Only tiles on the diagonal, at
// the window's edge or past Skv are masked elementwise.
//
// The entry point dispatches on the dtype (explicitly; nothing falls back):
//
// * bfloat16 and float16: the tensor-core kernel (wgmma_kernel).
// * float32: the CUDA-core kernel (simt_kernel), whose products are in
//   float32 as the reference's are; wgmma has no float32 x float32 form
//   (only TF32, which would round q, k and v).
//
// What bounds it on an H100.  At qwen2-1.5B's serving shape (q (96, 1895,
// 128), k and v (16, 1895, 128) bf16, causal) the two products are 88
// GFLOP over the unmasked pairs against 109 MB of q, k, v and o:
// operations bound it, 88 GFLOP at 989 TFLOP/s of bf16 tensor cores =
// 0.089 ms (bytes: 0.032 ms).  The float32 CUDA cores (67 TFLOP/s) could
// not beat 1.3 ms there.
//
// What the 16-bit design does about it.  One block owns one (bh, query
// tile) of 64 * NWG rows: NWG consumer warpgroups of 64 rows each (2 for
// head dims up to 128; 1 at 256, whose 64 x 256 float32 accumulator alone
// is 128 registers a thread) and one producer warpgroup, of which one
// thread issues every load.  setmaxnreg moves registers from the producer
// (24) to the consumers (240) where there are two consumer warpgroups;
// with one, the launch bound already allows 255.
//
// * Loads.  TMA through 3-D tensor maps over (BH, S, D): Q once, then K
//   and V tiles of 64 keys into a ring of kStages stages with full / empty
//   mbarriers.  Each tile is stored as 64-column panels of 64 rows x 128
//   bytes in TMA's 128-byte swizzle, the layout wgmma reads without bank
//   conflicts.  TMA's out-of-bounds zero fill covers the ragged Sq and Skv
//   tails and the columns past D within a panel; the mask covers kv_pos >=
//   Skv.  D must be a multiple of 16 (whole k16 steps; the wrapper pads
//   with zero columns, which add nothing to q.k and give zero output
//   columns).
// * S = Q.K^T on tensor cores: wgmma m64n64k16 with Q (A) and K (B) from
//   shared memory, both K-major (rows contiguous in D), float32
//   accumulators.  Products of two 16-bit values are exact in float32, so
//   S differs from the reference's only in summation order.
// * Softmax in registers on the accumulator fragment (each thread holds
//   two rows, 16 keys of each): row max over the quad by shuffles.  The
//   exponentials are 2^x (ex2.approx.ftz, 2 ulp) with log2(e) folded into
//   the scale: s * (scale * log2 e) - m in the log2 domain, which is
//   exp(s * scale - m') up to float32 rounding; the sentinel keeps its
//   meaning (2^(-1e30 - m) = 0).  l sums the float32 p.
// * O += P.V on tensor cores at float32 accuracy.  The reference
//   multiplies float32 p by v cast to float32.  wgmma takes a 16-bit A,
//   so each p is split in two parts of the input's 16-bit type, P_hi =
//   round16(p) and P_lo = round16(p - P_hi) (the difference is exact in
//   float32), and both are register A operands of wgmma m64nDk16 into the
//   same float32 accumulator.  P_hi + P_lo is within 2^-18 * p of p in
//   bfloat16 (float16: 2^-22 * p, or 2^-25 where P_lo is subnormal), and
//   each product of a part and a 16-bit v is exact in float32: the error
//   is of the order of the float32 rounding already in the scores and
//   the exponent, and far below the output's 16-bit rounding (a single
//   16-bit P would carry 2^-9 * p).  The price is one more m64nDk16 per
//   k16 step.  The accumulator layout of m64n64 is the A-operand layout
//   of k16, so the parts never leave registers.  V's tile (keys x D, D
//   contiguous) is MN-major for B, which wgmma takes for 16-bit types
//   through its transpose bit: no transpose pass.
// * Epilogue: acc / max(l, 1e-30) rounded to the input type, written into
//   the warpgroup's own Q tile in the swizzled layout and stored by TMA
//   (which clips the rows past Sq and the columns past D).
// * Longest causal query tiles first; one launch a call.
//
// Every product is an explicit instruction: the repository builds every
// kernel with -fmad=false (kernels/_build.py), which forbids contracting
// a*b+c but leaves an explicit fmaf alone.  The tensor maps are encoded on
// the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion so that the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// float32: the CUDA-core kernel.

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPad = 4;             // keeps float4 rows aligned
constexpr int kQS = kBQ + kPad;     // row stride of Qt (d-major)
constexpr int kKS = kBK + kPad;     // row stride of Kt (d-major)
constexpr int kPS = kBQ + kPad;     // row stride of Pt (key-major)
constexpr float kNegInf = -1e30f;   // the reference's mask sentinel

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t bhq, bhkv, sq, skv, d;
  int causal;
  int64_t window;  // <= 0: no window
  float scale;
};

// One block of 256 threads owns one (bh, 64-row query tile) and loops over
// 64-key tiles.  Q (transposed), each K tile (transposed) and V tile are
// staged through shared memory as float32; the P tile reuses the K tile's
// space.  Thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3:
// in Q.K^T keys 4tx..4tx+3, in P.V output columns 64g + 4tx .. 64g + 4tx +
// 3 of each 64-column group g.  A row's m and l live in registers of the
// 16 threads that share it and are reduced with warp shuffles (the xor
// butterfly leaves the same bits in every lane); ragged tails are masked
// in the kernel.  NG: 64-column groups of the output (D <= 64 * NG).
template <int NG>
__global__ void __launch_bounds__(kThreads)
    simt_kernel(const Args a) {
  constexpr int kDP = 64 * NG;  // padded head dim of the V tile
  extern __shared__ float smem[];
  const int64_t d_len = a.d;
  float* qt = smem;                      // (D, kQS)
  float* kt = qt + d_len * kQS;          // (D, kKS), then Pt (kBK, kPS)
  float* vs = kt + (d_len * kKS > kBK * kPS ? d_len * kKS : kBK * kPS);
  float* pt = kt;                        // (kBK, kPS), reuses Kt

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t bh = blockIdx.y;
  // Longest causal tiles first.
  const int64_t q_tile = gridDim.x - 1 - blockIdx.x;
  const int64_t q0 = q_tile * kBQ;
  const int64_t group = a.bhq / a.bhkv;
  const float* qg = static_cast<const float*>(a.q) + bh * a.sq * d_len;
  const float* kg = static_cast<const float*>(a.k) + (bh / group) * a.skv * d_len;
  const float* vg = static_cast<const float*>(a.v) + (bh / group) * a.skv * d_len;
  float* og = static_cast<float*>(a.o) + bh * a.sq * d_len;

  // Q tile, transposed; rows past Sq are zero.  Thread tid walks the
  // tile's (row, column) pairs tid, tid + 256, ... in row-major order.
  const int dd = static_cast<int>(d_len);
  const int r_start = tid / dd, c_start = tid - r_start * dd;
  for (int r = r_start, c = c_start; r < kBQ;) {
    const int64_t qp = q0 + r;
    qt[c * kQS + r] = qp < a.sq ? qg[qp * d_len + c] : 0.f;
    for (c += kThreads; c >= dd; c -= dd) ++r;
  }
  // V columns past D stay zero for the whole loop.
  for (int e = tid; e < kBK * kDP; e += kThreads) {
    if ((e % kDP) >= dd) vs[e] = 0.f;
  }

  // KV tile range: skip tiles masked for every row of this query tile.
  int64_t kv_lo = 0, kv_hi = a.skv;  // [kv_lo, kv_hi)
  if (a.causal) {
    const int64_t last = q0 + kBQ;  // one past the tile's last row
    kv_hi = kv_hi < last ? kv_hi : last;
  }
  if (a.window > 0) {
    const int64_t first = q0 - a.window + 1;
    kv_lo = first > 0 ? first : 0;
  }
  const int64_t t_begin = kv_lo / kBK;
  const int64_t t_end = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : t_begin;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's P.V is done with Pt and V
    for (int r = r_start, c = c_start; r < kBK;) {
      const int64_t kp = k0 + r;
      const bool in = kp < a.skv;
      kt[c * kKS + r] = in ? kg[kp * d_len + c] : 0.f;
      vs[r * kDP + c] = in ? vg[kp * d_len + c] : 0.f;
      for (c += kThreads; c >= dd; c -= dd) ++r;
    }
    __syncthreads();

    // s = Q K^T for rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < dd; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + c * kQS + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(kt + c * kKS + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // Scale, mask, online softmax.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kp = k0 + 4 * tx + j;
        bool ok = kp < a.skv;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done reading Kt
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 pv = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kPS + 4 * ty) = pv;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= corr[i];
    __syncthreads();

    // acc += P V for rows 4ty.., columns 64g + 4tx..
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kPS + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * kDP + 64 * g + 4 * tx);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * g + e] = fmaf(pa[i], va[e], acc[i][4 * g + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qp = q0 + 4 * ty + i;
    if (qp >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t col = 64 * g + 4 * tx + e;
        if (col < d_len)
          og[qp * d_len + col] = acc[i][4 * g + e] / denom;
      }
  }
}

template <int NG>
int launch_simt(const Args& a, cudaStream_t stream) {
  const int64_t k_or_p = a.d * kKS > kBK * kPS ? a.d * kKS : kBK * kPS;
  const size_t smem =
      sizeof(float) * (a.d * kQS + k_or_p + static_cast<int64_t>(kBK) * 64 * NG);
  cudaError_t err = cudaFuncSetAttribute(
      simt_kernel<NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.bhq));
  simt_kernel<NG><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: TMA-fed wgmma kernel.

constexpr int kRows = 64;          // query rows of a warpgroup; keys of a tile
constexpr int kPanelBytes = 8192;  // 64 rows x 128 bytes (64 16-bit columns)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;   // setmaxnreg, two consumer warpgroups
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536

// Shared-memory plan of one block: Q (NWG warpgroups x panels), then the K
// ring and the V ring (kStages tiles of panels each), then the mbarriers.
template <int DP, int NWG>
struct Plan {
  static constexpr int kPanels = DP / 64;
  static constexpr int kStages = DP == 256 ? 2 : 3;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // one K or V tile
  static constexpr int kQBytes = NWG * kTileBytes;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], kv_empty[kStages]
  static constexpr int kBarBytes = 8 * (1 + 3 * kStages);
  // + 1024: the base is rounded up to the 1024-byte swizzle atom.
  static constexpr int kSmem = kBarOffset + kBarBytes + 1024;
  // NWG consumer warpgroups, then the producer warpgroup.
  static constexpr int kThreads = (NWG + 1) * 128;
};

struct WgmmaArgs {
  int sq, skv;
  int group;         // BHq / BHkv
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// The producer's arrival, announcing `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of 64 x 64 elements (c0: column, c1: row, c2: bh) into `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Every warp of a warpgroup executes these together.
template <int N>
__device__ __forceinline__ void regs_grow() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_shrink() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no access to them across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit (one MUFU.EX2, 2 ulp), with results
// below 2^-126 flushed to zero.  ex2(-1e30 - m) = 0 and ex2(0) = 1 keep the
// sentinel's meaning.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two float32 values as 16-bit pairs (the first in the low half, as the
// A fragment holds the lower column there): hi = round16(x), lo =
// round16(x - hi).  The subtraction is exact: hi is x rounded to fewer bits.
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo);
template <>
__device__ __forceinline__ void split2<__nv_bfloat16>(float x0, float x1, uint32_t& hi,
                                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void split2<__half>(float x0, float x1, uint32_t& hi,
                                               uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two float32 values rounded to one 16-bit pair (the epilogue's cast).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x0, float x1) {
  const __half2 v = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma, float32 accumulators d; A and B from shared memory (descriptors
// da, db), or A from registers (a[4], 16-bit pairs) and B transposed.
// `accumulate` 0 overwrites d.
#define FA_WGMMA_SS_N64(TY)                                                                                     \
  asm volatile(                                                                                                 \
      "{\n\t.reg .pred p;\n\t"                                                                                  \
      "setp.ne.b32 p, %34, 0;\n\t"                                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "%32, %33, p, 1, 1, 0, 0;\n\t}"                                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "l"(da), "l"(db), "r"(accumulate))

#define FA_WGMMA_RS_N64(TY)                                                                                     \
  asm volatile(                                                                                                 \
      "{\n\t.reg .pred p;\n\t"                                                                                  \
      "setp.ne.b32 p, %37, 0;\n\t"                                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

#define FA_WGMMA_RS_N128(TY)                                                                                    \
  asm volatile(                                                                                                 \
      "{\n\t.reg .pred p;\n\t"                                                                                  \
      "setp.ne.b32 p, %69, 0;\n\t"                                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

#define FA_WGMMA_RS_N256(TY)                                                                                            \
  asm volatile(                                                                                                         \
      "{\n\t.reg .pred p;\n\t"                                                                                          \
      "setp.ne.b32 p, %133, 0;\n\t"                                                                                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                                \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                                \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                                \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                    \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "               \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n\t}"                                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),         \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),         \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),         \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),     \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    FA_WGMMA_SS_N64("f16");
  } else {
    FA_WGMMA_SS_N64("bf16");
  }
}

template <typename T, int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  const int accumulate = 1;
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (DP == 64) {
    if constexpr (kHalf) { FA_WGMMA_RS_N64("f16"); } else { FA_WGMMA_RS_N64("bf16"); }
  } else if constexpr (DP == 128) {
    if constexpr (kHalf) { FA_WGMMA_RS_N128("f16"); } else { FA_WGMMA_RS_N128("bf16"); }
  } else {
    if constexpr (kHalf) { FA_WGMMA_RS_N256("f16"); } else { FA_WGMMA_RS_N256("bf16"); }
  }
}

// DP: the head dim padded to whole 64-column panels (64, 128 or 256).
// NWG: consumer warpgroups, 64 query rows each.  Threads [0, 128 NWG)
// consume; the warpgroup after them produces.
template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(Plan<DP, NWG>::kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, const WgmmaArgs a) {
  using P = Plan<DP, NWG>;
  constexpr int kStages = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // Q: [NWG][panel][64 x 128 B]
  const uint32_t k_s = q_s + P::kQBytes;       // K: [stage][panel][64 x 128 B]
  const uint32_t v_s = k_s + kStages * P::kTileBytes;
  const uint32_t q_full = q_s + P::kBarOffset;
  const uint32_t k_full = q_full + 8;             // [kStages]
  const uint32_t v_full = k_full + 8 * kStages;   // [kStages]
  const uint32_t kv_empty = v_full + 8 * kStages; // [kStages]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int bh = blockIdx.y;
  // Longest causal tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kRows * NWG);
  const int q_end = min(q0 + kRows * NWG, a.sq);  // one past the last row
  const int n_active = (q_end - q0 + kRows - 1) / kRows;  // warpgroups with rows

  // KV tile range: skip tiles masked for every row of this block.
  int kv_lo = 0, kv_hi = a.skv;  // [kv_lo, kv_hi)
  if (a.causal) kv_hi = min(kv_hi, q_end);
  if (a.window > 0) kv_lo = max(0, q0 - a.window + 1);
  const int t_begin = kv_lo / kRows;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + kRows - 1) / kRows - t_begin : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 4 * NWG);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // Producer warpgroup: one thread issues every load; the others leave.
    if constexpr (NWG > 1) regs_shrink<kProducerRegs>();
    if (tid == 128 * NWG) {
      const int bh_kv = bh / a.group;
      mbar_expect_tx(q_full, n_active * P::kTileBytes);
      for (int w = 0; w < n_active; ++w)
        for (int p = 0; p < P::kPanels; ++p)
          tma_load(q_s + (w * P::kPanels + p) * kPanelBytes, &q_map, q_full,
                   64 * p, q0 + kRows * w, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // Until the consumers have released the stage's previous tile.
        mbar_wait(kv_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const int k0 = (t_begin + it) * kRows;
        mbar_expect_tx(k_full + 8 * s, P::kTileBytes);
        for (int p = 0; p < P::kPanels; ++p)
          tma_load(k_s + s * P::kTileBytes + p * kPanelBytes, &k_map,
                   k_full + 8 * s, 64 * p, k0, bh_kv);
        mbar_expect_tx(v_full + 8 * s, P::kTileBytes);
        for (int p = 0; p < P::kPanels; ++p)
          tma_load(v_s + s * P::kTileBytes + p * kPanelBytes, &v_map,
                   v_full + 8 * s, 64 * p, k0, bh_kv);
      }
    }
    return;
  }
  if constexpr (NWG > 1) regs_grow<kConsumerRegs>();

  // Consumer warpgroup wg: rows row0 .. row0 + 63; this thread holds rows
  // r_lo and r_lo + 8 of each accumulator (the wgmma fragment layout:
  // register i is row half (i >> 1) & 1, column 8 (i >> 2) + 2 (lane & 3)
  // + (i & 1)).
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + kRows * wg;
  const int r_lo = row0 + 16 * warp + lane / 4;
  const bool idle = row0 >= a.sq;  // every row past Sq: nothing to compute
  const uint32_t q_wg = q_s + wg * P::kTileBytes;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad at the end

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (t_begin + it) * kRows;
    // Every consumer waits for both loads of the stage, so that no stage is
    // refilled while a load into it is in flight.
    mbar_wait(k_full + 8 * s, parity);
    const bool skip = idle || (a.causal && k0 > row0 + kRows - 1) ||
                      (a.window > 0 && row0 - (k0 + kRows - 1) >= a.window);
    if (!skip) {
      // S = Q K^T, DP / 16 steps of k16.
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      const uint32_t k_tile = k_s + s * P::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // Step kk: 32 bytes into the rows of panel kk / 4.
        const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_qk<T>(sc, smem_desc(q_wg + off, 16, 1024),
                    smem_desc(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Scale to the log2 domain, mask, online softmax.
      const bool masked = k0 + kRows > a.skv ||
                          (a.causal && k0 + kRows - 1 > row0) ||
                          (a.window > 0 && row0 + kRows - 1 - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= a.scale_log2;
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r_lo + 8 * ((i >> 1) & 1);
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = col < a.skv;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && row - col < a.window;
          if (!ok) sc[i] = kNegInf;
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = exp2_ftz(m[h] - m_new);
        m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2_ftz(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V: P's 64 keys as 4 k16 steps, each split in a high and a
      // low 16-bit part (register A operands).
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r],
                    p_lo[kk][r]);
      mbar_wait(v_full + 8 * s, parity);
      const uint32_t v_tile = v_s + s * P::kTileBytes;
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // B = V rows 16 kk .. 16 kk + 15, MN-major: 8-key groups 1024 bytes
        // apart (stride), 64-column panels kPanelBytes apart (leading).
        const uint64_t vd = smem_desc(v_tile + kk * 2048, kPanelBytes, 1024);
        wgmma_pv<T, DP>(o, p_hi[kk], vd);
        wgmma_pv<T, DP>(o, p_lo[kk], vd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    } else {
      mbar_wait(v_full + 8 * s, parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + 8 * s);
  }
  if (idle) return;

  // Epilogue: out = acc / max(l, 1e-30), into this warpgroup's Q tile (its
  // last reader, the final Q K^T, has completed) in the 128-byte swizzled
  // layout, then one TMA store per panel.
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    den[h] = fmaxf(lh, 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int row = 16 * warp + lane / 4 + 8 * h;  // within the warpgroup
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    const int cc = col % 64;
    const uint32_t addr = q_wg + (col / 64) * kPanelBytes + row * 128 +
                          (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
    const uint32_t val = pack2<T>(o[i] / den[h], o[i + 1] / den[h]);
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(val) : "memory");
  }
  // The generic-proxy writes become visible to TMA (the async proxy), then
  // one thread of the warpgroup stores once all 128 have written.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
    for (int p = 0; p < P::kPanels; ++p)
      tma_store(&o_map, q_wg + p * kPanelBytes, 64 * p, row0, bh);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda); null if the driver does not provide it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes of the 16-bit path beyond the CUDA runtime's (< 1000).
constexpr int kNoEncodeEntry = 1999;  // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 2000;   // + the CUresult of the encoding

// A 3-D map over (bh, s, dg), innermost first; boxes of 64 columns x 64
// rows x 1, 128-byte swizzle, zeros out of bounds.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               int64_t bh, int64_t s, int64_t dg) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dg),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dg * 2),
                                 static_cast<cuuint64_t>(s * dg * 2)};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <typename T, int DP, int NWG>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  using P = Plan<DP, NWG>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[4];
  int err = encode_map(&maps[0], type, a.q, a.bhq, a.sq, a.d);
  if (!err) err = encode_map(&maps[1], type, a.k, a.bhkv, a.skv, a.d);
  if (!err) err = encode_map(&maps[2], type, a.v, a.bhkv, a.skv, a.d);
  if (!err) err = encode_map(&maps[3], type, a.o, a.bhq, a.sq, a.d);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_kernel<T, DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int window =
      a.window <= 0 ? 0 : static_cast<int>(a.window < INT_MAX ? a.window : INT_MAX);
  const WgmmaArgs w{static_cast<int>(a.sq), static_cast<int>(a.skv),
                    static_cast<int>(a.bhq / a.bhkv), a.causal, window,
                    a.scale * kLog2e};
  const dim3 grid(static_cast<unsigned>((a.sq + kRows * NWG - 1) / (kRows * NWG)),
                  static_cast<unsigned>(a.bhq));
  wgmma_kernel<T, DP, NWG><<<grid, P::kThreads, P::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return launch_wgmma<T, 64, 2>(a, stream);
  if (a.d <= 128) return launch_wgmma<T, 128, 2>(a, stream);
  return launch_wgmma<T, 256, 1>(a, stream);
}

int dispatch_simt(const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return launch_simt<1>(a, stream);
  if (a.d <= 128) return launch_simt<2>(a, stream);
  return launch_simt<4>(a, stream);
}

}  // namespace

// q, k, v, o: contiguous (BHq, Sq, D), (BHkv, Skv, D), (BHkv, Skv, D),
// (BHq, Sq, D) of one dtype: 0 float32, 1 bfloat16, 2 float16.  BHq a
// multiple of BHkv and at most 65,535; 1 <= D <= 256; 1 <= Sq, Skv < 2^31;
// window <= 0 means none; scale = 1 / sqrt(the caller's head dim).  For
// 16-bit dtypes D must be a multiple of 16 and q, k, v, o 16-byte aligned
// (the tensor maps' rows).  Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for arguments outside this contract),
// 1999 if the driver has no cuTensorMapEncodeTiled, 2000 + its CUresult if
// an encoding fails.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t bhq,
                                      int64_t bhkv, int64_t sq, int64_t skv,
                                      int64_t d, int causal, int64_t window,
                                      float scale, int dtype, int device,
                                      void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (bhq < 1 || bhq > 65535 || bhkv < 1 || bhq % bhkv || d < 1 || d > 256 ||
      sq < 1 || skv < 1 || sq > INT_MAX || skv > INT_MAX)
    return invalid;
  if (dtype != 0) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
    if (d % 16 || any % 16) return invalid;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, bhq, bhkv, sq, skv, d, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_simt(a, st);
    case 1:
      return dispatch_wgmma<__nv_bfloat16>(a, st);
    case 2:
      return dispatch_wgmma<__half>(a, st);
    default:
      return invalid;
  }
}
