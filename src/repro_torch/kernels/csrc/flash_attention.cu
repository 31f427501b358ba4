// Blocked online-softmax attention (causal, sliding window, GQA),
// hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:32 (_kernel, launched by
// flash_attention_bhsd :110), the Pallas TPU kernel of the reference
// package, and computes what it computes:
//
//   q (BHq, Sq, D), k and v (BHkv, Skv, D), float32 or bfloat16; query row
//   bh reads KV row bh / (BHq / BHkv).  Scores q.k^T * (1/sqrt(D)) in
//   float32; masked (kv_pos >= Skv; kv_pos > q_pos if causal;
//   q_pos - kv_pos >= window if a window is given) to -1e30, not -inf;
//   an online softmax over KV tiles with m, l and acc in float32, P.V in
//   float32; out = acc / max(l, 1e-30), rounded to q's dtype.
//
// The -1e30 sentinel matters: with a window, a row can meet a wholly
// masked tile before its first valid one.  There p = exp(0) = 1 for every
// masked entry, and the correction exp(-1e30 - m) of the first valid tile
// wipes it out; -inf would give NaN.
//
// Design.  One block of 256 threads owns one (bh, 64-row query tile); the
// TPU kernel's sequential KV grid axis becomes a loop over 64-key tiles
// inside the block.  Q (transposed) and each K tile (transposed) and V
// tile are staged through shared memory as float32; the P tile reuses the
// K tile's space.  Thread (ty, tx) of the 16 x 16 grid owns query rows
// 4ty..4ty+3: in Q.K^T it computes keys 4tx..4tx+3 of those rows, in P.V
// output columns 64g + 4tx .. 64g + 4tx + 3 for each 64-column group g
// (templated on the group count, so any D up to 256 works; columns past D
// are zero in V and never stored).  A row's running m and l live in
// registers of the 16 threads that share it and are reduced with warp
// shuffles (the xor butterfly leaves the same bits in every lane).  Ragged
// Sq and Skv tails are masked in the kernel: no padding copies.  Tiles
// wholly masked for every row of the query tile (past the causal diagonal,
// or wholly before every row's window) are skipped; that is exact for any
// row with at least one unmasked key (a skipped tile would only add
// exp(-1e30 - m) = 0, or terms the correction multiplies by 0).
//
// The products are explicit fmaf calls: the repository builds every kernel
// with -fmad=false (kernels/_build.py), which forbids contracting a*b+c
// but leaves an explicit fmaf alone.
//
// What bounds it on an H100.  At the serving path's shape (96 query rows
// of 2048 x 128 in bf16, causal) the work is ~1.0e11 FLOPs against ~117 MB
// of q, k, v and o: operations bound the card at ~0.10 ms on bf16 tensor
// cores.  This kernel does both products on the float32 CUDA cores (67
// TFLOP/s peak), as the TPU kernel does them in float32, so it cannot beat
// ~1.5 ms there, and its shared-memory loads (2 x 16-byte loads per 16
// fmaf in Q.K^T) keep it below that.  What the design does about it:
// causal and window tile skipping halves the work, float4 shared-memory
// reads with a 4 x 4 register tile per thread, and a reversed query-tile
// order so the longest causal tiles start first.  wgmma on bf16 tiles
// with TMA-fed pipelines is the next design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPad = 4;             // keeps float4 rows aligned
constexpr int kQS = kBQ + kPad;     // row stride of Qt (d-major)
constexpr int kKS = kBK + kPad;     // row stride of Kt (d-major)
constexpr int kPS = kBQ + kPad;     // row stride of Pt (key-major)
constexpr float kNegInf = -1e30f;   // the reference's mask sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

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

// NG: 64-column groups of the output (D <= 64 * NG).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Args a) {
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
  const T* qg = static_cast<const T*>(a.q) + bh * a.sq * d_len;
  const T* kg = static_cast<const T*>(a.k) + (bh / group) * a.skv * d_len;
  const T* vg = static_cast<const T*>(a.v) + (bh / group) * a.skv * d_len;
  T* og = static_cast<T*>(a.o) + bh * a.sq * d_len;

  // Q tile, transposed; rows past Sq are zero.  Thread tid walks the
  // tile's (row, column) pairs tid, tid + 256, ... in row-major order.
  const int dd = static_cast<int>(d_len);
  const int r_start = tid / dd, c_start = tid - r_start * dd;
  for (int r = r_start, c = c_start; r < kBQ;) {
    const int64_t qp = q0 + r;
    qt[c * kQS + r] = qp < a.sq ? to_f32(qg[qp * d_len + c]) : 0.f;
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
      kt[c * kKS + r] = in ? to_f32(kg[kp * d_len + c]) : 0.f;
      vs[r * kDP + c] = in ? to_f32(vg[kp * d_len + c]) : 0.f;
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
          og[qp * d_len + col] = from_f32<T>(acc[i][4 * g + e] / denom);
      }
  }
}

template <typename T, int NG>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t k_or_p = a.d * kKS > kBK * kPS ? a.d * kKS : kBK * kPS;
  const size_t smem =
      sizeof(float) * (a.d * kQS + k_or_p + static_cast<int64_t>(kBK) * 64 * NG);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.bhq));
  flash_attention_kernel<T, NG><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 1>(a, stream);
  if (a.d <= 128) return launch<T, 2>(a, stream);
  return launch<T, 4>(a, stream);
}

}  // namespace

// q, k, v, o: contiguous (BHq, Sq, D), (BHkv, Skv, D), (BHkv, Skv, D),
// (BHq, Sq, D) of one dtype (bf16 if is_bf16, else float32); BHq a multiple
// of BHkv; 1 <= D <= 256; Sq >= 1; window <= 0 means none.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t bhq,
                                      int64_t bhkv, int64_t sq, int64_t skv,
                                      int64_t d, int causal, int64_t window,
                                      float scale, int is_bf16, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, bhq, bhkv, sq, skv, d, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, st) : dispatch<float>(a, st);
}
