// The Mamba2 SSD chunked scan (state-space duality), hand-written for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py:31 (_kernel, launched by
// ssd_scan_bhsp :96), the Pallas TPU kernel of the reference package, and
// computes what it computes, plus an initial state and the final state
// (both part of the model's ssd_chunked, src/repro/models/ssm.py):
//
//   xdt (BH, S, P), logd (BH, S) and y (BH, S, P) float32; b and c
//   (B, S, N) float32, row bh reading batch row bh / n_heads.  Per chunk of
//   Q positions, with cum the prefix sum of logd within the chunk and St
//   the (P, N) state entering it:
//     y   = ((C B^T) o exp(cum_i - cum_j), masked to j <= i) @ xdt
//           + (C * exp(cum)) @ St^T
//     St <- exp(cum_Q) St + (B * exp(cum_Q - cum))^T @ xdt
//   A masked score is 0 and its exponent is never evaluated (an acausal
//   cum_i - cum_j is positive and may overflow, and inf * 0 is NaN).
//   Positions past S, and rows of the chunk tile past Q, load as zeros:
//   log-decay 0 and xdt 0, the reference's zero padding, so the final
//   state is the state after position S - 1.  No padding copy is made.
//
// Design.  The TPU kernel walks the chunks of one row on its sequential
// grid axis with the (P x N) state in VMEM scratch.  Here one block of 256
// threads owns one (bh, 64-column tile of P) -- the columns of xdt, y and
// the state's rows are independent -- and loops over the chunks itself,
// keeping its (64 x N) slice of the state in shared memory.  Per chunk:
//   1. warp 0 scans logd into cum; the chunk's xdt tile (row-major) and B
//      (transposed, n-major) are staged in shared memory as float32;
//   2. for each slab of 64 query rows: C's slab (transposed) is staged,
//      the slab's scores C B^T over the keys j < slab end are computed in
//      4 x 4 register tiles, decayed and masked, and stored transposed;
//      then each thread computes a 4 x 4 tile of y: scores @ xdt plus
//      exp(cum) * (C @ St^T), and writes it out;
//   3. B is scaled by exp(cum_Q - cum) in place and each thread updates
//      4 x 4 tiles of the state: St = exp(cum_Q) St + B'^T @ xdt.
// At Q = 128 and N = 128 the shared memory holds xdt (34.8 KB), B
// (67.6 KB), C's slab (34.8 KB), the state (34.8 KB) and the slab's scores
// (34.8 KB): 208 KB, under the 227 KB a block can have.  The C B^T tile is
// recomputed by every head, as in the TPU kernel.  Every product is an
// explicit fmaf in float32 (the repository builds with -fmad=false); all
// shared-memory reads of the products are 16-byte and conflict-free.
//
// What bounds it on an H100.  At mamba2-130m's prefill (BH = 8 x 24,
// S = 1895, P = 64, N = 128, Q = 128) the work is ~3.2e10 FLOPs against
// ~0.2 GB of inputs and outputs: operations bound it, ~0.48 ms at the
// 67 TFLOP/s float32 peak.  This kernel runs on the float32 CUDA cores (as
// the TPU kernel runs in float32), one block per SM (shared memory), and
// its products issue two 16-byte shared-memory loads per 16 fmaf; the
// 192 blocks of that shape fill 1.5 waves of 132 SMs.  Causal skipping of
// the upper slab's keys trims a quarter of the score work.  A chunk-
// parallel formulation (chunk states first, then one pass over chunks) and
// tensor-core products are the next design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;           // chunk tile rows (the largest chunk)
constexpr int kR = 64;            // query rows per slab
constexpr int kPT = 64;           // columns of P per block
constexpr int kThreads = 256;
constexpr int kXS = kPT + 4;      // row stride of xdt [j][p] and state [n][p]
constexpr int kBS = kQ + 4;       // row stride of B^T [n][j]
constexpr int kCS = kR + 4;       // row stride of C^T [n][i] and scores [j][i]

struct Args {
  const float* xdt;
  const float* logd;
  const float* b;
  const float* c;
  const float* init;  // null: a zero initial state
  float* y;
  float* state;
  int64_t bh, n_heads, s, p, n, chunk;
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int n_len = static_cast<int>(a.n);
  const int npad = (n_len + 3) & ~3;
  float* xs = smem;                 // [kQ][kXS]   xdt of the chunk
  float* bt = xs + kQ * kXS;        // [npad][kBS] B^T of the chunk
  float* ct = bt + npad * kBS;      // [npad][kCS] C^T of the slab
  float* st = ct + npad * kCS;      // [npad][kXS] the state, transposed
  float* sc = st + npad * kXS;      // [kQ][kCS]   the slab's scores, [j][i]
  float* cum = sc + kQ * kCS;       // [kQ]
  float* e_cum = cum + kQ;          // [kQ] exp(cum)
  float* e_tail = e_cum + kQ;       // [kQ] exp(cum_Q - cum)

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * kPT;
  const int64_t batch = row / a.n_heads;
  const int pw = static_cast<int>(a.p - p0 < kPT ? a.p - p0 : kPT);
  const int q_len = static_cast<int>(a.chunk);
  const int q_tile = q_len <= kR ? kR : kQ;
  const float* xg = a.xdt + row * a.s * a.p + p0;
  const float* lg = a.logd + row * a.s;
  const float* bg = a.b + batch * a.s * a.n;
  const float* cg = a.c + batch * a.s * a.n;
  float* yg = a.y + row * a.s * a.p + p0;

  // The state entering the first chunk; columns past P and rows past N
  // stay zero throughout (their B and xdt are zero).
  for (int e = tid; e < kPT * npad; e += kThreads) {
    const int pp = e / npad, nn = e - pp * npad;
    float v = 0.f;
    if (a.init != nullptr && pp < pw && nn < n_len)
      v = a.init[(row * a.p + p0 + pp) * a.n + nn];
    st[nn * kXS + pp] = v;
  }

  const int64_t n_chunks = (a.s + q_len - 1) / q_len;
  for (int64_t ci = 0; ci < n_chunks; ++ci) {
    const int64_t t0 = ci * q_len;
    const int q_valid = static_cast<int>(a.s - t0 < q_len ? a.s - t0 : q_len);
    __syncthreads();  // the previous chunk's update is done with xs, bt, st

    // 1. cum: warp 0, four positions a lane, then an inclusive warp scan.
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * tid + k;
        run += r < q_valid ? lg[t0 + r] : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float base = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[4 * tid + k] = base + v[k];
    }
    for (int e = tid; e < q_tile * kPT; e += kThreads) {
      const int r = e / kPT, pp = e - r * kPT;
      xs[r * kXS + pp] =
          r < q_valid && pp < pw ? xg[(t0 + r) * a.p + pp] : 0.f;
    }
    for (int e = tid; e < q_tile * npad; e += kThreads) {
      const int r = e / npad, nn = e - r * npad;
      bt[nn * kBS + r] =
          r < q_valid && nn < n_len ? bg[(t0 + r) * a.n + nn] : 0.f;
    }
    __syncthreads();
    const float total = cum[q_tile - 1];  // rows past Q add log-decay 0
    if (tid < q_tile) {
      e_cum[tid] = expf(cum[tid]);
      e_tail[tid] = expf(total - cum[tid]);
    }

    // 2. Slabs of kR query rows.
    for (int i0 = 0; i0 < q_tile; i0 += kR) {
      for (int e = tid; e < kR * npad; e += kThreads) {
        const int r = e / npad, nn = e - r * npad;
        const int qi = i0 + r;
        ct[nn * kCS + r] =
            qi < q_valid && nn < n_len ? cg[(t0 + qi) * a.n + nn] : 0.f;
      }
      __syncthreads();  // ct, and on the first slab e_cum / e_tail

      // Scores of rows i0 + 4rg.., keys 4cg.. (keys past the slab's last
      // row are masked for every row and skipped).
      const int j_len = i0 + kR;
      const int ncg = j_len / 4;
      for (int t = tid; t < (kR / 4) * ncg; t += kThreads) {
        const int rg = t / ncg, cgi = t - rg * ncg;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int nn = 0; nn < npad; ++nn) {
          float cv[4], bv[4];
          load4(ct + nn * kCS + 4 * rg, cv);
          load4(bt + nn * kBS + 4 * cgi, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + 4 * rg + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = 4 * cgi + j;
            sc[kj * kCS + 4 * rg + i] =
                kj <= qi ? acc[i][j] * expf(cum[qi] - cum[kj]) : 0.f;
          }
        }
      }
      __syncthreads();

      // y of rows i0 + 4ra.., columns 4pb..: scores @ xdt + exp(cum) C St^T.
      {
        const int ra = tid >> 4, pb = tid & 15;
        float acc[4][4], inter[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = inter[i][e] = 0.f;
        for (int j = 0; j < j_len; ++j) {
          float sv[4], xv[4];
          load4(sc + j * kCS + 4 * ra, sv);
          load4(xs + j * kXS + 4 * pb, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(sv[i], xv[e], acc[i][e]);
        }
        for (int nn = 0; nn < npad; ++nn) {
          float cv[4], sv[4];
          load4(ct + nn * kCS + 4 * ra, cv);
          load4(st + nn * kXS + 4 * pb, sv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              inter[i][e] = fmaf(cv[i], sv[e], inter[i][e]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + 4 * ra + i;
          if (qi >= q_valid) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 4 * pb + e;
            if (col < pw)
              yg[(t0 + qi) * a.p + col] = acc[i][e] + e_cum[qi] * inter[i][e];
          }
        }
      }
      __syncthreads();  // done with ct and sc
    }

    // 3. State update: St = exp(total) St + (B exp(total - cum))^T @ xdt.
    for (int e = tid; e < npad * q_tile; e += kThreads) {
      const int nn = e / q_tile, r = e - nn * q_tile;
      bt[nn * kBS + r] *= e_tail[r];
    }
    __syncthreads();
    const float decay = expf(total);
    for (int t = tid; t < (npad / 4) * (kPT / 4); t += kThreads) {
      const int pb = t % (kPT / 4), ng = t / (kPT / 4);
      float acc[4][4];  // [n][p]
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
      for (int j = 0; j < q_tile; j += 4) {
        float xv[4][4], bv[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) load4(xs + (j + k) * kXS + 4 * pb, xv[k]);
#pragma unroll
        for (int m = 0; m < 4; ++m) load4(bt + (4 * ng + m) * kBS + j, bv[m]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][e] = fmaf(bv[m][k], xv[k][e], acc[m][e]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* s = st + (4 * ng + m) * kXS + 4 * pb + e;
          *s = *s * decay + acc[m][e];
        }
    }
  }

  __syncthreads();
  for (int e = tid; e < pw * npad; e += kThreads) {
    const int pp = e / npad, nn = e - pp * npad;
    if (nn < n_len) a.state[(row * a.p + p0 + pp) * a.n + nn] = st[nn * kXS + pp];
  }
}

}  // namespace

// xdt (BH, S, P), logd (BH, S), y (BH, S, P), b and c (BH / n_heads, S, N),
// init_state (null or (BH, P, N)) and state (BH, P, N): contiguous float32.
// 1 <= chunk <= 128, 1 <= N <= 128, S >= 1.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int ssd_scan_launch(const void* xdt, const void* logd,
                               const void* b, const void* c,
                               const void* init_state, void* y, void* state,
                               int64_t bh, int64_t n_heads, int64_t s,
                               int64_t p, int64_t n, int64_t chunk, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kQ || n < 1 || n > 128 || s < 1 || n_heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xdt), static_cast<const float*>(logd),
               static_cast<const float*>(b),   static_cast<const float*>(c),
               static_cast<const float*>(init_state),
               static_cast<float*>(y),         static_cast<float*>(state),
               bh, n_heads, s, p, n, chunk};
  const int64_t npad = (n + 3) & ~int64_t{3};
  // xs, bt, ct, st, sc, cum / e_cum / e_tail: 208 KB at N = 128.
  const size_t smem = sizeof(float) * (kQ * kXS + npad * (kBS + kCS + kXS) +
                                       kQ * kCS + 3 * kQ);
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((p + kPT - 1) / kPT));
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
