// Row RMSNorm over the last dimension, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py:23 (_kernel, launched by
// rmsnorm_2d :35), the Pallas TPU kernel of the reference package, and
// computes what it computes, in its order of operations:
//
//   x32    = float(x)                          (row of D values)
//   mean   = sum(x32 * x32) / D                (float32)
//   normed = x32 * rsqrt(mean + eps)
//   out    = normed * w  or  normed * (1 + w)  (offset: the Gemma form)
//   cast to x's dtype (round to nearest even)
//
// x and out (T, D) bfloat16, float16 or float32; w (D,) float32 or
// bfloat16.  w is never folded into the reciprocal: each product rounds
// where the reference's does, and the repository builds with -fmad=false,
// so only the order of the sum of squares differs from the plain torch
// version.  The reciprocal is rsqrtf, the device function that torch.rsqrt
// runs on a CUDA float32 tensor (the plain version's), not 1.0f / sqrtf.
//
// Design.  The TPU kernel normalizes 256-row blocks held in VMEM.  Here one
// block owns one row: its threads read the row once with 16-byte vector
// loads and keep the vectors in registers (at most kVecPerThread each),
// sum the squares in float32 (per thread, then warp shuffles, then the
// warps' partial sums through shared memory), and write the normalized row
// with 16-byte stores.  A row whose start is not 16-byte aligned (D not a
// multiple of the vector width) has a scalar head up to the first aligned
// element and a scalar tail after the last whole vector, one element per
// thread.  The block has 32 threads (one warp) up to 4 x 32 vectors a row
// -- D <= 1024 in bf16 -- and grows in warps with D, to 1024 threads at
// D = 16384 in float32.
//
// What bounds it on an H100.  It reads x and w and writes out once, 4
// float32 operations an element: bytes bound it (qwen2-1.5B's prefill
// norm, 15160 x 1536 bf16, moves 93 MB: 0.028 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecPerThread = 4;
constexpr int kMaxThreads = 1024;
constexpr int64_t kMaxD = 16384;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T: one vector load or store.
template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

// The block's sum of v, in every thread.  blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int n_warps = blockDim.x >> 5;
  if (n_warps == 1) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = lane < n_warps ? warp_sums[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  return total;
}

template <typename W>
__device__ __forceinline__ float scale(float xv, float r, const W* w, int j,
                                       bool offset) {
  const float normed = xv * r;
  const float wv = to_f32(w[j]);
  return offset ? normed * (1.0f + wv) : normed * wv;
}

// One block per row.  x and out have 16-byte aligned bases (the wrapper's
// contract), so row r of both starts at the same offset within 16 bytes.
template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, int d, float eps, bool offset) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float warp_sums[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  const int misalign =
      static_cast<int>((reinterpret_cast<uintptr_t>(xr) & 15) / sizeof(T));
  const int head = min(misalign ? kVec - misalign : 0, d);
  const int n_vec = (d - head) / kVec;
  const int tail = head + n_vec * kVec;  // first element of the scalar tail
  const int n_scalar = head + (d - tail);  // < 2 * kVec <= blockDim.x
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr + head);
  Vec<T>* ov = reinterpret_cast<Vec<T>*>(orow + head);

  Vec<T> cache[kVecPerThread];
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_vec) {
      cache[k] = xv[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(cache[k].v[e]);
        sq += f * f;
      }
    }
  }
  int js = -1;  // this thread's scalar element, if any
  float xs = 0.0f;
  if (static_cast<int>(threadIdx.x) < n_scalar) {
    const int t = threadIdx.x;
    js = t < head ? t : tail + (t - head);
    xs = to_f32(xr[js]);
    sq += xs * xs;
  }

  const float mean = block_sum(sq, warp_sums) / static_cast<float>(d);
  const float r = rsqrtf(mean + eps);

#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n_vec) {
      Vec<T> o;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        o.v[e] = from_f32<T>(
            scale(to_f32(cache[k].v[e]), r, w, head + i * kVec + e, offset));
      ov[i] = o;
    }
  }
  if (js >= 0) orow[js] = from_f32<T>(scale(xs, r, w, js, offset));
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int64_t rows, int d,
           float eps, bool offset, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = (d + kVec - 1) / kVec;
  int threads = (vecs + kVecPerThread - 1) / kVecPerThread;
  threads = (threads + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out),
      d, eps, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, d), contiguous, 16-byte aligned, of one dtype
// (x_dtype: 0 float32, 1 bfloat16, 2 float16); w (d,) contiguous
// (w_dtype: 0 float32, 1 bfloat16).  1 <= rows < 2^31, 1 <= d <= 16384.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int64_t rows, int64_t d, float eps, int offset,
                              int x_dtype, int w_dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || rows > INT32_MAX || d < 1 || d > kMaxD ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dd = static_cast<int>(d);
  const bool off = offset != 0;
  if (w_dtype == 0) {
    if (x_dtype == 0) return launch<float, float>(x, w, out, rows, dd, eps, off, s);
    if (x_dtype == 1)
      return launch<__nv_bfloat16, float>(x, w, out, rows, dd, eps, off, s);
    if (x_dtype == 2) return launch<__half, float>(x, w, out, rows, dd, eps, off, s);
  } else if (w_dtype == 1) {
    if (x_dtype == 0)
      return launch<float, __nv_bfloat16>(x, w, out, rows, dd, eps, off, s);
    if (x_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, dd, eps,
                                                  off, s);
    if (x_dtype == 2)
      return launch<__half, __nv_bfloat16>(x, w, out, rows, dd, eps, off, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
