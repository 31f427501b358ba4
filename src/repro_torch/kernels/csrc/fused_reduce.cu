// Elementwise a + b in float32, cast to the output dtype: the local combine
// of a reduce-scatter step, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/fused_reduce.py:25 (_kernel, launched by
// fused_reduce_flat :34), the Pallas TPU kernel of the reference package:
//
//   out[i] = cast_out(float(a[i]) + float(b[i]))
//
// a and b of one dtype, out of any, each bfloat16, float16 or float32, over
// n elements of flat contiguous buffers.  One float32 add and one round to
// nearest even per element: bitwise the plain torch version
// (a.float() + b.float()).to(out_dtype).
//
// Design.  The TPU kernel walks (8, 1024) tiles of the padded buffer.
// Here a grid-stride loop walks 16-byte vectors of the inputs (8 bf16 or
// f16 values, 4 float32), four vectors per thread in flight per turn, and
// stores each vector's results at once (8, 16 or 32 bytes); the elements
// after the last whole vector form a masked scalar tail.  Buffers that are
// not aligned to their vector size take the scalar loop throughout.  No
// padding copy is made.  The grid is sized to the work: blocks of 256
// threads, 4 vectors a thread, so the loop turns once below 2^31 blocks.
//
// What bounds it on an H100.  It reads a and b and writes out once, one
// add an element: bytes bound it (2^20 bf16 elements move 6.3 MB, 1.9 us
// at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kMaxBlocks = 2147483647;  // grid.x

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

// N values of T in one aligned load or store.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename I, typename O>
__global__ void __launch_bounds__(kThreads)
    fused_reduce_kernel(const I* __restrict__ a, const I* __restrict__ b,
                        O* __restrict__ out, int64_t n, bool vec) {
  constexpr int kVec = 16 / sizeof(I);
  using In = Pack<I, kVec>;
  using Out = Pack<O, kVec>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = vec ? n / kVec : 0;
  const In* av = reinterpret_cast<const In*>(a);
  const In* bv = reinterpret_cast<const In*>(b);
  Out* ov = reinterpret_cast<Out*>(out);

  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    In x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = av[i + u * stride];
      y[u] = bv[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Out o;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        o.v[e] = from_f32<O>(to_f32(x[u].v[e]) + to_f32(y[u].v[e]));
      ov[i + u * stride] = o;
    }
  }
  for (; i < n_vec; i += stride) {
    const In x = av[i], y = bv[i];
    Out o;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      o.v[e] = from_f32<O>(to_f32(x.v[e]) + to_f32(y.v[e]));
    ov[i] = o;
  }
  for (int64_t j = n_vec * kVec + tid; j < n; j += stride)
    out[j] = from_f32<O>(to_f32(a[j]) + to_f32(b[j]));
}

template <typename I, typename O>
int launch(const void* a, const void* b, void* out, int64_t n,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(I);
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % (sizeof(O) * kVec)) == 0;
  const int64_t units = vec ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  fused_reduce_kernel<I, O><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const I*>(a), static_cast<const I*>(b), static_cast<O*>(out),
      n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_out(const void* a, const void* b, void* out, int64_t n,
               int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return launch<I, float>(a, b, out, n, stream);
  if (out_dtype == 1) return launch<I, __nv_bfloat16>(a, b, out, n, stream);
  if (out_dtype == 2) return launch<I, __half>(a, b, out, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a and b (n,) of in_dtype, out (n,) of out_dtype, contiguous (dtype codes:
// 0 float32, 1 bfloat16, 2 float16); n >= 1.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int fused_reduce_launch(const void* a, const void* b, void* out,
                                   int64_t n, int in_dtype, int out_dtype,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return launch_out<float>(a, b, out, n, out_dtype, s);
  if (in_dtype == 1) return launch_out<__nv_bfloat16>(a, b, out, n, out_dtype, s);
  if (in_dtype == 2) return launch_out<__half>(a, b, out, n, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
