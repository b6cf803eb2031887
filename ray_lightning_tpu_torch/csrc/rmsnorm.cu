// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of ray_lightning_tpu/ops/rmsnorm.py
// (_rmsnorm_pallas, pallas_call at line 37): y = x * rsqrt(mean(x^2) + eps) * w,
// accumulated in fp32 and cast back to x's type once.
//
// Bound on the H100: bytes. The kernel reads each row once and writes it
// once (2 * rows * D * sizeof(T) plus the weight); it does ~4 flops per
// element, far below the 295 flops/byte the card needs to be compute bound.
// At the decode shape [8, 4096] bf16 the whole call moves 130 KB, which the
// card streams in well under a microsecond: there the launch (~2-4 us) is the
// bound, not the bytes, and only fusing RMSNorm into its neighbours (or a CUDA
// graph over the decode step) removes it.
//
// Design: one block of 256 threads per row. Pass one sums x^2 in fp32 in
// registers and reduces with warp shuffles, then across warps through 32
// floats of shared memory. Pass two re-reads the row, which is still in L1
// (a 4096-wide bf16 row is 8 KB), and writes x * scale * w in the row's type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int dim, float eps) {
  const long row = blockIdx.x;
  const T* xr = x + row * dim;
  T* orow = out + row * dim;

  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += kThreads) {
    const float v = to_f<T>(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float scale_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scale_s = rsqrtf(v / static_cast<float>(dim) + eps);
  }
  __syncthreads();
  const float scale = scale_s;
  for (int i = threadIdx.x; i < dim; i += kThreads) {
    orow[i] = from_f<T>(to_f<T>(xr[i]) * scale * to_f<T>(w[i]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int rlt_rmsnorm_fwd(const void* x, const void* w, void* out,
                               int rows, int dim, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == 0) {
      rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), dim, eps);
    } else if (dtype == 1) {
      rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(out), dim, eps);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
