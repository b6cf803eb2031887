// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of ray_lightning_tpu/ops/rmsnorm.py
// (_rmsnorm_pallas, pallas_call at line 37): y = x * rsqrt(mean(x^2) + eps) * w,
// accumulated in fp32 (x * scale * w in that order) and cast back to x's type
// once.
//
// Bound on the H100: bytes. The kernel reads each row once and writes it
// once (2 * rows * D * sizeof(T) plus the weight); it does ~4 flops per
// element, far below the 295 flops/byte the card needs to be compute bound.
// At the training shape [16384, 2048] bf16 that is 134 MB, 0.0401 ms at
// 3.35 TB/s; at the prefill shape [512, 4096] 8.4 MB, 0.0025 ms. At the
// decode shape [8, 4096] the whole call moves 139 KB (0.04 us of bytes): a
// launch and one or two DRAM round trips are the floor there, and only
// fusing RMSNorm into its neighbours (or a CUDA graph over the decode step)
// removes it.
//
// Design (the TPU kernel took 256 rows per grid step; here a row is a warp's):
// - One warp per row (2 or 4 warps per row above 4096 bf16 / 2048 fp32
//   values), 4 warps per block, so a block takes 4 rows (1 above 4096); a
//   decode step's few rows take a block each, 4 warps a row, spreading
//   them over as many SMs.
// - x is read from device memory once, in 16-byte loads: each lane issues
//   all of its row's loads (8 at dim 2048 in bf16, 16 at 4096) before it
//   uses any, and keeps them in registers for the scaling pass.
// - The sum of squares is reduced by warp shuffles alone; only a row split
//   over several warps adds one barrier and a few floats of shared memory.
// - w is staged once per block into shared memory by 16-byte cp.async,
//   overlapped with the first row's loads, and read from there by every row.
// - 16-byte stores.
// - A scalar path (a warp per row, two passes over x, the second from L1)
//   for dims that are no multiple of 8 (bf16) or 4 (fp32), dims past the
//   vector path's 16384 bf16 / 8192 fp32 values, and pointers that are not
//   16-byte aligned, decided per launch.
// - The reduction order is fixed (each lane in order, then a fixed shuffle
//   tree, then the warps of a row in order), so results are bitwise
//   deterministic.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 16;   // 16-byte vectors a lane holds
constexpr int kFewRows = 64;   // up to here a row gets a block of its own

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a 16-byte vector as floats and back (bf16: 8 values, fp32: 4)
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// kWPR warps per row, each lane holding up to kNV 16-byte vectors of it.
// kStageW: w is staged once per block in dynamic shared memory (nvec =
// dim / Vec<T>::kN vectors) and read from there by every row; otherwise
// (a block per row, few rows) each lane loads its own vectors of w beside
// those of x.
template <typename T, int kNV, int kWPR, bool kStageW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int rows, int dim, float eps) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kRowsPerBlock = kWarps / kWPR;
  extern __shared__ __align__(16) uint4 w_s[];
  __shared__ float part[2][kWarps];
  const int nvec = dim / kN;
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  if (kStageW) {
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(w_s + i)), "l"(w4 + i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = warp / kWPR;                 // the row of the block's step
  const int sub = warp % kWPR;                 // this warp's part of it
  const int glane = sub * 32 + lane;
  bool w_ready = false;
  int it = 0;
  // the loop's trip count is the same for every warp of the block, so the
  // barriers inside it are reached by all
  for (long base = static_cast<long>(blockIdx.x) * kRowsPerBlock; base < rows;
       base += static_cast<long>(gridDim.x) * kRowsPerBlock, ++it) {
    const long row = base + grp;
    const bool valid = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (valid ? row : 0) * dim);
    uint4 v[kNV];
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int j = i * kWPR * 32 + glane;
      v[i] = (valid && j < nvec) ? xr[j] : make_uint4(0, 0, 0, 0);
    }
    uint4 wv[kStageW ? 1 : kNV];
    if (!kStageW) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        const int j = i * kWPR * 32 + glane;
        wv[kStageW ? 0 : i] = (valid && j < nvec) ? w4[j] : make_uint4(0, 0, 0, 0);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      float f[kN];
      Vec<T>::load(v[i], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = warp_sum(ss);
    if (kWPR > 1) {
      if (lane == 0) part[it & 1][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int s = 0; s < kWPR; ++s) ss += part[it & 1][grp * kWPR + s];
    }
    if (kStageW && !w_ready) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      w_ready = true;
    }
    const float scale = rsqrtf(ss / static_cast<float>(dim) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + (valid ? row : 0) * dim);
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int j = i * kWPR * 32 + glane;
      if (valid && j < nvec) {
        float f[kN], g[kN];
        Vec<T>::load(v[i], f);
        Vec<T>::load(kStageW ? w_s[j] : wv[kStageW ? 0 : i], g);
#pragma unroll
        for (int e = 0; e < kN; ++e) f[e] = f[e] * scale * g[e];
        orow[j] = Vec<T>::store(f);
      }
    }
  }
  if (kStageW && !w_ready) asm volatile("cp.async.wait_group 0;\n" ::);
}

// any dim, any alignment: a warp per row, two passes over x
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      int rows, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  for (long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); row < rows;
       row += static_cast<long>(gridDim.x) * kWarps) {
    const T* xr = x + row * dim;
    float ss = 0.f;
    for (int i = lane; i < dim; i += 32) {
      const float v = to_f<T>(xr[i]);
      ss = fmaf(v, v, ss);
    }
    const float scale = rsqrtf(warp_sum(ss) / static_cast<float>(dim) + eps);
    T* orow = out + row * dim;
    for (int i = lane; i < dim; i += 32) orow[i] = from_f<T>(to_f<T>(xr[i]) * scale * to_f<T>(w[i]));
  }
}

// a block per step of rows (the grid-stride loop only takes over past 2^20
// blocks): measured faster than capping the grid at a few blocks per SM,
// whose last wave leaves SMs idle
int grid_for(long blocks_wanted) {
  return static_cast<int>(blocks_wanted < (1 << 20) ? blocks_wanted : (1 << 20));
}

template <typename T, int kNV, int kWPR, bool kStageW>
void launch_vec(const void* x, const void* w, void* out, int rows, int dim, float eps,
                cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarps / kWPR;
  const int grid = grid_for((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = kStageW ? static_cast<size_t>(dim) * sizeof(T) : 0;
  rmsnorm_vec_kernel<T, kNV, kWPR, kStageW><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, dim, eps);
}

template <typename T, int kWPR, bool kStageW>
void dispatch_nv(int per_lane, const void* x, const void* w, void* out, int rows, int dim,
                 float eps, cudaStream_t s) {
  if (per_lane <= 1) launch_vec<T, 1, kWPR, kStageW>(x, w, out, rows, dim, eps, s);
  else if (per_lane <= 2) launch_vec<T, 2, kWPR, kStageW>(x, w, out, rows, dim, eps, s);
  else if (per_lane <= 4) launch_vec<T, 4, kWPR, kStageW>(x, w, out, rows, dim, eps, s);
  else if (per_lane <= 8) launch_vec<T, 8, kWPR, kStageW>(x, w, out, rows, dim, eps, s);
  else launch_vec<T, 16, kWPR, kStageW>(x, w, out, rows, dim, eps, s);
}

template <typename T>
void run(const void* x, const void* w, void* out, int rows, int dim, float eps,
         cudaStream_t s) {
  constexpr int kN = Vec<T>::kN;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int nvec = dim / kN;
  if (aligned && dim % kN == 0 && nvec <= 4 * 32 * kMaxVecs) {
    if (rows <= kFewRows && nvec >= 4 * 32) {
      // few rows (a decode step's): a block of 4 warps per row, so the
      // rows spread over as many SMs and each lane holds a quarter as much
      dispatch_nv<T, 4, false>((nvec + 127) / 128, x, w, out, rows, dim, eps, s);
      return;
    }
    // the fewest warps per row that hold it in at most kMaxVecs vectors a lane
    const int wpr = nvec <= 32 * kMaxVecs ? 1 : nvec <= 2 * 32 * kMaxVecs ? 2 : 4;
    const int per_lane = (nvec + wpr * 32 - 1) / (wpr * 32);
    if (wpr == 1) dispatch_nv<T, 1, true>(per_lane, x, w, out, rows, dim, eps, s);
    else if (wpr == 2) dispatch_nv<T, 2, true>(per_lane, x, w, out, rows, dim, eps, s);
    else dispatch_nv<T, 4, true>(per_lane, x, w, out, rows, dim, eps, s);
  } else {
    const int grid = grid_for((rows + kWarps - 1) / kWarps);
    rmsnorm_scalar_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), rows, dim, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int rlt_rmsnorm_fwd(const void* x, const void* w, void* out,
                               int rows, int dim, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && dim > 0) {
    if (dtype == 0) {
      run<float>(x, w, out, rows, dim, eps, s);
    } else if (dtype == 1) {
      run<__nv_bfloat16>(x, w, out, rows, dim, eps, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
