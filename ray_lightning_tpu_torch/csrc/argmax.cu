// Blockwise argmax over the vocabulary, greedy and noisy, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of ray_lightning_tpu/ops/paged_attention.py
// (_argmax_kernel / _noisy_argmax_kernel, pallas_call at line 272 in
// _blockwise_argmax): out[b] = argmax_v (x[b, v] + noise[b, v]), the noise
// operand being optional. Ties keep the FIRST maximum, exactly as
// torch.argmax and jnp.argmax do.
//
// Bound on the H100: bytes. Each logit (and noise value) is read once, one
// compare per element; [8, 128256] fp32 is 4.1 MB, about 1.2 us at 3.35 TB/s.
//
// Design: one block of 1024 threads per row. The TPU walked the vocabulary in
// sequential grid steps carrying (max, index) in SMEM with a strict `>`; here
// the steps run in parallel, so each thread keeps its own (max, index) over a
// strided slice (strict `>` keeps its first maximum, since its indices rise),
// and the pairs are merged with a rule that is order-free: the larger value
// wins, and on equal values the lower index wins. That merge is associative
// and commutative, so the shuffle tree gives the first global maximum
// whatever the order of the reduction.
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ x, const float* __restrict__ noise,
              int* __restrict__ out, int vocab) {
  const long row = blockIdx.x;
  const float* xr = x + row * vocab;
  const float* nr = noise != nullptr ? noise + row * vocab : nullptr;

  float best = -INFINITY;
  int idx = INT_MAX;  // no element seen yet: loses every merge
  for (int i = threadIdx.x; i < vocab; i += kThreads) {
    float v = xr[i];
    if (nr != nullptr) v = v + nr[i];
    if (idx == INT_MAX || v > best) {
      best = v;
      idx = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    merge(best, idx, ov, oi);
  }
  __shared__ float vals[kThreads / 32];
  __shared__ int idxs[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    vals[warp] = best;
    idxs[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = vals[lane];
    idx = idxs[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      merge(best, idx, ov, oi);
    }
    if (lane == 0) out[row] = idx;
  }
}

}  // namespace

// x, noise: [rows, vocab] fp32 (noise may be null); out: [rows] int32.
extern "C" int rlt_argmax(const void* x, const void* noise, void* out,
                          int rows, int vocab, void* stream) {
  if (rows > 0) {
    argmax_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(noise),
        static_cast<int*>(out), vocab);
  }
  return static_cast<int>(cudaGetLastError());
}
