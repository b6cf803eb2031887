// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of ray_lightning_tpu/ops/attention.py
// (_fwd_kernel, pallas_call at line 385 in _flash_fwd): softmax(Q K^T * scale) V
// with an fp32 online softmax, causal or full, optional sliding window
// (position i attends [i - W + 1, i]), GQA (query head h reads KV head
// h // group). Outputs O in q's type and the per-row logsumexp [B, Hq, S] fp32.
//
// Bound on the H100: at the prefill shape (S = 512, hd 128, bf16) the work is
// ~2 GFLOP against ~10 MB of inputs and outputs, so on the tensor cores the
// bytes would bound it (~3 us). This first kernel does its products with
// fp32 FMAs out of shared memory (no mma/wgmma yet), so in practice it is
// bound by shared-memory bandwidth and the fp32 FMA rate: the tile loads and
// the two inner products are the cost, and moving them to wgmma with TMA
// loads is the next step.
//
// Design: one block of 256 threads per (batch, query head, 64-row query
// tile). The TPU's sequential KV grid axis and its scratch carry become a loop
// inside the block over 64-key tiles; the Q tile stays in shared memory for
// the whole loop. Each query row belongs to 4 neighbouring lanes of one warp,
// which own 16 of the tile's scores and 32 of the row's output columns, so
// the row max and row sum take two shuffles and never leave the warp.
//  - causal: the loop ends at the tile holding the q tile's last row (the
//    TPU's _block_active skip, as a loop bound);
//  - window: the loop starts at the tile holding q0 - (W - 1), and masked
//    scores take the finite -1e30 of the TPU kernel (a row whose band misses a
//    visited tile gets a uniform contribution that the rescale of its first
//    real tile annihilates); pure causal masks with -inf;
//  - no lane padding of hd to 128 and no block-divisibility rule: the ragged
//    last q and k tiles are masked in the kernel (key columns past S are -inf,
//    query rows past S are computed and not stored);
//  - the probabilities are rounded to the input type before the P V product
//    (the TPU kernel's p.astype(v.dtype)); the row sum uses the unrounded
//    values, as there;
//  - l == 0 is guarded before the division and the log.
#include <cmath>
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

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 4 lanes per query row
constexpr int kDMax = 128;    // largest head dim
constexpr int kCols = kDMax / 4;  // output columns per lane
constexpr int kScores = kBK / 4;  // scores per lane per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int seq, int hd,
                 float scale, int causal, int window) {
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const long q_off = static_cast<long>(bh) * seq * hd;
  const long kv_off = (static_cast<long>(b) * hkv + hk) * seq * hd;
  const int ld = hd + 1;

  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][hd + 1]
  float* ks = qs + kBQ * ld;     // [kBK][hd + 1]
  float* vs = ks + kBK * ld;     // [kBK][hd + 1]
  float* ps = vs + kBK * ld;     // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;        // query row within the tile
  const int lane4 = tid & 3;     // which quarter of the row this lane holds
  const int row = q0 + r;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int rr = i / hd;
    const int c = i - rr * hd;
    const int gq = q0 + rr;
    qs[rr * ld + c] = gq < seq ? to_f<T>(q[q_off + static_cast<long>(gq) * hd + c]) : 0.f;
  }

  int lo = 0;
  int hi = (seq + kBK - 1) / kBK;
  float neg = -INFINITY;
  if (causal) {
    const int last_row = min(q0 + kBQ - 1, seq - 1);
    hi = last_row / kBK + 1;
    if (window > 0) {
      lo = max(q0 - (window - 1), 0) / kBK;
      neg = -1e30f;
    }
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int rr = i / hd;
      const int c = i - rr * hd;
      const int gk = k0 + rr;
      const bool in = gk < seq;
      const long src = kv_off + static_cast<long>(gk) * hd + c;
      ks[rr * ld + c] = in ? to_f<T>(k[src]) : 0.f;
      vs[rr * ld + c] = in ? to_f<T>(v[src]) : 0.f;
    }
    __syncthreads();

    float s[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int c = lane4 + 4 * j;
      const float* qr = qs + r * ld;
      const float* kr = ks + c * ld;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      dot *= scale;
      const int col = k0 + c;
      if (col >= seq) {
        dot = -INFINITY;
      } else if (causal) {
        bool keep = row >= col;
        if (window > 0) keep = keep && (row - col) < window;
        if (!keep) dot = neg;
      }
      s[j] = dot;
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kScores; ++j) mx = fmaxf(mx, s[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no finite score yet keeps exp() nan-free
    const float mref = mx == -INFINITY ? 0.f : mx;
    const float alpha = expf(m - mref);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const float p = expf(s[j] - mref);
      psum += p;
      ps[r * (kBK + 1) + lane4 + 4 * j] = to_f<T>(from_f<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = mx;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's probabilities are written by its own 4 lanes
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[r * (kBK + 1) + c];
      const float* vr = vs + c * ld;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane4 + 4 * i;
        if (d < hd) acc[i] += p * vr[d];
      }
    }
  }

  if (row < seq) {
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    T* orow = o + q_off + static_cast<long>(row) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) orow[d] = from_f<T>(acc[i] * inv);
    }
    if (lane4 == 0) lse[static_cast<long>(bh) * seq + row] = m + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int hq, int hkv, int seq, int hd, float scale,
           int causal, int window, cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * (kBK + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  flash_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, seq, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Hq, S, hd]; k, v: [B, Hkv, S, hd]; o: [B, Hq, S, hd], all of
// `dtype` (0 = float32, 1 = bfloat16); lse: [B, Hq, S] fp32. hd <= 128.
// window <= 0 means no window (only read when causal).
extern "C" int rlt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int hq, int hkv,
                             int seq, int hd, float scale, int causal,
                             int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0) return static_cast<int>(cudaGetLastError());
  if (hd > kDMax || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(q, k, v, o, lse, batch, hq, hkv, seq, hd, scale,
                         causal, window, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, lse, batch, hq, hkv, seq, hd,
                                 scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
