// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV kernel.
//
// Replaces the two Pallas kernels of ray_lightning_tpu/ops/attention.py that
// _flash_bwd launches: _bwd_dq_kernel (pallas_call at line 427) and
// _bwd_dkv_kernel (pallas_call at line 451). Both recompute the scores from Q,
// K and the forward's per-row logsumexp instead of storing the S x S matrix:
//   S  = Q K^T * scale, masked          P  = exp(S - lse)
//   dP = dO V^T                         dS = P * (dP - delta) * scale
//   dQ = dS K      dK = dS^T Q      dV = P^T dO
// with delta = rowsum(dO * O) computed by the caller (the TPU code computes it
// outside its kernels too). Causal or full attention, an optional sliding
// window (position i attends [i - W + 1, i]), GQA (query head h reads KV head
// h / group).
//
// Bound on the H100: at the training shape (q [8,16,2048,128], kv
// [8,8,2048,128], bf16, causal) dQ does three products and dK/dV four over
// ~2.1 M causal (row, key) pairs per head, ~0.2 and ~0.28 TFLOP, against
// ~270 MB of inputs and outputs each: on the tensor cores the operations
// would bound them (~0.2-0.3 ms). These first kernels do their products with
// fp32 FMAs out of shared memory, one output tile per block, so in practice
// the FMA rate and shared-memory bandwidth bound them; wgmma tiles with TMA
// loads are the later step.
//
// Design. The TPU walks a sequential grid axis and carries its accumulator in
// VMEM scratch across the steps; here that axis is a loop inside one block,
// and the accumulators live in registers.
//  - dQ: one block of 256 threads per (batch, query head, 64-row query tile).
//    Each query row belongs to 4 neighbouring lanes of one warp; each lane
//    computes 16 of a key tile's scores and owns 32 of the row's dQ columns.
//    The loop over 64-key tiles stops at the causal bound and, under a
//    window, starts at the tile that holds the band's lower edge of the
//    tile's first row (the TPU's _block_active skip, as loop bounds).
//  - dK/dV: one block of 256 threads per (batch, KV head, 64-key tile). Each
//    key row belongs to 4 lanes. The loop walks every (group member, query
//    tile) pair, query head = kv_head * group + member as in
//    _q_index_map_for_dkv, so the GQA sum happens in the fp32 accumulators
//    and dK, dV come out [B, Hkv, S, hd] directly. Query tiles fully above
//    the diagonal, or below the band, are skipped by the loop bound. No
//    atomics: every output element has one writer, so the result is
//    deterministic.
//  - Roundings as on the TPU: dS is rounded to the input type before dS K
//    (attention.py:206) and before dS^T Q (:266); P is rounded to dO's type
//    before P^T dO (:260). Accumulation is fp32; dQ, dK, dV are stored in the
//    input type.
//  - Masks as _mask_scores: pure causal masks with -inf, a window with the
//    finite -1e30 (once lse is known both give P = 0). Key columns past S are
//    -inf; query rows past S are never read from lse/delta (their P is 0 in
//    dK/dV) and never stored (dQ). No lane padding of hd and no
//    block-divisibility rule: ragged last tiles are masked here.
//  - Shared memory is ~145 KB (dQ) and ~162 KB (dK/dV) per block, over the
//    48 KB default, so each launch raises the kernel's dynamic limit first.
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
// round an fp32 value to T and back (the TPU kernels' .astype(dtype))
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 4 lanes per row
constexpr int kDMax = 128;         // largest head dim
constexpr int kCols = kDMax / 4;   // output columns per lane
constexpr int kPer = kBK / 4;      // scores per lane per tile (kBQ == kBK)

// rows [r0, r0 + 64) of a [seq, hd] slab into shared memory [64][hd + 1] as
// fp32; rows past seq read as 0
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int seq, int hd) {
  const int ld = hd + 1;
  for (int i = threadIdx.x; i < 64 * hd; i += kThreads) {
    const int rr = i / hd;
    const int c = i - rr * hd;
    const int g = r0 + rr;
    dst[rr * ld + c] = g < seq ? to_f<T>(src[static_cast<long>(g) * hd + c]) : 0.f;
  }
}

// one scaled score after the mask (the TPU kernels' _mask_scores)
__device__ __forceinline__ float mask_score(float s, int row, int col, int seq,
                                            int causal, int window) {
  if (col >= seq) return -INFINITY;
  if (causal) {
    if (window > 0) {
      if (!(row >= col && row - col < window)) return -1e30f;
    } else if (row < col) {
      return -INFINITY;
    }
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int hq, int hkv, int seq, int hd,
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
  float* qs = smem;               // [kBQ][hd + 1]
  float* dos = qs + kBQ * ld;     // [kBQ][hd + 1]
  float* ks = dos + kBQ * ld;     // [kBK][hd + 1]
  float* vs = ks + kBK * ld;      // [kBK][hd + 1]
  float* dss = vs + kBK * ld;     // [kBQ][kBK + 1], dS rounded to T

  const int tid = threadIdx.x;
  const int r = tid >> 2;         // query row within the tile
  const int lane4 = tid & 3;      // which quarter of the row this lane holds
  const int row = q0 + r;
  const bool row_ok = row < seq;

  load_tile<T>(qs, q + q_off, q0, seq, hd);
  load_tile<T>(dos, dout + q_off, q0, seq, hd);
  const float lse_r = row_ok ? lse[static_cast<long>(bh) * seq + row] : 0.f;
  const float delta_r = row_ok ? delta[static_cast<long>(bh) * seq + row] : 0.f;

  int lo = 0;
  int hi = (seq + kBK - 1) / kBK;
  if (causal) {
    hi = min(q0 + kBQ - 1, seq - 1) / kBK + 1;
    if (window > 0) lo = max(q0 - (window - 1), 0) / kBK;
  }

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<T>(ks, k + kv_off, k0, seq, hd);
    load_tile<T>(vs, v + kv_off, k0, seq, hd);
    __syncthreads();

    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) { s[j] = 0.f; dp[j] = 0.f; }
    const float* qr = qs + r * ld;
    const float* dor = dos + r * ld;
    for (int d = 0; d < hd; ++d) {
      const float qd = qr[d];
      const float dod = dor[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = lane4 + 4 * j;
        s[j] += qd * ks[c * ld + d];
        dp[j] += dod * vs[c * ld + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane4 + 4 * j;
      const float sc = mask_score(s[j] * scale, row, k0 + c, seq, causal, window);
      const float p = expf(sc - lse_r);
      dss[r * (kBK + 1) + c] = round_to<T>(p * (dp[j] - delta_r) * scale);
    }
    __syncwarp();  // the row's dS is written by its own 4 lanes
    for (int c = 0; c < kBK; ++c) {
      const float dsv = dss[r * (kBK + 1) + c];
      const float* kr = ks + c * ld;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = lane4 + 4 * i;
        if (d < hd) acc[i] += dsv * kr[d];
      }
    }
  }

  if (row_ok) {
    T* out = dq + q_off + static_cast<long>(row) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) out[d] = from_f<T>(acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                     int seq, int hd, float scale, int causal, int window) {
  const int k0 = blockIdx.x * kBK;
  const int bhk = blockIdx.y;
  const int b = bhk / hkv;
  const int hk = bhk - b * hkv;
  const int group = hq / hkv;
  const long kv_off = static_cast<long>(bhk) * seq * hd;
  const int ld = hd + 1;

  extern __shared__ float smem[];
  float* ks = smem;                // [kBK][hd + 1]
  float* vs = ks + kBK * ld;       // [kBK][hd + 1]
  float* qs = vs + kBK * ld;       // [kBQ][hd + 1]
  float* dos = qs + kBQ * ld;      // [kBQ][hd + 1]
  float* ps = dos + kBQ * ld;      // [kBK][kBQ + 1], P rounded to T
  float* dss = ps + kBK * (kBQ + 1);   // [kBK][kBQ + 1], dS rounded to T
  float* lses = dss + kBK * (kBQ + 1); // [kBQ]
  float* deltas = lses + kBQ;          // [kBQ]

  const int tid = threadIdx.x;
  const int c = tid >> 2;          // key row within the tile
  const int lane4 = tid & 3;
  const int col = k0 + c;

  load_tile<T>(ks, k + kv_off, k0, seq, hd);
  load_tile<T>(vs, v + kv_off, k0, seq, hd);

  // query tiles that can see this key tile
  int qlo = 0;
  int qhi = (seq + kBQ - 1) / kBQ;
  if (causal) {
    qlo = k0 / kBQ;  // rows below k0 are above the diagonal for every key here
    if (window > 0) {
      const int k_last = min(k0 + kBK - 1, seq - 1);
      qhi = min(k_last + window - 1, seq - 1) / kBQ + 1;
    }
  }

  float dka[kCols], dva[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) { dka[i] = 0.f; dva[i] = 0.f; }

  for (int g = 0; g < group; ++g) {
    const long bh = static_cast<long>(b) * hq + hk * group + g;
    const long q_off = bh * seq * hd;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<T>(qs, q + q_off, q0, seq, hd);
      load_tile<T>(dos, dout + q_off, q0, seq, hd);
      if (tid < kBQ) {
        const int gr = q0 + tid;
        lses[tid] = gr < seq ? lse[bh * seq + gr] : 0.f;
        deltas[tid] = gr < seq ? delta[bh * seq + gr] : 0.f;
      }
      __syncthreads();

      float s[kPer], dp[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) { s[j] = 0.f; dp[j] = 0.f; }
      const float* kr = ks + c * ld;
      const float* vr = vs + c * ld;
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d];
        const float vd = vr[d];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int rr = lane4 + 4 * j;
          s[j] += qs[rr * ld + d] * kd;
          dp[j] += dos[rr * ld + d] * vd;
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int rr = lane4 + 4 * j;
        const int row = q0 + rr;
        float p = 0.f;
        float ds = 0.f;
        if (row < seq) {
          const float sc = mask_score(s[j] * scale, row, col, seq, causal, window);
          p = expf(sc - lses[rr]);
          ds = p * (dp[j] - deltas[rr]) * scale;
        }
        ps[c * (kBQ + 1) + rr] = round_to<T>(p);
        dss[c * (kBQ + 1) + rr] = round_to<T>(ds);
      }
      __syncwarp();  // the key row's P and dS are written by its own 4 lanes
      for (int rr = 0; rr < kBQ; ++rr) {
        const float pv = ps[c * (kBQ + 1) + rr];
        const float dsv = dss[c * (kBQ + 1) + rr];
        const float* dor = dos + rr * ld;
        const float* qr = qs + rr * ld;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int d = lane4 + 4 * i;
          if (d < hd) {
            dva[i] += pv * dor[d];
            dka[i] += dsv * qr[d];
          }
        }
      }
    }
  }

  if (col < seq) {
    T* dko = dk + kv_off + static_cast<long>(col) * hd;
    T* dvo = dv + kv_off + static_cast<long>(col) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) {
        dko[d] = from_f<T>(dka[i]);
        dvo[d] = from_f<T>(dva[i]);
      }
    }
  }
}

template <typename Kernel>
int raise_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch, int hq,
              int hkv, int seq, int hd, float scale, int causal, int window,
              cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) * (2 * kBQ * ld + 2 * kBK * ld + kBQ * (kBK + 1));
  const int err = raise_smem_limit(flash_bwd_dq_kernel<T>, smem);
  if (err != 0) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), hq, hkv, seq, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int batch,
               int hq, int hkv, int seq, int hd, float scale, int causal,
               int window, cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) *
      (2 * kBK * ld + 2 * kBQ * ld + 2 * kBK * (kBQ + 1) + 2 * kBQ);
  const int err = raise_smem_limit(flash_bwd_dkv_kernel<T>, smem);
  if (err != 0) return err;
  const dim3 grid((seq + kBK - 1) / kBK, batch * hkv);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, seq, hd, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int hq, int hkv, int hd) {
  return hd <= 0 || hd > kDMax || hkv <= 0 || hq % hkv != 0;
}

}  // namespace

// q, dout, dq: [B, Hq, S, hd]; k, v: [B, Hkv, S, hd], all of `dtype`
// (0 = float32, 1 = bfloat16); lse, delta: [B, Hq, S] fp32. hd <= 128.
// window <= 0 means no window (only read when causal).
extern "C" int rlt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int batch, int hq,
                                int hkv, int seq, int hd, float scale,
                                int causal, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(hq, hkv, hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, seq,
                            hd, scale, causal, window, s);
  }
  if (dtype == 1) {
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, batch, hq,
                                    hkv, seq, hd, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// as rlt_flash_bwd_dq; dk, dv: [B, Hkv, S, hd] of `dtype`, the GQA group's
// contributions summed
extern "C" int rlt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int batch, int hq, int hkv, int seq, int hd,
                                 float scale, int causal, int window, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0) return static_cast<int>(cudaGetLastError());
  if (bad_shape(hq, hkv, hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv,
                             seq, hd, scale, causal, window, s);
  }
  if (dtype == 1) {
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, batch,
                                     hq, hkv, seq, hd, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
