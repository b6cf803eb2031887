// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV kernel.
//
// Replaces the two Pallas kernels of ray_lightning_tpu/ops/attention.py that
// _flash_bwd launches: _bwd_dq_kernel (lines 172-213, pallas_call at 427) and
// _bwd_dkv_kernel (lines 223-274, pallas_call at 451). Both recompute the
// scores from Q, K and the forward's per-row logsumexp instead of storing the
// S x S matrix:
//   S  = Q K^T * scale, masked          P  = exp(S - lse)
//   dP = dO V^T                         dS = P * (dP - delta) * scale
//   dQ = dS K      dK = dS^T Q      dV = P^T dO
// with delta = rowsum(dO * O) computed by the caller (the TPU code computes it
// outside its kernels too). Causal or full attention, an optional sliding
// window (position i attends [i - W + 1, i]), GQA (query head h reads KV head
// h / group), any S (no block-divisibility rule) and any head dim up to 128.
//
// Bound on the H100: operations. Per causal (row, key) pair the dQ kernel
// does three products of 2 * 128 FLOP (S, dP, dS K) and the dK/dV kernel four
// (S^T, dP^T, P^T dO, dS^T Q). At the training shape (q [8,16,2048,128], kv
// [8,8,2048,128], bf16, causal: 2.7e8 pairs) that is ~0.21 and ~0.28 TFLOP,
// 0.21 and 0.28 ms at the 989 TFLOP/s of the bf16 tensor cores, against
// ~0.1 ms to move the ~270 MB of inputs and outputs.
//
// bf16 (the training path): every product runs on the tensor cores as
// wgmma.mma_async (m64nNk16, bf16 in, fp32 accumulators in registers):
//  - Tiles stay bf16 in shared memory, in 64-column panels of 128-byte rows
//    whose 16-byte chunks are XOR-swizzled by row (chunk ^ (row & 7)): the
//    layout of wgmma's 128-byte swizzle, so every operand is read straight
//    from the tile through a descriptor. They arrive by 16-byte cp.async
//    into a two-stage ring: the next K/V tile (dQ) or the next
//    Q/dO/lse/delta tile (dK/dV) lands while the current one computes. Head
//    dims below the panel width are zero-filled, which is exact; rows past S
//    are zero-filled too.
//  - A block is one warpgroup (four warps) and owns 64 output rows (query
//    rows in dQ, key rows in dK/dV); each warp holds 16 of them and the same
//    16 rows of S and dP (S^T and dP^T in dK/dV). So the fp32 accumulators
//    of S and dP become P and dS in registers (mask, exp2(s * scale * log2e
//    - lse * log2e), p (dp - delta) scale), are rounded to bf16 and packed
//    straight into the register A operand of the next product: no
//    shared-memory round trip. The rounding is the TPU kernels': dS before
//    dS K and dS^T Q (attention.py:206, :266), P before P^T dO (:260), while
//    dS is formed from the unrounded fp32 P.
//  - One copy of each tile serves both ways: K (in dQ) and Q, dO (in dK/dV)
//    are the K-major B of S = Q K^T (S^T = K Q^T, dP^T = V dO^T) and, with
//    wgmma's transpose flag, the MN-major B of dS K (P^T dO, dS^T Q).
//  - dQ: one block per (batch, query head, 64-row query tile), walking the
//    64-key tiles from the window's lower edge to the causal bound (the TPU's
//    _block_active skip, as loop bounds). dK/dV: one block per (batch, KV
//    head, 64-key tile), walking every (group member, 64-row query tile) pair
//    (query head = kv_head * group + member, as _q_index_map_for_dkv), so the
//    GQA sum stays in the fp32 accumulators and dK, dV come out [B, Hkv, S,
//    hd] directly. No atomics: every output element has one writer, so the
//    result is deterministic. The tile index is the slow grid dimension and
//    the heaviest tiles come first (dQ's last query tiles, dK/dV's first key
//    tiles under a causal mask), so the grid does not end on a long tail.
//  - Masks as _mask_scores: a masked pair gets P = 0, which is exactly what
//    the TPU's -inf (causal) and -1e30 (window) give once lse is known. Only a
//    warp whose 16 x 64 (dQ) or 16 x 32 (dK/dV) piece crosses the diagonal,
//    a window edge or the ragged last key tile evaluates the per-element
//    mask; interior pieces skip it. Query rows past S read lse = +inf, so
//    their P and dS are exactly 0 in dK/dV; rows past S are never stored.
//  - Shared memory: 97 KB (dQ) and 98 KB (dK/dV) per block at head dim 128,
//    so two blocks (two warpgroups) fit on an SM and one block's softmax
//    work overlaps the other's products. dK/dV computes S^T and dP^T for 32
//    query rows at a time, so its dK and dV accumulators (128 registers a
//    thread) fit beside them without spills.
//
// The tile layout, cp.async loads, descriptors and wgmma wrappers are shared
// with the forward kernel (flash_fwd.cu) in hopper_tile.cuh.
//
// fp32 (the exactness checks): the tensor cores would take fp32 operands as
// TF32 (~1e-3 relative), so fp32 inputs keep plain fp32 FMAs out of shared
// memory, one thread group per row, as exact as the plain version up to the
// order of the sums.
#include "hopper_tile.cuh"

namespace {

constexpr int kDMax = 128;         // largest head dim

// ------------------------------------------------------------------------ //
// fp32: plain FMAs (exact up to summation order)
// ------------------------------------------------------------------------ //
constexpr int kBQ = 64;            // query rows per tile
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 4 lanes per row
constexpr int kCols = kDMax / 4;   // output columns per lane
constexpr int kPer = kBK / 4;      // scores per lane per tile (kBQ == kBK)

// rows [r0, r0 + 64) of a [seq, hd] slab into shared memory [64][hd + 1];
// rows past seq read as 0
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int seq, int hd) {
  const int ld = hd + 1;
  for (int i = threadIdx.x; i < 64 * hd; i += kThreads) {
    const int rr = i / hd;
    const int c = i - rr * hd;
    const int g = r0 + rr;
    dst[rr * ld + c] = g < seq ? src[static_cast<long>(g) * hd + c] : 0.f;
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

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int hq, int hkv, int seq, int hd,
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
  float* dss = vs + kBK * ld;     // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 2;         // query row within the tile
  const int lane4 = tid & 3;      // which quarter of the row this lane holds
  const int row = q0 + r;
  const bool row_ok = row < seq;

  load_tile(qs, q + q_off, q0, seq, hd);
  load_tile(dos, dout + q_off, q0, seq, hd);
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
    load_tile(ks, k + kv_off, k0, seq, hd);
    load_tile(vs, v + kv_off, k0, seq, hd);
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
      dss[r * (kBK + 1) + c] = p * (dp[j] - delta_r) * scale;
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
    float* out = dq + q_off + static_cast<long>(row) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) out[d] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int hq,
                         int hkv, int seq, int hd, float scale, int causal,
                         int window) {
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
  float* ps = dos + kBQ * ld;      // [kBK][kBQ + 1]
  float* dss = ps + kBK * (kBQ + 1);   // [kBK][kBQ + 1]
  float* lses = dss + kBK * (kBQ + 1); // [kBQ]
  float* deltas = lses + kBQ;          // [kBQ]

  const int tid = threadIdx.x;
  const int c = tid >> 2;          // key row within the tile
  const int lane4 = tid & 3;
  const int col = k0 + c;

  load_tile(ks, k + kv_off, k0, seq, hd);
  load_tile(vs, v + kv_off, k0, seq, hd);

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
      load_tile(qs, q + q_off, q0, seq, hd);
      load_tile(dos, dout + q_off, q0, seq, hd);
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
        ps[c * (kBQ + 1) + rr] = p;
        dss[c * (kBQ + 1) + rr] = ds;
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
    float* dko = dk + kv_off + static_cast<long>(col) * hd;
    float* dvo = dv + kv_off + static_cast<long>(col) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) {
        dko[d] = dka[i];
        dvo[d] = dva[i];
      }
    }
  }
}

// ------------------------------------------------------------------------ //
// bf16: tensor cores (wgmma), cp.async ring, swizzled panels
// ------------------------------------------------------------------------ //
template <int kD>
__global__ void __launch_bounds__(kTC, 2)
flash_bwd_dq_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int hq, int hkv, int seq, int hd,
                         float scale, int causal, int window, int vec) {
  constexpr int kBytes = kTile * kD * 2;
  constexpr int kP = kD / 64;              // 64-column panels
  extern __shared__ unsigned char smem_tc[];
  unsigned char* qs = smem_1k(smem_tc);    // resident Q
  unsigned char* dos = qs + kBytes;        // resident dO
  unsigned char* ring = dos + kBytes;      // stage s: K at 2s, V at 2s + 1

  const int n_qt = (seq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kTile;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const long q_off = static_cast<long>(bh) * seq * hd;
  const long kv_off = (static_cast<long>(b) * hkv + hk) * seq * hd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;          // fragment row (and row + 8)
  const int tq = lane & 3;           // fragment column pair
  const int r_lo = q0 + warp * 16;   // this warp's first query row
  const float sl2 = scale * kLog2e;

  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + gr + 8 * i;
    lse2[i] = row < seq ? lse[static_cast<long>(bh) * seq + row] * kLog2e : 0.f;
    dlt[i] = row < seq ? delta[static_cast<long>(bh) * seq + row] : 0.f;
  }

  int lo = 0;
  int hi = (seq + kTile - 1) / kTile;
  if (causal) {
    hi = min(q0 + kTile - 1, seq - 1) / kTile + 1;
    if (window > 0) lo = max(q0 - (window - 1), 0) / kTile;
  }

  load_tile_bf16<kD>(qs, q + q_off, q0, seq, hd, vec);
  load_tile_bf16<kD>(dos, dout + q_off, q0, seq, hd, vec);
  cp_async_commit();
  load_tile_bf16<kD>(ring, k + kv_off, lo * kTile, seq, hd, vec);
  load_tile_bf16<kD>(ring + kBytes, v + kv_off, lo * kTile, seq, hd, vec);
  cp_async_commit();

  const uint32_t sq = smem_addr(qs);
  const uint32_t sdo = smem_addr(dos);
  const int n_k16 = (hd + 15) / 16;  // k16 steps over the head dim that hold data

  float acc[kP][32];                 // dQ: panel p, n8 tile j at [4j, 4j + 4)
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt + 1 < hi) {
      unsigned char* nxt = ring + (st ^ 1) * 2 * kBytes;
      load_tile_bf16<kD>(nxt, k + kv_off, (kt + 1) * kTile, seq, hd, vec);
      load_tile_bf16<kD>(nxt + kBytes, v + kv_off, (kt + 1) * kTile, seq, hd, vec);
      cp_async_commit();
      tiles_arrived<1>();
    } else {
      tiles_arrived<0>();
    }
    const uint32_t sk = smem_addr(ring + st * 2 * kBytes);
    const uint32_t sv = sk + kBytes;
    const int k0 = kt * kTile;

    // S = Q K^T and dP = dO V^T: 64 query rows x 64 keys, K-major operands
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) { s[i] = 0.f; dp[i] = 0.f; }
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      if (kk < n_k16) {
        wgmma_ss_n64(s, desc_k(sq, 0, kk), desc_k(sk, 0, kk));
        wgmma_ss_n64(dp, desc_k(sdo, 0, kk), desc_k(sv, 0, kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P and dS in registers; the mask only where this warp's piece needs it
    const bool need_mask = (causal && k0 + kTile - 1 > r_lo) ||
                           (causal && window > 0 && r_lo + 15 - k0 >= window) ||
                           k0 + kTile > seq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i & 3;
      const int row = r_lo + gr + 8 * (e >> 1);
      const int col = k0 + 8 * (i >> 2) + 2 * tq + (e & 1);
      float p = exp2f(s[i] * sl2 - lse2[e >> 1]);
      if (need_mask && !keep_pair(row, col, seq, causal, window)) p = 0.f;
      s[i] = p * (dp[i] - dlt[e >> 1]) * scale;  // dS, fp32
    }

    // dQ += dS K: dS (rounded to bf16) is the A operand from registers, K
    // the MN-major B
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      acc_to_a(s, kc, a[kc]);
      fence_regs(a[kc]);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int p = 0; p < kP; ++p) wgmma_rs_n64_t(acc[p], a[kc], desc_mn(sk, 16 * kc, p));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kP; ++p) fence_regs(acc[p]);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + gr + 8 * i;
    if (row >= seq) continue;
    bf16* out = dq + q_off + static_cast<long>(row) * hd;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * p + 8 * j + 2 * tq;
        if (c >= hd) continue;
        const float lo_v = acc[p][4 * j + 2 * i], hi_v = acc[p][4 * j + 2 * i + 1];
        if ((hd & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(lo_v, hi_v);
        } else {
          out[c] = __float2bfloat16(lo_v);
          if (c + 1 < hd) out[c + 1] = __float2bfloat16(hi_v);
        }
      }
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTC, 2)
flash_bwd_dkv_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int hq,
                          int hkv, int seq, int hd, float scale, int causal,
                          int window, int vec) {
  constexpr int kBytes = kTile * kD * 2;
  constexpr int kP = kD / 64;
  extern __shared__ unsigned char smem_tc[];
  unsigned char* ks = smem_1k(smem_tc);     // resident K
  unsigned char* vs = ks + kBytes;          // resident V
  unsigned char* ring = vs + kBytes;        // stage s: Q at 2s, dO at 2s + 1
  float* rows = reinterpret_cast<float*>(ring + 4 * kBytes);  // [stage][lse, delta][kTile]

  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most queries
  const int bhk = blockIdx.x;
  const int b = bhk / hkv;
  const int hk = bhk - b * hkv;
  const int group = hq / hkv;
  const long kv_off = static_cast<long>(bhk) * seq * hd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int c_lo = k0 + warp * 16;  // this warp's first key
  const float sl2 = scale * kLog2e;

  // query tiles that can see this key tile
  int qlo = 0;
  int qhi = (seq + kTile - 1) / kTile;
  if (causal) {
    qlo = k0 / kTile;
    if (window > 0) {
      const int k_last = min(k0 + kTile - 1, seq - 1);
      qhi = min(k_last + window - 1, seq - 1) / kTile + 1;
    }
  }
  const int n_q = qhi - qlo;
  const int n_pairs = group * n_q;

  // Q, dO, lse (+inf past seq, so P = 0 there) and delta of pair `i` into
  // ring stage `st`
  auto load_pair = [&](int i, int st) {
    const int mem = i / n_q;
    const int q0 = (qlo + i % n_q) * kTile;
    const long bh = static_cast<long>(b) * hq + hk * group + mem;
    unsigned char* stage = ring + st * 2 * kBytes;
    load_tile_bf16<kD>(stage, q + bh * seq * hd, q0, seq, hd, vec);
    load_tile_bf16<kD>(stage + kBytes, dout + bh * seq * hd, q0, seq, hd, vec);
    float* rs = rows + st * 2 * kTile;
    if (threadIdx.x < 2 * kTile) {
      const int which = threadIdx.x / kTile;  // 0: lse, 1: delta
      const int r = threadIdx.x % kTile;
      const int g = q0 + r;
      float* dst = rs + which * kTile + r;
      if (g < seq) {
        cp_async4(smem_addr(dst), (which ? delta : lse) + bh * seq + g);
      } else {
        *dst = which ? 0.f : INFINITY;
      }
    }
  };

  load_tile_bf16<kD>(ks, k + kv_off, k0, seq, hd, vec);
  load_tile_bf16<kD>(vs, v + kv_off, k0, seq, hd, vec);
  if (n_pairs > 0) load_pair(0, 0);
  cp_async_commit();

  const uint32_t sk = smem_addr(ks);
  const uint32_t sv = smem_addr(vs);
  const int n_k16 = (hd + 15) / 16;

  float dka[kP][32], dva[kP][32];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) { dka[p][i] = 0.f; dva[p][i] = 0.f; }

  for (int i = 0; i < n_pairs; ++i) {
    const int st = i & 1;
    if (i + 1 < n_pairs) {
      load_pair(i + 1, st ^ 1);
      cp_async_commit();
      tiles_arrived<1>();
    } else {
      tiles_arrived<0>();
    }
    const uint32_t sq = smem_addr(ring + st * 2 * kBytes);
    const uint32_t sdo = sq + kBytes;
    const float* lses = rows + st * 2 * kTile;
    const float* deltas = lses + kTile;
    const int q0 = (qlo + i % n_q) * kTile;

    // two halves of 32 query rows, to bound the live registers
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 32;  // first query row of the half, in the tile
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 query rows
      float s[16], dp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) { s[j] = 0.f; dp[j] = 0.f; }
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        if (kk < n_k16) {
          wgmma_ss_n32(s, desc_k(sk, 0, kk), desc_k(sq, n0, kk));
          wgmma_ss_n32(dp, desc_k(sv, 0, kk), desc_k(sdo, n0, kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T (into s) and dS^T (into dp), fp32; the mask only where needed
      const int qh = q0 + n0;
      const bool need_mask = (causal && c_lo + 15 > qh) ||
                             (causal && window > 0 && qh + 31 - c_lo >= window);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = j & 3;
        const int key = c_lo + gr + 8 * (e >> 1);
        const int rl = n0 + 8 * (j >> 2) + 2 * tq + (e & 1);  // query row in the tile
        float p = exp2f(s[j] * sl2 - lses[rl] * kLog2e);
        if (need_mask && !keep_pair(q0 + rl, key, seq, causal, window)) p = 0.f;
        s[j] = p;
        dp[j] = p * (dp[j] - deltas[rl]) * scale;
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (rounded to bf16) are
      // the A operands from registers, dO and Q the MN-major B
      uint32_t ap[2][4], ads[2][4];
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        acc_to_a(s, kc, ap[kc]);
        acc_to_a(dp, kc, ads[kc]);
        fence_regs(ap[kc]);
        fence_regs(ads[kc]);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        fence_regs(dva[p]);
        fence_regs(dka[p]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          wgmma_rs_n64_t(dva[p], ap[kc], desc_mn(sdo, n0 + 16 * kc, p));
          wgmma_rs_n64_t(dka[p], ads[kc], desc_mn(sq, n0 + 16 * kc, p));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        fence_regs(dva[p]);
        fence_regs(dka[p]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c_lo + gr + 8 * i;
    if (key >= seq) continue;
    bf16* dko = dk + kv_off + static_cast<long>(key) * hd;
    bf16* dvo = dv + kv_off + static_cast<long>(key) * hd;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * p + 8 * j + 2 * tq;
        if (c >= hd) continue;
        const int r = 4 * j + 2 * i;
        if ((hd & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dko + c) =
              __floats2bfloat162_rn(dka[p][r], dka[p][r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvo + c) =
              __floats2bfloat162_rn(dva[p][r], dva[p][r + 1]);
        } else {
          dko[c] = __float2bfloat16(dka[p][r]);
          dvo[c] = __float2bfloat16(dva[p][r]);
          if (c + 1 < hd) {
            dko[c + 1] = __float2bfloat16(dka[p][r + 1]);
            dvo[c + 1] = __float2bfloat16(dva[p][r + 1]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------------ //
// launchers
// ------------------------------------------------------------------------ //
template <int kD>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int batch, int hq,
                   int hkv, int seq, int hd, float scale, int causal, int window,
                   cudaStream_t s) {
  // Q, dO, two stages of K and V, and the 1 KB alignment slack
  const size_t smem = 6 * kTile * kD * 2 + 1024;
  const int err = raise_smem_limit(flash_bwd_dq_kernel_bf16<kD>, smem);
  if (err != 0) return err;
  const dim3 grid(batch * hq, (seq + kTile - 1) / kTile);
  flash_bwd_dq_kernel_bf16<kD><<<grid, kTC, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), hq, hkv, seq, hd, scale, causal, window,
      vec_ok(hd, {q, k, v, dout}) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv,
                    int batch, int hq, int hkv, int seq, int hd, float scale,
                    int causal, int window, cudaStream_t s) {
  // K, V, two stages of Q and dO, two stages of lse and delta, and the 1 KB
  // alignment slack
  const size_t smem = 6 * kTile * kD * 2 + 4 * kTile * sizeof(float) + 1024;
  const int err = raise_smem_limit(flash_bwd_dkv_kernel_bf16<kD>, smem);
  if (err != 0) return err;
  const dim3 grid(batch * hkv, (seq + kTile - 1) / kTile);
  flash_bwd_dkv_kernel_bf16<kD><<<grid, kTC, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, seq, hd, scale,
      causal, window, vec_ok(hd, {q, k, v, dout}) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int batch, int hq,
                  int hkv, int seq, int hd, float scale, int causal, int window,
                  cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) * (2 * kBQ * ld + 2 * kBK * ld + kBQ * (kBK + 1));
  const int err = raise_smem_limit(flash_bwd_dq_kernel_f32, smem);
  if (err != 0) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  flash_bwd_dq_kernel_f32<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), hq, hkv, seq, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int batch,
                   int hq, int hkv, int seq, int hd, float scale, int causal,
                   int window, cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) *
      (2 * kBK * ld + 2 * kBQ * ld + 2 * kBK * (kBQ + 1) + 2 * kBQ);
  const int err = raise_smem_limit(flash_bwd_dkv_kernel_f32, smem);
  if (err != 0) return err;
  const dim3 grid((seq + kBK - 1) / kBK, batch * hkv);
  flash_bwd_dkv_kernel_f32<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv, seq, hd, scale,
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
    return launch_dq_f32(q, k, v, dout, lse, delta, dq, batch, hq, hkv, seq, hd,
                         scale, causal, window, s);
  }
  if (dtype == 1) {
    return hd <= 64
        ? launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, seq,
                             hd, scale, causal, window, s)
        : launch_dq_bf16<128>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, seq,
                              hd, scale, causal, window, s);
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
    return launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, seq,
                          hd, scale, causal, window, s);
  }
  if (dtype == 1) {
    return hd <= 64
        ? launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv,
                              seq, hd, scale, causal, window, s)
        : launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv,
                               seq, hd, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
