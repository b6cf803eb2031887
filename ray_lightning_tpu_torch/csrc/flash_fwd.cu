// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel of ray_lightning_tpu/ops/attention.py
// (_fwd_kernel, lines 114-166, pallas_call at line 385 in _flash_fwd):
// softmax(Q K^T * scale) V with an fp32 online softmax, causal or full,
// optional sliding window (position i attends [i - W + 1, i]), GQA (query
// head h reads KV head h // group), any S and any head dim up to 128.
// Outputs O in q's type and the per-row natural-log logsumexp [B, Hq, S] fp32.
//
// Bound on the H100: two products of 2 * hd FLOP per (row, key) pair that the
// mask keeps. At the training shape (q [8,16,2048,128], kv [8,8,2048,128],
// bf16, causal: 2.7e8 pairs) that is 0.137 TFLOP, 0.139 ms at the 989 TFLOP/s
// of the bf16 tensor cores against ~0.06 ms to move the ~200 MB of inputs and
// outputs: operations bound it. At the prefill shape (q [1,32,512,128], kv
// [1,8,512,128], causal) it is 2.2 GFLOP (2.2 us) against 10.5 MB (3.1 us):
// bytes bound it, and a single wave of 128 blocks is what the grid offers.
//
// bf16 (the training and prefill paths): every product runs on the tensor
// cores as wgmma.mma_async (m64n64k16, bf16 in, fp32 accumulators in
// registers), on the tile machinery of hopper_tile.cuh:
//  - A block owns 128 query rows as two warpgroups of 64 (each warp 16 rows),
//    and walks the 64-key tiles of the band: from the window's lower edge (the
//    TPU's _block_active skip, as a loop bound) to the causal bound. Q is
//    resident in shared memory; K and V arrive by 16-byte cp.async into a
//    four-stage ring of 128-byte-swizzled bf16 panels that both warpgroups
//    share, so each K/V tile is read from L2 once for 128 rows (half the
//    traffic of 64-row blocks). While tile t computes, tiles t + 1 and
//    t + 2 are in flight; O += P V of tile t is waited for together with S
//    of tile t + 1, so the ring holds tiles t - 1 .. t + 2. One block
//    barrier per tile guards it. (Issuing S of tile t + 1 before the
//    softmax of tile t, to overlap the two, measured no faster.)
//    A whole tile takes one cp.async per 16-byte chunk at constant offsets
//    (load_full_tile_bf16). A warpgroup whose 64 rows lie wholly outside a
//    tile's band (above the diagonal, below the window, or past S) skips its
//    products but keeps to the barriers. The warpgroup and warp indices are
//    made warp-uniform for the compiler (warp_uniform), so the branches
//    around the products are not divergent and ptxas does not serialise
//    wgmma behind them.
//  - S = Q K^T reads both operands K-major from the panels. Its fp32
//    accumulators become P in registers: the online softmax in the exp2
//    domain (row max and row sum over the four lanes of a fragment row with
//    two shuffles), P rounded to bf16 and packed straight into the register A
//    operand of O += P V (the TPU kernel's p.astype(v.dtype)), with V as the
//    MN-major B through wgmma's transpose flag; the row sum uses the
//    unrounded fp32 P, as there. P never touches shared memory.
//  - Masks as _mask_scores (lines 88-111): -inf under a causal mask, the
//    finite -1e30 under a window (a row whose band misses a visited tile gets
//    a uniform contribution that the rescale of its first real tile
//    annihilates), -inf for the key columns past S of the ragged last tile.
//    Only a warp whose 16 x 64 piece crosses the diagonal, a window edge or
//    the ragged last key tile evaluates the per-element mask.
//  - l == 0 is guarded before the division and the log; lse leaves as
//    m * ln 2 + log l. O is normalised in registers, staged as bf16 in the
//    warpgroup's own Q tile (no longer read) and written with 16-byte stores;
//    query rows past S are never stored.
//  - The query tile is the slow grid dimension, issued in reverse under a
//    causal mask: the heaviest blocks start first and the grid does not end
//    on a tail of them. Shared memory: 161 KB per block at head dim 128
//    (81 KB at 64), one block of 256 threads per SM.
//  - Head dims that are no multiple of 8, or unaligned inputs, load and
//    store element by element (`vec` is decided per launch).
//
// fp32 (the exactness checks): the tensor cores would take fp32 operands as
// TF32 (~1e-3 relative), so fp32 inputs keep plain fp32 FMAs out of shared
// memory: one block of 256 threads per 64-row query tile, 4 lanes per row,
// the K/V loop inside the block.
#include "hopper_tile.cuh"

namespace {

constexpr int kDMax = 128;    // largest head dim

// ------------------------------------------------------------------------ //
// fp32: plain FMAs (exact up to summation order)
// ------------------------------------------------------------------------ //
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 4 lanes per query row
constexpr int kCols = kDMax / 4;  // output columns per lane
constexpr int kScores = kBK / 4;  // scores per lane per tile

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
    qs[rr * ld + c] = gq < seq ? q[q_off + static_cast<long>(gq) * hd + c] : 0.f;
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
      ks[rr * ld + c] = in ? k[src] : 0.f;
      vs[rr * ld + c] = in ? v[src] : 0.f;
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
      ps[r * (kBK + 1) + lane4 + 4 * j] = p;
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
    float* orow = o + q_off + static_cast<long>(row) * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane4 + 4 * i;
      if (d < hd) orow[d] = acc[i] * inv;
    }
    if (lane4 == 0) lse[static_cast<long>(bh) * seq + row] = m + logf(l_safe);
  }
}

// ------------------------------------------------------------------------ //
// bf16: tensor cores (wgmma), two warpgroups per block, cp.async ring
// ------------------------------------------------------------------------ //
constexpr int kGroups = 2;                 // consumer warpgroups per block
constexpr int kRows = kGroups * kTile;     // query rows per block
constexpr int kFwdThreads = kGroups * kTC;
constexpr int kStages = 4;                 // K/V ring: tiles t - 1 .. t + 2
constexpr float kLn2 = 0.6931471805599453f;

// the warpgroup's 128 threads meet (named barrier 1 + group; 0 is the
// block's __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(kTC) : "memory");
}

// 2^x in one MUFU instruction (ex2.approx: ~2 ulp, subnormal results
// flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a value the compiler can prove is the same on every lane of the warp (a
// shuffle from lane 0): branches on it around wgmma are not divergent, so
// ptxas keeps the products asynchronous instead of serialising them
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// issue S = Q K^T (64 query rows x 64 keys, K-major operands, every k16
// step of the panels: columns past hd are zero) into `s` as one wgmma
// group; the caller waits for it. The first step overwrites `s`, so no
// plain instruction has to zero it while the previous product is in flight
template <int kD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq, uint32_t sk) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss_n64(s, desc_k(sq, 0, kk), desc_k(sk, 0, kk), kk > 0);
  }
  wgmma_commit();
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int seq, int hd,
                      float scale, int causal, int window, int vec) {
  constexpr int kBytes = kTile * kD * 2;
  constexpr int kP = kD / 64;              // 64-column panels
  constexpr int kChunks = kD / 8;
  extern __shared__ unsigned char smem_tc[];
  unsigned char* qs = smem_1k(smem_tc);    // Q: warpgroup g's rows at g * kBytes
  unsigned char* ring = qs + kGroups * kBytes;  // stage s: K at 2s, V at 2s + 1

  // the query tile is the slow grid dimension, heaviest first under a
  // causal mask
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kRows;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const long q_off = static_cast<long>(bh) * seq * hd;
  const long kv_off = (static_cast<long>(b) * hkv + hk) * seq * hd;

  const int group = warp_uniform(threadIdx.x / kTC);
  const int warp = warp_uniform((threadIdx.x / 32) % kWarps);  // within the warpgroup
  const int gtid = threadIdx.x % kTC;  // thread within the warpgroup
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;            // fragment row (and row + 8)
  const int tq = lane & 3;             // fragment column pair
  const int g0 = q0 + group * kTile;   // the warpgroup's first query row
  const int r_lo = g0 + warp * 16;     // this warp's first query row
  const float sl2 = scale * kLog2e;
  const float neg = window > 0 ? -1e30f : -INFINITY;  // masked, under causal

  // key tiles of the block's band, and of the warpgroup's own
  int lo = 0;
  int hi = (seq + kTile - 1) / kTile;
  int my_lo = lo;
  int my_hi = hi;
  if (causal) {
    hi = min(q0 + kRows - 1, seq - 1) / kTile + 1;
    my_hi = min(g0 + kTile - 1, seq - 1) / kTile + 1;
    if (window > 0) {
      lo = max(q0 - (window - 1), 0) / kTile;
      my_lo = max(g0 - (window - 1), 0) / kTile;
    }
  }
  if (g0 >= seq) my_hi = my_lo;  // every row past S: no product, no store

  // tile t lives in ring stage (t - lo) % kStages. A whole tile of
  // 16-byte-aligned rows of hd == kD takes one cp.async a chunk at constant
  // offsets; the ragged last tile, narrower head dims and unaligned inputs
  // take the general loader
  const bool whole = vec && hd == kD;
  auto stage = [&](int t) { return ring + ((t - lo) % kStages) * 2 * kBytes; };
  auto load_kv = [&](int t) {
    if (whole && (t + 1) * kTile <= seq) {
      load_full_tile_bf16<kD, kFwdThreads>(stage(t), k + kv_off, t * kTile);
      load_full_tile_bf16<kD, kFwdThreads>(stage(t) + kBytes, v + kv_off, t * kTile);
    } else {
      load_tile_bf16<kD, kFwdThreads>(stage(t), k + kv_off, t * kTile, seq, hd, vec);
      load_tile_bf16<kD, kFwdThreads>(stage(t) + kBytes, v + kv_off, t * kTile, seq, hd, vec);
    }
  };

  // cp.async groups: Q with tile lo, then tile lo + 1, then one per step
  // below (empty where no tile is left)
  for (int g = 0; g < kGroups; ++g) {
    load_tile_bf16<kD, kFwdThreads>(qs + g * kBytes, q + q_off, q0 + g * kTile, seq, hd, vec);
  }
  load_kv(lo);
  cp_async_commit();
  if (lo + 1 < hi) load_kv(lo + 1);
  cp_async_commit();

  unsigned char* my_q = qs + group * kBytes;
  const uint32_t sq = smem_addr(my_q);

  float acc[kP][32];                 // O: panel p, n8 tile j at [4j, 4j + 4)
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows gr, gr + 8 (log2 units)
  float l[2] = {0.f, 0.f};              // running sum
  float s[32];                          // S, then P, of the current tile

#pragma unroll 1
  for (int kt = lo; kt < hi; ++kt) {
    // tile kt has landed, and every thread is past step kt - 1, whose wait
    // ended the product that read tile kt - 2: its stage takes tile kt + 2
    tiles_arrived<1>();
    if (kt + 2 < hi) load_kv(kt + 2);
    cp_async_commit();
    if (kt < my_lo || kt >= my_hi) continue;
    // S of tile kt queues behind O += P V of tile kt - 1; one wait ends
    // both before O is rescaled
    issue_qk<kD>(s, sq, smem_addr(stage(kt)));
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int p = 0; p < kP; ++p) fence_regs(acc[p]);

    // element i is row gr + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
    // 2 * tq + (i & 1). A piece that needs the mask is scaled first (the
    // TPU's -inf / -1e30 are values of the scaled score); the others are
    // scaled inside the exponent's FMA
    const int k0 = kt * kTile;
    const bool need_mask = (causal && k0 + kTile - 1 > r_lo) ||
                           (causal && window > 0 && r_lo + 15 - k0 >= window) ||
                           k0 + kTile > seq;
    float f = sl2;
    if (need_mask) {
      f = 1.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = r_lo + gr + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        float x = s[i] * sl2;
        if (col >= seq) {
          x = -INFINITY;
        } else if (!keep_pair(row, col, seq, causal, window)) {
          x = neg;
        }
        s[i] = x;
      }
    }
    // online softmax in the exp2 domain: the row max and the row sum over
    // the four lanes of a fragment row take two shuffles each
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mref[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float mn = fmaxf(m[hr], mx[hr] * f);
      // a row with no finite score yet keeps exp2() nan-free
      mref[hr] = mn == -INFINITY ? 0.f : mn;
      alpha[hr] = fast_exp2(m[hr] - mref[hr]);
      m[hr] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      const float p = fast_exp2(fmaf(s[i], f, -mref[hr]));
      rs[hr] += p;
      s[i] = p;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l[hr] = l[hr] * alpha[hr] + rs[hr];
    }
    // O is rescaled on every tile: skipping it when no row max moved
    // measured no faster and puts a branch around the accumulators
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

    // O += P V: P (rounded to bf16, the TPU's p.astype(v.dtype)) is the A
    // operand from registers, V the MN-major B
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      acc_to_a(s, kc, a[kc]);
      fence_regs(a[kc]);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) fence_regs(acc[p]);
    wgmma_fence();
    const uint32_t sv = smem_addr(stage(kt)) + kBytes;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int p = 0; p < kP; ++p) wgmma_rs_n64_t(acc[p], a[kc], desc_mn(sv, 16 * kc, p));
    wgmma_commit();
  }
  wgmma_wait<0>();  // O += P V of the warpgroup's last tile
#pragma unroll
  for (int p = 0; p < kP; ++p) fence_regs(acc[p]);
  cp_async_wait<0>();
  if (g0 >= seq) return;

  // O / l as bf16 into the warpgroup's Q tile (its products are done), then
  // to memory in 16-byte chunks; lse = m ln 2 + log l
  group_sync(group);  // every warp's last product has read the Q tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + gr + 8 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    const int r = warp * 16 + gr + 8 * i;
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(my_q + tile_off(r, 8 * p + j) + 4 * tq) =
            pack_bf16(acc[p][4 * j + 2 * i] * inv, acc[p][4 * j + 2 * i + 1] * inv);
      }
    if (tq == 0 && row < seq) {
      lse[static_cast<long>(bh) * seq + row] = m[i] * kLn2 + logf(l_safe);
    }
  }
  group_sync(group);
  for (int i = gtid; i < kTile * kChunks; i += kTC) {
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const int g = g0 + r;
    const int c = ch * 8;
    if (g >= seq || c >= hd) continue;
    const unsigned char* src = my_q + tile_off(r, ch);
    bf16* dst = o + q_off + static_cast<long>(g) * hd + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const bf16* w = reinterpret_cast<const bf16*>(src);
      for (int e = 0; e < 8 && c + e < hd; ++e) dst[e] = w[e];
    }
  }
}

// ------------------------------------------------------------------------ //
// launchers
// ------------------------------------------------------------------------ //
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
               int batch, int hq, int hkv, int seq, int hd, float scale,
               int causal, int window, cudaStream_t s) {
  const int ld = hd + 1;
  const size_t smem = sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * (kBK + 1));
  const int err = raise_smem_limit(flash_fwd_kernel_f32, smem);
  if (err != 0) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  flash_fwd_kernel_f32<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      hq, hkv, seq, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                int batch, int hq, int hkv, int seq, int hd, float scale,
                int causal, int window, cudaStream_t s) {
  // both warpgroups' Q, the K/V ring, and the 1 KB alignment slack
  const size_t smem = (kGroups + 2 * kStages) * kTile * kD * 2 + 1024;
  const int err = raise_smem_limit(flash_fwd_kernel_bf16<kD>, smem);
  if (err != 0) return err;
  const dim3 grid(batch * hq, (seq + kRows - 1) / kRows);
  flash_fwd_kernel_bf16<kD><<<grid, kFwdThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      hq, hkv, seq, hd, scale, causal, window, vec_ok(hd, {q, k, v, o}) ? 1 : 0);
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
  if (hd <= 0 || hd > kDMax || hkv <= 0 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_f32(q, k, v, o, lse, batch, hq, hkv, seq, hd, scale, causal,
                      window, s);
  }
  if (dtype == 1) {
    return hd <= 64
        ? launch_bf16<64>(q, k, v, o, lse, batch, hq, hkv, seq, hd, scale,
                          causal, window, s)
        : launch_bf16<128>(q, k, v, o, lse, batch, hq, hkv, seq, hd, scale,
                           causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
