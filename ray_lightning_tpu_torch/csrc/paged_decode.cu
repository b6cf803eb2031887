// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel of ray_lightning_tpu/ops/paged_attention.py
// (_paged_decode_kernel, pallas_call at line 196 in paged_decode_attention):
// one query position per row, GQA-folded as q [B, Hkv, G, hd] fp32, attends
// over its logical positions [0, pos[b]] of a block-paged cache
// [N, Hkv, bs, hd], walking block_tables[b, :] to find each logical block.
// fp32 online softmax, fp32 output [B, Hkv, G, hd].
//
// Bound on the H100: bytes. Each row reads (pos[b] + 1) keys and values per
// KV head once and does 4 * G * hd flops per position, ~4 flops per cache
// byte at G = 4: two orders of magnitude below the compute line. At 8 rows x
// 8 KV heads, hd 128, a bf16 cache: the serving test shape (pos 1000, 777,
// 512, 300, 128, 63, 16, 0: 2804 positions) moves 11.7 MB, 0.0035 ms at
// 3.35 TB/s; the full cache (every row at pos 1023) 33.6 MB, 0.0101 ms.
//
// What limits it is latency: a call is a chain of dependent round trips
// (pos, then the block table, then K and V, then the merge), and at 3.35
// TB/s and ~1 us of DRAM latency ~3 MB must be in flight to reach the
// bandwidth. The design (the alternatives named below ran slower on the
// H100):
//
// - Chunks. A row's positions are split into chunks of `split` positions
//   (the wrapper passes 64; 32 and 128 measured slower), one block of 4
//   warps per (row, KV head, chunk): grid (B * Hkv, ceil(max_blocks * bs /
//   split)), a function of host-known sizes only (the wrapper never reads
//   pos). Chunks past pos exit at once; the last chunks are dispatched first
//   (blockIdx.y counts down), since most rows leave them empty, so their
//   blocks are gone before the chunks every row fills need the SMs' slots.
// - Tiles of positions by 16-byte cp.async into a 32 KB shared-memory ring.
//   A tile holds the K and V rows of kTP consecutive logical positions (4 KB
//   each: 16 positions at hd 128 in bf16), gathered row by row through the
//   block's table entries, which are read once, up front, into shared memory
//   (only the entries of pages this chunk touches: none past pos // bs). The
//   ring holds a group of kStages tiles (64 positions at hd 128 in bf16), all
//   in flight at once, so a 64-position chunk requests all its bytes at once:
//   at the serving test shape the 392 blocks with work request all 11.7 MB
//   right after reading their table entries. A page of any bs is read this
//   way, so no bs needs a slower path; a cache pointer that is not 16-byte
//   aligned takes plain element loads (decided per launch). q comes by
//   cp.async with the first tile.
// - Scores without a shuffle tree per position: kSplit threads share a
//   position (8 at hd 128, G 4), each holding its stretch of q for all G
//   heads in registers and reading 16-byte pieces of the K row from shared
//   memory (the kSplit threads read one contiguous stretch: no bank
//   conflicts); a reduce-scatter over those threads leaves each head's score
//   on one of them in G - 1 shuffles. Then the online softmax once per group
//   (one warp per query head: one max, one rescale factor, exp2 in the log2
//   domain), then P V with each thread owning 8 bytes of hd for all G heads
//   and a subset of the group's positions; the subsets are summed once per
//   chunk in a fixed order.
// - One launch per call. Each block writes its chunk's partial state (max,
//   sum, unnormalised output per query head) and counts its arrival in an
//   int32 counter per (row, KV head) that the caller passes (`arrivals`: the
//   wrapper keeps one zeroed buffer per (device, stream), so two calls that
//   run at once on two streams never share a counter). The last block to
//   arrive resets the counter to 0 and merges the chunks in chunk order, so
//   the result is bitwise deterministic (no float atomics) and the call needs
//   no memset: it can be captured in a CUDA graph and replayed. A row with one
//   chunk skips the partials and writes its output directly.
// - Any head dim that is a multiple of 8, up to 256. The widths 32, 64, 128
//   and 256 keep their compile-time row strides (kPadded false). Another
//   width runs on the instantiation of the next width up (kPadded true): the
//   cache's rows are read at the real head dim's stride, the 16-byte chunks
//   past it are zero-filled in shared memory (cp.async with a source size of
//   0), and q and the output come at the padded width (the wrapper pads q
//   with zeros and slices the output); the pool is never padded. A multiple
//   of 8 keeps every row 16-byte aligned in bf16 and fp32.
// - Groups: 1, 2, 4 and 8 are instantiated; the wrapper pads 3, 5-7 with zero
//   query heads and splits a group above 8 into launches of at most 8 heads
//   over the same caches and tables (each launch reads its KV head's blocks
//   again: G 16 moves twice the bytes of one pass).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRingBytes = 32768;    // the shared-memory ring of K/V tiles
constexpr int kMaxRows = 1 << 16;    // B * Hkv the arrival counters cover
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <typename T, int G, int HD>
struct Cfg {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  // positions per tile: K and V of a tile fill at most 8 KB, and a
  // thread's share of q (G * HD * kTP / kThreads floats) at most 64 registers
  static constexpr int kTP = cmin(cmin(4096 / kRowBytes, 64 * kThreads / (G * HD)), 64);
  static constexpr int kTileBytes = kTP * kRowBytes;
  static constexpr int kStages = cmin(kRingBytes / (2 * kTileBytes), 8);
  static constexpr int kGP = kStages * kTP;       // positions of a group of tiles
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks of a row
  static constexpr int kEPC = 16 / static_cast<int>(sizeof(T));  // elements per chunk
  static constexpr int kSplit = kThreads / kTP;   // threads per position's scores
  static constexpr int kCPT = kChunks / kSplit;   // chunks of a row per thread
  static constexpr int kEPV = 8 / static_cast<int>(sizeof(T));   // hd elements per thread in P V
  static constexpr int kTPR = HD / kEPV;          // threads per V row
  static constexpr int kGroups = kThreads / kTPR; // position subsets in P V
  static_assert(kTP >= 4 && kTP <= 64, "a tile's scores are one or two per lane");
  static_assert(kStages >= 2, "a ring of at least two tiles");
  static_assert(kSplit <= 32 && kCPT >= 1 && kChunks % kSplit == 0,
                "a position's threads share a warp and split its row evenly");
  static_assert(kTPR <= kThreads && kThreads % kTPR == 0, "P V covers hd");
  static_assert(kGroups * G * HD * 4 <= kRingBytes, "the group sums fit in the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}
// 16 bytes when `bytes` is 16, zeros when it is 0 (nothing is read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// wait until at most n (< kMax) copy groups are pending
template <int kMax>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (kMax > 1) {
    if (n >= kMax - 1) {
      cp_async_wait<kMax - 1>();
      return;
    }
    cp_async_wait_upto<kMax - 1>(n);
  } else {
    cp_async_wait<0>();
  }
}

// the floats of a 16-byte chunk (bf16: 8, fp32: 4)
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// 8 bytes of V (bf16: 4 values, fp32: 2)
__device__ __forceinline__ void unpack8(const uint2& u, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack8(const uint2& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
}
__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) { return __float2bfloat16(0.f); }

// G consecutive floats of shared memory, in the widest loads they allow
template <int G>
__device__ __forceinline__ void load_g(const float* src, float* dst) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bytes of dynamic shared memory before q and the ring: a group's scores
// and the chunk's table entries, rounded up to 128
__host__ __device__ constexpr int head_bytes(int g, int tp, int max_pages) {
  return (g * tp * 4 + max_pages * 4 + 127) / 128 * 128;
}

// grid: (B * Hkv, n_chunks), `split` positions per chunk; dynamic shared
// memory: a group's scores [kGP][G], the chunk's table entries, q, then the
// ring (reused at the end for the position subsets' sums and the merge).
// kPadded: the cache's head dim `hd` is below HD (q and out are HD wide)
template <typename T, int G, int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ tables,
                    const int* __restrict__ pos, float* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int* __restrict__ arrivals,
                    int hkv, int bs, int max_blocks, int split, int hd,
                    float qscale, bool vec) {
  using C = Cfg<T, G, HD>;
  // the cache's row stride and the 16-byte chunks of a row that hold data:
  // compile-time at an instantiated width
  const int row_len = kPadded ? hd : HD;
  const int row_chunks = kPadded ? hd * static_cast<int>(sizeof(T)) / 16 : C::kChunks;
  extern __shared__ __align__(128) unsigned char smem[];
  const int max_pages = (split + bs - 1) / bs + 1;
  float* s_s = reinterpret_cast<float*>(smem);            // scores, then P
  int* table_s = reinterpret_cast<int*>(s_s + G * C::kGP);
  float* q_s = reinterpret_cast<float*>(smem + head_bytes(G, C::kGP, max_pages));
  unsigned char* ring = reinterpret_cast<unsigned char*>(q_s + G * HD);
  __shared__ __align__(16) float m_s[G], l_s[G], a_s[G];
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  // blocks are dispatched in order of blockIdx.y: the last chunks first, as
  // they are the ones most rows leave empty, so their blocks exit before the
  // chunks that every row fills take the SMs' slots
  const int chunk = gridDim.y - 1 - blockIdx.y;
  // scores: thread (sp, sub) takes chunks sub, sub + kSplit, ... of the row
  // of position sp, against its share of q, held in registers
  const int sp = tid / C::kSplit;
  const int sub = tid % C::kSplit;

  // a position past the table reads the whole table, as the plain version
  const int p_last = min(pos[b], max_blocks * bs - 1);
  const int start = chunk * split;
  if (start > p_last) return;  // past the row's position: nothing to read
  const int end = min(start + split, p_last + 1);
  const int n_used = p_last / split + 1;  // chunks of this row with work
  const int first_page = start / bs;
  const int n_pages = (end - 1) / bs - first_page + 1;
  const int* row_table = tables + static_cast<long>(b) * max_blocks + first_page;
  for (int i = tid; i < n_pages; i += kThreads) table_s[i] = row_table[i];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  // q by 16-byte cp.async, in the first copy group with tile 0; each
  // thread's share of it goes into registers once tile 0 has landed
  {
    const float* qrow = q + static_cast<long>(bh) * G * HD;
    for (int i = tid; i < G * HD / 4; i += kThreads) cp_async16(smem_addr(q_s + 4 * i), qrow + 4 * i);
  }

  const int n_pos = end - start;
  const int n_tiles = (n_pos + C::kTP - 1) / C::kTP;
  const long head_stride = static_cast<long>(bs) * row_len;  // elements of one page of one head

  // tile t of the chunk into ring slot `slot`
  auto load_tile = [&](int t, int slot) {
    unsigned char* k_dst = ring + slot * 2 * C::kTileBytes;
    unsigned char* v_dst = k_dst + C::kTileBytes;
    const int p0 = start + t * C::kTP;
    const int n = min(C::kTP, end - p0);
    if (vec) {
      for (int i = tid; i < n * C::kChunks; i += kThreads) {
        const int r = i / C::kChunks;
        const int c = i % C::kChunks;
        const int p = p0 + r;
        const int page = p / bs;
        const long blk = table_s[page - first_page];
        const long row = (blk * hkv + h) * head_stride + static_cast<long>(p - page * bs) * row_len;
        const int so = r * C::kRowBytes + c * 16;
        if (!kPadded || c < row_chunks) {
          cp_async16(smem_addr(k_dst + so), kc + row + c * C::kEPC);
          cp_async16(smem_addr(v_dst + so), vc + row + c * C::kEPC);
        } else {  // past the real head dim: zeros, nothing read
          cp_async16_zfill(smem_addr(k_dst + so), kc + row, 0);
          cp_async16_zfill(smem_addr(v_dst + so), vc + row, 0);
        }
      }
    } else {
      T* kd = reinterpret_cast<T*>(k_dst);
      T* vd = reinterpret_cast<T*>(v_dst);
      for (int i = tid; i < n * HD; i += kThreads) {
        const int r = i / HD;
        const int d = i % HD;
        const int p = p0 + r;
        const int page = p / bs;
        const long blk = table_s[page - first_page];
        const long off = (blk * hkv + h) * head_stride + static_cast<long>(p - page * bs) * row_len + d;
        const bool in_row = !kPadded || d < row_len;
        kd[i] = in_row ? kc[off] : zero_of(static_cast<const T*>(nullptr));
        vd[i] = in_row ? vc[off] : zero_of(static_cast<const T*>(nullptr));
      }
    }
  };

  float acc[G][C::kEPV];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < C::kEPV; ++j) acc[g][j] = 0.f;
  const int vt = tid % C::kTPR;      // this thread's 8 bytes of hd in P V
  const int grp = tid / C::kTPR;     // and its subset of positions
  float qr[G][C::kCPT * C::kEPC];

  // groups of up to kStages tiles: all of a group's tiles are in flight at
  // once (one copy group each), the scores of each tile are computed as it
  // lands, then one online-softmax step and one P V pass cover the group
  for (int t0 = 0; t0 < n_tiles; t0 += C::kStages) {
    const int nt = min(C::kStages, n_tiles - t0);
    const int gn = min(C::kGP, end - (start + t0 * C::kTP));  // positions of the group
    if (t0 > 0) __syncthreads();  // the previous group's P V is done with the ring
    for (int i = 0; i < nt; ++i) {
      load_tile(t0 + i, i);
      cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
      cp_async_wait_upto<C::kStages>(nt - 1 - i);
      __syncthreads();  // tile i landed for every thread
      if (t0 == 0 && i == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c = 0; c < C::kCPT; ++c)
#pragma unroll
            for (int j = 0; j < C::kEPC / 4; ++j) {
              const float4 v = reinterpret_cast<const float4*>(
                  q_s + g * HD + (sub + C::kSplit * c) * C::kEPC)[j];
              float* d = qr[g] + c * C::kEPC + 4 * j;
              d[0] = v.x * qscale;
              d[1] = v.y * qscale;
              d[2] = v.z * qscale;
              d[3] = v.w * qscale;
            }
      }
      const unsigned char* k_tile = ring + i * 2 * C::kTileBytes;
      const int n = min(C::kTP, gn - i * C::kTP);

      // scores of position sp for all G heads: kCPT 16-byte K reads (the
      // kSplit threads of a position read one contiguous stretch of the row)
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      if (sp < n) {
        const unsigned char* krow = k_tile + sp * C::kRowBytes;
#pragma unroll
        for (int c = 0; c < C::kCPT; ++c) {
          const uint4 u = *reinterpret_cast<const uint4*>(krow + (sub + C::kSplit * c) * 16);
          float kf[C::kEPC];
          unpack16(u, kf, static_cast<const T*>(nullptr));
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int e = 0; e < C::kEPC; ++e) s[g] = fmaf(qr[g][c * C::kEPC + e], kf[e], s[g]);
        }
      }
      // reduce-scatter over the kSplit threads: each halving step trades
      // half of the heads' sums with the partner lane, so a lane ends with
      // the full sums of G / kSplit heads (or of one, shared by kSplit / G
      // lanes) after G - 1 shuffles instead of G log2(kSplit)
      int g0 = 0;
      int nv = G;
#pragma unroll
      for (int o = C::kSplit / 2; o > 0; o >>= 1) {
        if (nv > 1) {
          const bool up = sub & o;
#pragma unroll
          for (int k = 0; k < nv / 2; ++k) {
            const float send = up ? s[k] : s[k + nv / 2];
            const float keep = up ? s[k + nv / 2] : s[k];
            s[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
          if (up) g0 += nv / 2;
          nv /= 2;
        } else {
          s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
        }
      }
      if (sp < n && sub % (C::kSplit / G > 1 ? C::kSplit / G : 1) == 0) {
#pragma unroll
        for (int k = 0; k < (G > C::kSplit ? G / C::kSplit : 1); ++k)
          s_s[(i * C::kTP + sp) * G + g0 + k] = s[k];
      }
    }
    __syncthreads();

    // online softmax once per group: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mt = -INFINITY;
      for (int p = lane; p < gn; p += 32) mt = fmaxf(mt, s_s[p * G + g]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mt));
      float sum = 0.f;
      for (int p = lane; p < gn; p += 32) {
        const float e = exp2f(s_s[p * G + g] - m_new);
        s_s[p * G + g] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V: 8 bytes of hd for all G heads, positions grp, grp + kGroups, ...
    {
      float alpha[G];
      load_g<G>(a_s, alpha);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < C::kEPV; ++j) acc[g][j] *= alpha[g];
    }
#pragma unroll 1
    for (int p = grp; p < gn; p += C::kGroups) {
      const unsigned char* v_row = ring + (p / C::kTP) * 2 * C::kTileBytes + C::kTileBytes
                                   + (p % C::kTP) * C::kRowBytes;
      const uint2 u = *reinterpret_cast<const uint2*>(v_row + vt * 8);
      float vf[C::kEPV], pg[G];
      unpack8(u, vf, static_cast<const T*>(nullptr));
      load_g<G>(s_s + p * G, pg);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < C::kEPV; ++j) acc[g][j] = fmaf(pg[g], vf[j], acc[g][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the groups' sums now

  float* red = reinterpret_cast<float*>(ring);  // [kGroups][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < C::kEPV; ++j) red[(grp * G + g) * HD + vt * C::kEPV + j] = acc[g][j];
  __syncthreads();

  const long out_base = static_cast<long>(bh) * G * HD;
  if (n_used == 1) {
    for (int o = tid; o < G * HD; o += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < C::kGroups; ++r) a += red[r * G * HD + o];
      out[out_base + o] = a / l_s[o / HD];
    }
    return;
  }

  // several chunks: write this chunk's partial state, count the arrival
  const int n_chunks = gridDim.y;
  const long prow = static_cast<long>(bh) * n_chunks + chunk;
  for (int o = tid; o < G * HD; o += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < C::kGroups; ++r) a += red[r * G * HD + o];
    part_acc[prow * G * HD + o] = a;
  }
  if (tid < G) {
    part_m[prow * G + tid] = m_s[tid];
    part_l[prow * G + tid] = l_s[tid];
  }
  // the block's writes, ordered by the barrier, are published by one
  // thread's fence before its arrival (the pattern of a grid-wide barrier)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(&arrivals[bh], 1) == n_used - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last_s) return;

  // the last block of (row, KV head) merges the chunks in chunk order; the
  // other blocks' partials are read from L2 (__ldcg), past this SM's L1.
  // The partial outputs of the first kUnroll chunks are loaded before the
  // chunks' weights are known, so both are in flight together.
  if (tid == 0) arrivals[bh] = 0;
  const long prow0 = static_cast<long>(bh) * n_chunks;
  constexpr int kOut = (G * HD + kThreads - 1) / kThreads;  // outputs a thread
  constexpr int kUnroll = 32 / kOut > 1 ? 32 / kOut : 1;      // chunks in flight
  float a[kOut], raw[kUnroll][kOut];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int o = tid + k * kThreads;
      raw[u][k] = (u < n_used && o < G * HD) ? __ldcg(part_acc + (prow0 + u) * G * HD + o) : 0.f;
    }
  float* wm = reinterpret_cast<float*>(ring);  // [n_used][G]: max, then weight
  float* wl = wm + n_used * G;                 // [n_used][G]: sum
  for (int i = tid; i < n_used * G; i += kThreads) {
    wm[i] = __ldcg(part_m + prow0 * G + i);
    wl[i] = __ldcg(part_l + prow0 * G + i);
  }
  __syncthreads();
  float* lg_s = s_s;  // per head: the merged sum
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int c = lane; c < n_used; c += 32) m = fmaxf(m, wm[c * G + g]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n_used; c += 32) {
      const float w = exp2f(wm[c * G + g] - m);
      wm[c * G + g] = w;
      l += wl[c * G + g] * w;
    }
    l = warp_sum(l);
    if (lane == 0) lg_s[g] = l;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kOut; ++k) a[k] = 0.f;
  for (int c0 = 0; c0 < n_used; c0 += kUnroll) {
    if (c0 > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
          const int o = tid + k * kThreads;
          raw[u][k] = (c0 + u < n_used && o < G * HD)
                          ? __ldcg(part_acc + (prow0 + c0 + u) * G * HD + o) : 0.f;
        }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int o = tid + k * kThreads;
        if (c0 + u < n_used && o < G * HD) a[k] = fmaf(raw[u][k], wm[(c0 + u) * G + o / HD], a[k]);
      }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int o = tid + k * kThreads;
    if (o < G * HD) out[out_base + o] = a[k] / lg_s[o / HD];
  }
}

// one call's operands (the scratch already split into its three parts)
struct Args {
  const void *q, *kc, *vc, *tables, *pos;
  void* out;
  float *pm, *pl, *pa;
  int* arrivals;
  int batch, hkv, bs, max_blocks, n_chunks, split, hd;
  float scale;
  bool vec;
  cudaStream_t s;
};

template <typename T, int G, int HD, bool kPadded>
int launch(const Args& a) {
  using C = Cfg<T, G, HD>;
  const int max_pages = (a.split + a.bs - 1) / a.bs + 1;  // pages one chunk can touch
  // the ring, or the merge's two floats per (chunk, head) where more
  const int tail = kRingBytes > a.n_chunks * G * 8 ? kRingBytes : a.n_chunks * G * 8;
  const size_t smem = static_cast<size_t>(head_bytes(G, C::kGP, max_pages)) + G * HD * 4 + tail;
  auto kernel = paged_decode_kernel<T, G, HD, kPadded>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.batch * a.hkv, a.n_chunks);
  kernel<<<grid, kThreads, smem, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.pos),
      static_cast<float*>(a.out), a.pm, a.pl, a.pa, a.arrivals, a.hkv, a.bs, a.max_blocks,
      a.split, a.hd, a.scale * kLog2e, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// an instantiated width runs as it is; a multiple of 8 below 256 runs on the
// next instantiated width up
template <typename T, int G>
int dispatch_hd(const Args& a) {
  switch (a.hd) {
    case 32: return launch<T, G, 32, false>(a);
    case 64: return launch<T, G, 64, false>(a);
    case 128: return launch<T, G, 128, false>(a);
    case 256: return launch<T, G, 256, false>(a);
    default: break;
  }
  if (a.hd <= 0 || a.hd % 8 != 0 || a.hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (a.hd < 32) return launch<T, G, 32, true>(a);
  if (a.hd < 64) return launch<T, G, 64, true>(a);
  if (a.hd < 128) return launch<T, G, 128, true>(a);
  return launch<T, G, 256, true>(a);
}

template <typename T>
int dispatch(int group, const Args& a) {
  switch (group) {
    case 1: return dispatch_hd<T, 1>(a);
    case 2: return dispatch_hd<T, 2>(a);
    case 4: return dispatch_hd<T, 4>(a);
    case 8: return dispatch_hd<T, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, Hkv, G, HDp] fp32, 16-byte aligned, where HDp is hd itself when hd is
// 32, 64, 128 or 256 and else the next of them up (q zero past hd); k/v cache:
// [N, Hkv, bs, hd] of `dtype` (0 = float32, 1 = bfloat16), hd a multiple of 8
// up to 256; tables: [B, max_blocks] int32; pos: [B] int32; out: [B, Hkv, G,
// HDp] fp32. `split` positions per chunk; scratch: fp32,
// B * Hkv * n_chunks * G * (HDp + 2) floats with
// n_chunks = ceil(max_blocks * bs / split); arrivals: B * Hkv int32 counters,
// zero before the call and zero after it, used by no call running at the same
// time. G in {1, 2, 4, 8}, B * Hkv <= 65536. One kernel launch.
extern "C" int rlt_paged_decode(const void* q, const void* kc, const void* vc,
                                const void* tables, const void* pos, void* out,
                                void* scratch, void* arrivals, int batch, int hkv,
                                int group, int hd, int bs, int max_blocks, int split,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (split <= 0 || bs <= 0 || max_blocks <= 0 || static_cast<long>(batch) * hkv > kMaxRows ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || arrivals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (max_blocks * bs + split - 1) / split;
  const long rows = static_cast<long>(batch) * hkv * n_chunks * group;
  Args a;
  a.q = q; a.kc = kc; a.vc = vc; a.tables = tables; a.pos = pos; a.out = out;
  a.pm = static_cast<float*>(scratch);
  a.pl = a.pm + rows;
  a.pa = a.pl + rows;
  a.arrivals = static_cast<int*>(arrivals);
  a.batch = batch; a.hkv = hkv; a.bs = bs; a.max_blocks = max_blocks;
  a.n_chunks = n_chunks; a.split = split; a.hd = hd; a.scale = scale; a.s = s;
  // 16-byte copies need 16-byte-aligned caches (rows are multiples of 16 bytes)
  a.vec = (reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) % 16 == 0;
  if (dtype == 0) return dispatch<float>(group, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(group, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The id of the CUDA-graph capture sequence `stream` is in, 0 when it is not
// capturing: the wrapper gives each capture arrival counters of its own.
extern "C" unsigned long long rlt_paged_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}
