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
// byte at G = 4: two orders of magnitude below the compute line. At 8 rows,
// 8 KV heads, ~1000 positions, hd 128, bf16 that is ~33 MB, ~10 us at
// 3.35 TB/s.
//
// Design. The TPU grid walked a row's blocks in sequential grid steps with
// the table and positions as scalar-prefetch operands; on the card a
// sequential walk per (row, KV head) leaves most SMs idle (8 x 8 = 64
// blocks) and serialises the loads. So the positions of a row are split
// into chunks of `split` positions (the wrapper passes 64), one block of 4
// warps per (row, KV head, chunk)
// (flash-decoding), and a second small kernel merges the chunks' partial
// softmax states. Inside a block each warp takes every 4th position: the 32
// lanes read one key row and one value row (hd contiguous values, coalesced)
// through the block table, hold hd / 32 columns each, and keep the online
// softmax state (max, sum, accumulator) of all G query heads in registers,
// so the G heads of the group share every key and value read and the loop
// has no block-wide barrier. Each block loads its own pos[b] and table row:
// positions past pos (and table entries past pos // bs, trash-padded) are
// never read, chunks past pos exit at once, and a free slot (pos 0, a trash
// row) reads one position. Masking is by loop bound, so no -inf enters the
// softmax. The group is not padded to 8 rows as on the TPU.
#include <cmath>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// grid: (B * Hkv, max_chunks), `split` positions per chunk. Writes the
// chunk's partial softmax state: part_m / part_l [B*Hkv, max_chunks, G],
// part_acc [B*Hkv, max_chunks, G, hd].
template <typename T, int G, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos, float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, int hkv, int bs,
                          int max_blocks, int split, float scale) {
  constexpr int HD = DPL * 32;
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int chunk = blockIdx.y;
  const int p_last = pos[b];
  const int start = chunk * split;
  if (start > p_last) return;  // past the row's position: nothing to read
  const int end = min(start + split, p_last + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* row_table = tables + static_cast<long>(b) * max_blocks;

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      qr[g][i] = q[(static_cast<long>(bh) * G + g) * HD + lane * DPL + i] * scale;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int p = start + warp; p < end; p += kWarps) {
    const long blk = row_table[p / bs];
    const long base = ((blk * hkv + h) * bs + (p % bs)) * HD + lane * DPL;
    float kf[DPL], vf[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kf[i] = to_f<T>(kc[base + i]);
      vf[i] = to_f<T>(vc[base + i]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qr[g][i] * kf[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float pr = expf(s - m_new);
      l[g] = l[g] * alpha + pr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + pr * vf[i];
      m[g] = m_new;
    }
  }

  // merge the warps' states through shared memory
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  const long out_row = static_cast<long>(bh) * gridDim.y + chunk;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no position has m = -inf and weighs exp(-inf) = 0
      const float wgt = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * wgt;
      a += sm_acc[w][g][d] * wgt;
    }
    part_acc[(out_row * G + g) * HD + d] = a;
    if (d == 0) {
      part_m[out_row * G + g] = mx;
      part_l[out_row * G + g] = lsum;
    }
  }
}

// grid: B * Hkv. Merges the chunks a row used into out [B, Hkv, G, hd].
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const int* __restrict__ pos,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          float* __restrict__ out, int hkv, int group, int hd,
                          int max_chunks, int split) {
  const int bh = blockIdx.x;
  const int n_chunks = pos[bh / hkv] / split + 1;
  const long row = static_cast<long>(bh) * max_chunks;
  for (int i = threadIdx.x; i < group * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float mx = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, part_m[(row + c) * group + g]);
    float lsum = 0.f, a = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float wgt = expf(part_m[(row + c) * group + g] - mx);
      lsum += part_l[(row + c) * group + g] * wgt;
      a += part_acc[((row + c) * group + g) * hd + d] * wgt;
    }
    out[(static_cast<long>(bh) * group + g) * hd + d] = a / lsum;
  }
}

template <typename T, int G, int DPL>
void launch_split(const void* q, const void* kc, const void* vc,
                  const void* tables, const void* pos, float* part_m,
                  float* part_l, float* part_acc, int batch, int hkv, int bs,
                  int max_blocks, int max_chunks, int split, float scale,
                  cudaStream_t s) {
  const dim3 grid(batch * hkv, max_chunks);
  paged_decode_split_kernel<T, G, DPL><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(tables),
      static_cast<const int*>(pos), part_m, part_l, part_acc, hkv, bs,
      max_blocks, split, scale);
}

template <typename T, int G>
bool dispatch_hd(int hd, const void* q, const void* kc, const void* vc,
                 const void* tables, const void* pos, float* pm, float* pl,
                 float* pa, int batch, int hkv, int bs, int max_blocks,
                 int max_chunks, int split, float scale, cudaStream_t s) {
  switch (hd) {
    case 32: launch_split<T, G, 1>(q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s); return true;
    case 64: launch_split<T, G, 2>(q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s); return true;
    case 128: launch_split<T, G, 4>(q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s); return true;
    case 256: launch_split<T, G, 8>(q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s); return true;
    default: return false;
  }
}

template <typename T>
bool dispatch(int group, int hd, const void* q, const void* kc, const void* vc,
              const void* tables, const void* pos, float* pm, float* pl,
              float* pa, int batch, int hkv, int bs, int max_blocks,
              int max_chunks, int split, float scale, cudaStream_t s) {
  switch (group) {
    case 1: return dispatch_hd<T, 1>(hd, q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s);
    case 2: return dispatch_hd<T, 2>(hd, q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s);
    case 4: return dispatch_hd<T, 4>(hd, q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s);
    case 8: return dispatch_hd<T, 8>(hd, q, kc, vc, tables, pos, pm, pl, pa, batch, hkv, bs, max_blocks, max_chunks, split, scale, s);
    default: return false;
  }
}

}  // namespace

// q: [B, Hkv, G, hd] fp32; k/v cache: [N, Hkv, bs, hd] of `dtype`
// (0 = float32, 1 = bfloat16); tables: [B, max_blocks] int32; pos: [B] int32;
// out: [B, Hkv, G, hd] fp32. `split` positions per chunk; scratch: fp32,
// B * Hkv * max_chunks * G * (hd + 2) floats with
// max_chunks = ceil(max_blocks * bs / split). G in {1, 2, 4, 8}, hd in
// {32, 64, 128, 256}.
extern "C" int rlt_paged_decode(const void* q, const void* kc, const void* vc,
                                const void* tables, const void* pos, void* out,
                                void* scratch, int batch, int hkv, int group,
                                int hd, int bs, int max_blocks, int split,
                                float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int max_chunks = (max_blocks * bs + split - 1) / split;
  const long rows = static_cast<long>(batch) * hkv * max_chunks * group;
  float* pm = static_cast<float*>(scratch);
  float* pl = pm + rows;
  float* pa = pl + rows;
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch<float>(group, hd, q, kc, vc, tables, pos, pm, pl, pa, batch,
                         hkv, bs, max_blocks, max_chunks, split, scale, s);
  } else if (dtype == 1) {
    ok = dispatch<__nv_bfloat16>(group, hd, q, kc, vc, tables, pos, pm, pl, pa,
                                 batch, hkv, bs, max_blocks, max_chunks, split, scale, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_decode_merge_kernel<<<batch * hkv, kThreads, 0, s>>>(
      static_cast<const int*>(pos), pm, pl, pa, static_cast<float*>(out), hkv,
      group, hd, max_chunks, split);
  return static_cast<int>(cudaGetLastError());
}
