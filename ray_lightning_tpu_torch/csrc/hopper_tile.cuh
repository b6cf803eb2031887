// Tile machinery shared by the bf16 flash-attention kernels for Hopper
// (sm_90a): flash_fwd.cu and flash_bwd.cu.
//
//  - Tiles of 64 rows stay bf16 in shared memory, in 64-column panels of
//    128-byte rows whose 16-byte chunks are XOR-swizzled by row (chunk ^
//    (row & 7)): the layout of wgmma's 128-byte swizzle, so an operand is
//    read straight from the tile through a descriptor (K-major, or MN-major
//    with wgmma's transpose flag). Tiles start on 1 KB boundaries.
//  - They arrive by 16-byte cp.async (zero-filled past the rows and columns
//    that hold data), or element by element where the head dim or the
//    alignment forbids whole chunks.
//  - wgmma.mma_async wrappers (m64nNk16, bf16 in, fp32 accumulators in
//    registers), and the conversion of an accumulator into the register A
//    operand of the next product (acc_to_a).
//
// Everything here is internal to the source that includes it.
#pragma once

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // rows of every tile (queries or keys)
constexpr int kWarps = 4;          // warps of a warpgroup, 16 rows each
constexpr int kTC = kWarps * 32;   // threads of a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` (8 bf16 columns) of row `r` in a
// [kTile x kD] tile: 64-column panels of 128-byte rows, chunks XOR-swizzled by
// the row's low three bits
__device__ __forceinline__ uint32_t tile_off(int r, int ch) {
  return ((ch >> 3) * kTile + r) * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + kTile) of a [seq, hd] bf16 slab into a tile, by the block's
// kThreads threads; rows past seq and columns past hd (up to kD) are zero.
// `vec`: hd % 8 == 0 and the slab is 16-byte aligned, so every chunk is one
// 16-byte cp.async; otherwise the chunks are assembled element by element
// (synchronous stores).
template <int kD, int kThreads = kTC>
__device__ __forceinline__ void load_tile_bf16(unsigned char* tile, const bf16* __restrict__ src,
                                               int r0, int seq, int hd, bool vec) {
  constexpr int kChunks = kD / 8;
  const uint32_t base = smem_addr(tile);
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const int g = r0 + r;
    const int c = ch * 8;
    const uint32_t off = tile_off(r, ch);
    if (vec) {
      const bool in = g < seq && c < hd;
      cp_async16(base + off, in ? src + static_cast<long>(g) * hd + c : src, in ? 16 : 0);
    } else {
      __align__(16) bf16 w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        w[e] = (g < seq && c + e < hd) ? src[static_cast<long>(g) * hd + c + e]
                                       : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(tile + off) = *reinterpret_cast<const uint4*>(w);
    }
  }
}

// rows [r0, r0 + kTile) of a [seq, kD] bf16 slab, all of them below seq
// and 16-byte aligned, into a tile by the block's kThreads threads: each
// thread copies one 16-byte chunk column of rows threadIdx.x / kChunks +
// j * kRowStep, so its shared-memory offsets and its source addresses step
// by constants and each chunk costs one cp.async
template <int kD, int kThreads>
__device__ __forceinline__ void load_full_tile_bf16(unsigned char* tile, const bf16* __restrict__ src,
                                                    int r0) {
  constexpr int kChunks = kD / 8;
  constexpr int kRowStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && kTile % kRowStep == 0 && kRowStep % 8 == 0,
                "rows j * kRowStep apart share their swizzle");
  const int r = threadIdx.x / kChunks;
  const int ch = threadIdx.x % kChunks;
  const uint32_t dst = smem_addr(tile) + tile_off(r, ch);
  const bf16* s = src + static_cast<long>(r0 + r) * kD + ch * 8;
#pragma unroll
  for (int j = 0; j < kTile / kRowStep; ++j) {
    cp_async16(dst + j * kRowStep * 128, s + j * kRowStep * kD);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand (the k index runs along a tile row): rows r0.. of the
// tile, k16 step kk. Eight-row groups lie 1024 bytes apart; a k16 step is
// 32 bytes inside a 128-byte row, four steps per panel.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return gmma_desc(tile + ((kk >> 2) * kTile + r0) * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (the n index runs along a tile row; wgmma's transpose
// flag): tile rows k0..k0+15 are the k index, the 64 columns of panel p the n
// index. Eight-row k groups lie 1024 bytes apart (stride offset); the next
// 64 columns would be a panel away (leading offset).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k0, int p) {
  return gmma_desc(tile + (p * kTile + k0) * 128, kTile * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed wgmma groups are
// pending (they complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define RLT_D8(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), \
                  "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d[64 x 32] += A[64 x 16] B[16 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : RLT_D8(0), RLT_D8(8)
      : "l"(da), "l"(db), "r"(1));
}
// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// `accumulate` 0 overwrites d (no instruction has to zero it first)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RLT_D8(0), RLT_D8(8), RLT_D8(16), RLT_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (each warp's 16 rows
// as an m16n8k16 A fragment), B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RLT_D8(0), RLT_D8(8), RLT_D8(16), RLT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RLT_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of k16 step kc from an accumulator whose n8 tile j sits in
// r[4j .. 4j + 3] (rows g and g + 8, columns 2t and 2t + 1): n8 tiles 2kc and
// 2kc + 1 rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&r)[N], int kc, uint32_t (&a)[4]) {
  a[0] = pack_bf16(r[8 * kc + 0], r[8 * kc + 1]);
  a[1] = pack_bf16(r[8 * kc + 2], r[8 * kc + 3]);
  a[2] = pack_bf16(r[8 * kc + 4], r[8 * kc + 5]);
  a[3] = pack_bf16(r[8 * kc + 6], r[8 * kc + 7]);
}

// keep (row, col) under the TPU's mask (col < seq is checked by the caller
// where it matters)
__device__ __forceinline__ bool keep_pair(int row, int col, int seq, int causal,
                                          int window) {
  if (col >= seq) return false;
  if (!causal) return true;
  if (window > 0) return row >= col && row - col < window;
  return row >= col;
}

// the dynamic shared memory from its first 1024-byte boundary: the 128-byte
// swizzle repeats every 1024 bytes of address, so tiles start on one (the
// launch asks for 1 KB more)
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// wait for this thread's copies up to the newest `N` groups, make them (and
// any plain stores) visible to wgmma's reads, then to the whole block
template <int N>
__device__ __forceinline__ void tiles_arrived() {
  cp_async_wait<N>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ------------------------------------------------------------------------ //
// launch helpers
// ------------------------------------------------------------------------ //
template <typename Kernel>
int raise_smem_limit(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// every bf16 slab 16-byte aligned with rows of whole 16-byte chunks
inline bool vec_ok(int hd, std::initializer_list<const void*> ptrs) {
  if (hd % 8 != 0) return false;
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

}  // namespace
