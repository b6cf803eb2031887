// Blockwise argmax over the vocabulary, greedy and noisy, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of ray_lightning_tpu/ops/paged_attention.py
// (_argmax_kernel / _noisy_argmax_kernel, pallas_call at line 272 in
// _blockwise_argmax): out[b] = argmax_v (x[b, v] + noise[b, v]) in fp32, one
// add per element, the noise operand being optional. The answer is the
// documented one, jnp.argmax's and torch.argmax's: ties keep the FIRST
// maximum (+0.0 and -0.0 tie), a row of all -inf gives 0, and a row that
// holds a NaN gives the index of its first NaN. (The Pallas kernel skips
// every vocabulary block whose maximum is NaN, since `NaN > m` is false; the
// port does not copy that.)
//
// Bound on the H100: bytes. Each logit (and noise value) is read once, a few
// instructions per element; [8, 128256] fp32 is 4.1 MB, 1.23 us at 3.35
// TB/s, 2.45 us with the noise. At that size a call is mostly the launch and
// one round trip to memory, so the design keeps what follows the loads short.
//
// Design:
// - Every SM reads. A row is split into `chunks` consecutive stretches of
//   `chunk` elements (a multiple of 4), one block of 256 threads each; the
//   wrapper picks both (chunks 1-8) from the batch and vocabulary so that
//   B * chunks fills the SMs at most twice over (8 at B = 8: 64 blocks; 16
//   measured no faster, and past 8 a cluster is non-portable).
// - 16-byte loads, all in flight at once: each thread issues up to 8 float4
//   loads of x (and 8 of the noise) before it looks at any, so a block asks
//   for up to 32 KB (64 KB with noise) in one round trip. A chunk starts on
//   a 16-byte boundary when the row does; the launch takes the element path
//   (4-byte loads, 8 in flight) when the vocabulary is no multiple of 4 or a
//   pointer is not 16-byte aligned.
// - One merge rule, order-free, at every level: a NaN beats any number; two
//   NaNs, or two equal numbers (+0.0 and -0.0 included), go to the lower
//   index; otherwise the larger value wins. It is carried as a 32-bit key
//   that orders the values (key_of: NaN above +inf, -0.0 equal to +0.0, 0
//   for "nothing seen", below -inf) beside the index: the larger key wins,
//   equal keys go to the lower index. That is the maximum under a total
//   order of (key, index) pairs, hence associative and commutative: any
//   reduction tree gives the same answer.
//   - In a thread, over the up to 32 values it holds in registers: first the
//     NaN-propagating maximum m (max.NaN, a tree), then the first index
//     whose value equals m or is a NaN (if m is a number, no value is a
//     NaN; if m is NaN, only NaNs are hits). Four instructions a value, no
//     dependent chain through a running pair.
//   - In a warp: two redux.sync, the maximum key, then the least index
//     among the lanes that hold it; the same for the block's 8 warps.
// - The merge across a row's blocks is in the same launch, through a
//   thread-block cluster per row: a 1-D grid of rows * chunks blocks, the
//   cluster dimension chunks, so block b is chunk b % chunks of row
//   b / chunks. Each block writes its pair into the shared memory of the
//   cluster's block 0 (distributed shared memory) at its own rank's slot,
//   the cluster synchronises, and block 0 merges the slots and writes
//   out[row]. A block may write into block 0 only once
//   every block of the cluster has started: each arrives on the cluster
//   barrier as it starts and waits on it only after its loads, so that
//   barrier costs nothing on the path. Nothing lives between calls: no
//   counters, no memset, so a call replays in a CUDA graph and two streams
//   may call it at once.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;       // loads of x a thread keeps in flight
constexpr int kMaxChunks = 8;    // Hopper's largest portable cluster

// the order of values as an unsigned key: NaN above +inf, -0.0 equal to
// +0.0 (v + 0.0f turns -0.0 into +0.0), -inf at 0x007fffff; 0 is "nothing"
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return isnan(v) ? 0xffffffffu : k;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Folds N values held in registers into the thread's (key, index) pair.
// at[k] is value k's index, ascending in k, or -1 where the slot is past
// the chunk (its value is then -inf and is never taken). The values come
// after every value folded before, so an equal key keeps the earlier pair.
template <int N>
__device__ __forceinline__ void fold(const float (&v)[N], const int (&at)[N],
                                     unsigned& key, int& idx) {
  float t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = v[k];
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int k = 0; k + s < N; k += 2 * s) t[k] = max_nan(t[k], t[k + s]);
  const float m = t[0];
  int first = INT_MAX;
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if (at[k] >= 0 && (v[k] == m || isnan(v[k]))) first = at[k];
  }
  const unsigned mk = first == INT_MAX ? 0u : key_of(m);
  if (mk > key) {
    key = mk;
    idx = first;
  }
}

// the warp's pair in every lane: the largest key, then the least index
// among the lanes that hold it
__device__ __forceinline__ void warp_reduce(unsigned& key, int& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == top ? idx : INT_MAX);
  key = top;
}

// the cluster barrier in two halves: arrive.relaxed orders nothing (it
// only says the block has started), the default arrive releases this
// thread's writes and the default wait acquires the others'
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

template <bool kVec, bool kNoise>
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ x, const float* __restrict__ noise,
              int* __restrict__ out, int vocab, int chunks, int chunk) {
  cluster_arrive_relaxed();  // this block has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) % chunks;  // a cluster is a row
  const long row = blockIdx.x / chunks;
  const float* xr = x + row * vocab;
  const float* nr = kNoise ? noise + row * vocab : nullptr;
  const int lo = rank * chunk;
  const int hi = min(vocab, lo + chunk);

  unsigned key = 0u;  // nothing seen yet: loses to every element
  int idx = INT_MAX;
  if constexpr (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* n4 = reinterpret_cast<const float4*>(nr);
    const int hi4 = hi >> 2;  // vocab % 4 == 0 on this path
    for (int base = (lo >> 2) + threadIdx.x; base < hi4;
         base += kThreads * kUnroll) {
      float4 a[kUnroll];
      float4 b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        a[u] = j < hi4 ? __ldg(x4 + j)
                       : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if constexpr (kNoise) b[u] = j < hi4 ? __ldg(n4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float v[4 * kUnroll];
      int at[4 * kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        float4 w = a[u];
        if constexpr (kNoise) {
          w.x += b[u].x;
          w.y += b[u].y;
          w.z += b[u].z;
          w.w += b[u].w;
        }
        v[4 * u] = w.x;
        v[4 * u + 1] = w.y;
        v[4 * u + 2] = w.z;
        v[4 * u + 3] = w.w;
#pragma unroll
        for (int c = 0; c < 4; ++c) at[4 * u + c] = j < hi4 ? 4 * j + c : -1;
      }
      fold(v, at, key, idx);
    }
  } else {
    for (int base = lo + threadIdx.x; base < hi; base += kThreads * kUnroll) {
      float v[kUnroll];
      int at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        at[u] = j < hi ? j : -1;
        v[u] = j < hi ? __ldg(xr + j) : -INFINITY;
        if constexpr (kNoise) v[u] += j < hi ? __ldg(nr + j) : 0.f;
      }
      fold(v, at, key, idx);
    }
  }

  // the block's pair: each warp's, then the warps' in warp 0
  __shared__ unsigned warp_k[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ unsigned chunk_k[kMaxChunks];  // used in the cluster's block 0
  __shared__ int chunk_i[kMaxChunks];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(key, idx);
  if (lane == 0) {
    warp_k[warp] = key;
    warp_i[warp] = idx;
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (warp == 0) {
    key = lane < kWarps ? warp_k[lane] : 0u;
    idx = lane < kWarps ? warp_i[lane] : INT_MAX;
    warp_reduce(key, idx);
    if (lane == 0) {  // into block 0's slot for this rank
      *cluster.map_shared_rank(&chunk_k[rank], 0) = key;
      *cluster.map_shared_rank(&chunk_i[rank], 0) = idx;
    }
  }
  // release of the slot writes, acquire in block 0; no block touches
  // another's shared memory after this barrier, so every block may exit
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && warp == 0) {
    key = lane < chunks ? chunk_k[lane] : 0u;
    idx = lane < chunks ? chunk_i[lane] : INT_MAX;
    warp_reduce(key, idx);
    if (lane == 0) out[row] = idx;
  }
}

using Kernel = void (*)(const float*, const float*, int*, int, int, int);

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x, noise: [rows, vocab] fp32 (noise may be null); out: [rows] int32;
// chunks: blocks (and cluster size) per row, 1-8, and chunk: elements per
// block, a multiple of 4 with chunks * chunk >= vocab, both from the
// wrapper's plan (ops/paged_attention.py::argmax_plan).
extern "C" int rlt_argmax(const void* x, const void* noise, void* out,
                          int rows, int vocab, int chunks, int chunk,
                          void* stream) {
  if (rows < 1 || vocab < 1 || chunks < 1 || chunks > kMaxChunks ||
      chunk < 4 || chunk % 4 != 0 ||
      static_cast<long long>(chunks) * chunk < vocab ||
      static_cast<long long>(chunks) * chunk > INT_MAX - kThreads * kUnroll ||
      static_cast<long long>(rows) * chunks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = vocab % 4 == 0 && aligned16(x) &&
                   (noise == nullptr || aligned16(noise));
  const Kernel kernel =
      vec ? (noise != nullptr ? &argmax_kernel<true, true> : &argmax_kernel<true, false>)
          : (noise != nullptr ? &argmax_kernel<false, true> : &argmax_kernel<false, false>);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(chunks);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                                       static_cast<const float*>(noise),
                                       static_cast<int*>(out), vocab, chunks, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
