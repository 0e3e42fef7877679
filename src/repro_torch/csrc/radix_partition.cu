// Stable within-bucket rank and key histogram, one batch row per block.
//
// Replaces: src/repro/kernels/radix_partition/kernel.py::radix_partition_pallas
// (body _radix_rank_kernel).  For keys i32[BN, R] in [0, K):
//   rank[b, i]   = number of rows j < i of row b with keys[b, j] == keys[b, i]
//   counts[b, k] = number of rows of row b with key k
//
// What bounds it on an H100: bytes.  It reads the keys once and writes the
// ranks and the histograms once (GS at 200 x 5000 rows, K = 10,001: 16 MB,
// about 5 us at 3.35 TB/s).  The work per row is a few integer operations.
//
// Design.  The TPU kernel carried an f32 one-hot cumsum across a sequential
// grid, which bounds it to K <= 2048 buckets and ranks below 2^24.  Here a
// block owns one batch row and keeps an int32 histogram of all K buckets in
// shared memory (40 KB for GS; the opt-in limit of 227 KB bounds K near
// 54,000), so neither bound exists.  The row's keys are staged through shared
// memory in chunks with coalesced loads by the whole block.  One warp then
// ranks each chunk in order, 32 rows at a time: __match_any_sync groups the
// lanes with equal keys, a lane's rank is the bucket's running count plus the
// number of lower lanes in its group, and the group's highest lane adds the
// group size to the bucket.  That keeps the carry across tiles a loop inside
// the block, in order, instead of the TPU's sequential grid.  The ranks go
// back through shared memory and out with coalesced stores; the block writes
// its histogram last.  Keys outside [0, K) are not counted and get rank -1
// (the wrapper's callers never pass them).
#include "common.cuh"

namespace {

constexpr int kChunk = 4096;  // keys staged in shared memory per pass

__global__ void radix_rank_kernel(const int32_t* __restrict__ keys,
                                  int32_t* __restrict__ rank,
                                  int32_t* __restrict__ counts, int rows,
                                  int n_buckets) {
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;               // [n_buckets]
  int32_t* stage = smem + n_buckets;  // [kChunk]: keys in, ranks out
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;

  for (int k = threadIdx.x; k < n_buckets; k += blockDim.x) hist[k] = 0;
  __syncthreads();

  for (int base = 0; base < rows; base += kChunk) {
    const int m = min(kChunk, rows - base);
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      stage[i] = keys[row0 + base + i];
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const unsigned lower = (1u << lane) - 1u;
      for (int j = 0; j < m; j += 32) {
        const int i = j + lane;
        const bool live = i < m;
        int key = live ? stage[i] : 0;
        const bool counted =
            live && static_cast<unsigned>(key) < static_cast<unsigned>(n_buckets);
        if (!counted) key = -1 - lane;  // a private group of one
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const int before = counted ? hist[key] : 0;
        __syncwarp();
        if (counted && lane == 31 - __clz(peers))
          hist[key] = before + __popc(peers);
        __syncwarp();
        if (live) stage[i] = counted ? before + __popc(peers & lower) : -1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      rank[row0 + base + i] = stage[i];
    __syncthreads();
  }

  int32_t* out = counts + static_cast<int64_t>(blockIdx.x) * n_buckets;
  for (int k = threadIdx.x; k < n_buckets; k += blockDim.x) out[k] = hist[k];
}

}  // namespace

// Shared memory one block needs for K buckets.
REPRO_EXPORT int radix_partition_smem_bytes(int n_buckets) {
  return (n_buckets + kChunk) * static_cast<int>(sizeof(int32_t));
}

// keys, rank: i32[bn, rows]; counts: i32[bn, n_buckets].  Launches on
// `stream` and returns cudaGetLastError().
REPRO_EXPORT int radix_partition_rank(const void* keys, void* rank,
                                      void* counts, int bn, int rows,
                                      int n_buckets, int threads,
                                      void* stream) {
  const size_t smem = static_cast<size_t>(radix_partition_smem_bytes(n_buckets));
  cudaError_t err = set_smem(radix_rank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_rank_kernel<<<bn, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(counts), rows, n_buckets);
  return static_cast<int>(cudaGetLastError());
}
