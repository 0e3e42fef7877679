// Bucketed hash probe: an int32 key to its slot in an 8-way table, -1 if
// absent.
//
// Replaces: src/repro/kernels/hash_probe/kernel.py::hash_probe_pallas (body
// _probe_kernel).  For keys i32[N] and a key table i32[n_buckets, 8] (-1 in
// empty ways):
//   b      = ((key mod 2^32) * 2654435761 mod 2^32) >> 16 mod n_buckets
//   out[i] = bkt * 8 + way of the first way holding key[i] in the first of
//            the buckets b, b+1, b+2, b+3 (mod n_buckets) that holds it,
//            else -1.
//
// What bounds it on an H100: bytes.  Each query reads its key and writes its
// slot (8 B); the table is read from L2 (GS: 2,500 buckets x 32 B = 80 KB).
// GS's 1,000,000 queries per run move 8 MB, about 2.4 us at 3.35 TB/s; the
// hash and the compares are a few dozen integer operations per query.
//
// Design.  The TPU kernel split keys into two exact f32 16-bit halves and
// gathered candidate buckets with a one-hot matmul, because the TPU has no
// fast gather inside a kernel.  Here the gather is a plain load, and what
// costs is where it lands: every query reads one random 32-byte bucket,
// which through L1 costs a sector request per query and load.  So where the
// table fits, each block copies it into shared memory once and then walks a
// grid-stride loop over the queries (by default two blocks of 1,024 threads
// a SM, a few queries per thread), with the next query's key loaded before
// this one's probe and the first key in flight while the table is copied.
// A table larger than a block's shared memory is probed through the
// read-only path, one query per thread.  In both, the hash is reduced
// modulo n_buckets once, by a multiply with a precomputed reciprocal (exact
// for every 32-bit value), and each further probe steps to the next bucket
// and wraps with a compare, which holds for any n_buckets >= 1.  The first
// hit ends a probe, which gives the reference's answer: its mask keeps the
// first probe that hits and the first matching way in it.
#include "common.cuh"

namespace {

constexpr int kAssoc = 8;
constexpr int kMaxProbes = 4;
constexpr uint32_t kMult = 2654435761u;
constexpr int kStagedThreads = 1024;  // the staged kernel's default block
constexpr int kStagedBlocksPerSm = 2;
constexpr int kGlobalThreads = 256;   // the unstaged kernel's default block

__device__ inline int first_way(const int4 lo, const int4 hi, int32_t key) {
  if (lo.x == key) return 0;
  if (lo.y == key) return 1;
  if (lo.z == key) return 2;
  if (lo.w == key) return 3;
  if (hi.x == key) return 4;
  if (hi.y == key) return 5;
  if (hi.z == key) return 6;
  if (hi.w == key) return 7;
  return -1;
}

// a mod d for 32-bit a and d >= 1, with M = 2^64 / d rounded up (mod 2^64).
__device__ __forceinline__ uint32_t mod_by(uint32_t a, uint64_t M, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(M * a, d));
}

__device__ __forceinline__ uint32_t home_bucket(int32_t key, uint64_t M,
                                                int n_buckets) {
  return mod_by((static_cast<uint32_t>(key) * kMult) >> 16, M,
                static_cast<uint32_t>(n_buckets));
}

// The slot of `key` in `table` (buckets of two int4, in shared memory or
// read-only global memory), -1 if absent.
__device__ __forceinline__ int32_t probe(const int4* __restrict__ table,
                                         int32_t key, uint64_t M,
                                         int n_buckets) {
  uint32_t b = home_bucket(key, M, n_buckets);
  int way = first_way(table[2 * b], table[2 * b + 1], key);
  for (int p = 1; p < kMaxProbes && way < 0; ++p) {
    if (++b == static_cast<uint32_t>(n_buckets)) b = 0;
    way = first_way(table[2 * b], table[2 * b + 1], key);
  }
  return way >= 0 ? static_cast<int32_t>(b) * kAssoc + way : -1;
}

__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSm)
    hash_probe_staged(const int32_t* __restrict__ keys,
                      const int4* __restrict__ table,
                      int32_t* __restrict__ out, int n, int n_buckets,
                      uint64_t M) {
  extern __shared__ int4 st[];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t key = i < n ? __ldg(keys + i) : 0;
  for (int j = threadIdx.x; j < 2 * n_buckets; j += blockDim.x)
    st[j] = __ldg(table + j);
  __syncthreads();
  for (; i < n; i += stride) {
    const int32_t next = i + stride < n ? __ldg(keys + i + stride) : 0;
    out[i] = probe(st, key, M, n_buckets);
    key = next;
  }
}

__global__ void hash_probe_global(const int32_t* __restrict__ keys,
                                  const int4* __restrict__ table,
                                  int32_t* __restrict__ out, int n,
                                  int n_buckets, uint64_t M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = probe(table, __ldg(keys + i), M, n_buckets);
}

}  // namespace

// keys, out: i32[n]; table: i32[n_buckets, 8], 16-byte aligned; n >= 1.
// `threads` is the block size, 0 for the kernel's default; the staged grid
// has at most kStagedBlocksPerSm x kStagedThreads threads per SM, whatever
// the block size.
// Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int hash_probe(const void* keys, const void* table, void* out,
                            int n, int n_buckets, int threads, void* stream) {
  const uint64_t M =
      ~UINT64_C(0) / static_cast<uint32_t>(n_buckets) + 1;  // 0 for d = 1
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* t = static_cast<const int4*>(table);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = static_cast<size_t>(n_buckets) * kAssoc * sizeof(int32_t);
  if (bytes * kStagedBlocksPerSm <= static_cast<size_t>(optin)) {
    if ((err = set_smem(hash_probe_staged, bytes)) != cudaSuccess)
      return static_cast<int>(err);
    const int nt = threads ? threads : kStagedThreads;
    const int64_t want = (static_cast<int64_t>(n) + nt - 1) / nt;
    const int64_t most =
        static_cast<int64_t>(kStagedBlocksPerSm) * sms * kStagedThreads / nt;
    const int blocks = static_cast<int>(want < most ? want : most);
    hash_probe_staged<<<blocks, nt, bytes, st>>>(k, t, o, n, n_buckets, M);
  } else {
    const int nt = threads ? threads : kGlobalThreads;
    hash_probe_global<<<(n + nt - 1) / nt, nt, 0, st>>>(k, t, o, n,
                                                        n_buckets, M);
  }
  return static_cast<int>(cudaGetLastError());
}
