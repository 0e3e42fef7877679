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
// fast gather inside a kernel.  Here one thread serves one query: it hashes
// in uint32, and reads each probed bucket (32 B, one sector) as two 128-bit
// loads through the read-only path, so L2 serves the table; staging it in
// shared memory per block would copy 80 KB to serve about 1 KB of queries.
// The first hit ends the probe, which gives the reference's answer: its
// mask keeps the first probe that hits and the first matching way in it.
// No padding of the query count: the last block masks its tail.
#include "common.cuh"

namespace {

constexpr int kAssoc = 8;
constexpr int kMaxProbes = 4;
constexpr uint32_t kMult = 2654435761u;

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

__global__ void hash_probe_kernel(const int32_t* __restrict__ keys,
                                  const int4* __restrict__ table,
                                  int32_t* __restrict__ out, int n,
                                  int n_buckets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t key = __ldg(keys + i);
  const uint32_t h = (static_cast<uint32_t>(key) * kMult) >> 16;
  const uint32_t base = h % static_cast<uint32_t>(n_buckets);
  int32_t found = -1;
  for (int p = 0; p < kMaxProbes; ++p) {
    const uint32_t bkt = (base + p) % static_cast<uint32_t>(n_buckets);
    const int4 lo = __ldg(table + 2 * static_cast<int64_t>(bkt));
    const int4 hi = __ldg(table + 2 * static_cast<int64_t>(bkt) + 1);
    const int way = first_way(lo, hi, key);
    if (way >= 0) {
      found = static_cast<int32_t>(bkt) * kAssoc + way;
      break;
    }
  }
  out[i] = found;
}

}  // namespace

// keys, out: i32[n]; table: i32[n_buckets, 8], 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError().
REPRO_EXPORT int hash_probe(const void* keys, const void* table, void* out,
                            int n, int n_buckets, int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  hash_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int4*>(table),
      static_cast<int32_t*>(out), n, n_buckets);
  return static_cast<int>(cudaGetLastError());
}
