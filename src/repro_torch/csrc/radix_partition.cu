// Stable within-bucket rank and key histogram of every batch row.
//
// Replaces: src/repro/kernels/radix_partition/kernel.py::radix_partition_pallas
// (body _radix_rank_kernel).  For keys i32[BN, R] in [0, K):
//   rank[b, i]   = number of rows j < i of row b with keys[b, j] == keys[b, i]
//   counts[b, k] = number of rows of row b with key k
//
// What bounds it on an H100: bytes.  It reads the keys once and writes the
// ranks and the histograms once (GS at 200 x 5000 rows, K = 10,001: 16 MB,
// about 5 us at 3.35 TB/s).  The work per row is a few dozen integer
// operations on shared memory.
//
// Design.  The TPU kernel carried an f32 one-hot cumsum across a sequential
// grid, which bounds it to K <= 2048 buckets and ranks below 2^24.  Here
// every warp of a block ranks, and the shape picks one of three paths that
// give the same bits:
//
//   - Many short rows over a small key space (at least 4 rows per SM, rows
//     and K at most 4,096: the sharded exchange and restructure): a warp
//     ranks a row of its own, 32 keys a step, lanes of equal keys found by
//     __match_any_sync, the row's histogram in shared memory (at most 16 KB
//     a warp).  No barrier; the rows spread over every SM.
//   - A key space of at most 5 bits (K <= 31) otherwise: one count of the
//     whole key, as in step 1 below, already gives every row its rank among
//     equal keys and every key its count (radix_rank_one_pass).
//   - Otherwise a block owns one batch row and ranks it in chunks of up to
//     threads x 8 rows, in order, with nothing in shared memory that grows
//     with K:
//
//   1. A stable LSD radix sort of the chunk's (key, position) pairs in
//      shared memory: ceil(b / 6) passes of equal digits of at most 6 bits,
//      b the bit length of K.  Each thread owns a run of consecutive rows of
//      the chunk ("blocked" order) and counts their digits serially in its
//      own column of packed 16-bit counters (two digits a word, no atomics,
//      no ballots), remembering each row's count before it.  One block-wide
//      exclusive scan of the counter words in (digit, thread) order then
//      places every row after the equal digits of the earlier threads and
//      its own earlier rows: the order of the previous pass is kept.
//   2. The sorted chunk falls into runs of equal keys.  A row's run start
//      is the last run head at or before it: a ballot of the heads in its
//      warp, else the last head of the earlier warps.  Its rank is its
//      distance from the run start plus the key's count in the chunks
//      before this one.
//   3. That count lives in the row's `counts` output in global memory (L2),
//      not in shared memory: the block zeroes its row of counts first; in
//      each chunk the head of a run reads its key's count and the tail of
//      the run writes the new count.  A chunk holds one run per key, so no
//      two threads touch a key at once; barriers order the chunks.
//   4. The ranks go back through shared memory and out with coalesced
//      stores; the keys come in the same way, staged in shared memory.
//
// Shared arrays are padded by one word in 32, so that threads reading
// consecutive runs of rows or counters hit distinct banks.  The chunk's
// layout, not the block size, fixes every result, so any block size gives
// the same bits.  Keys outside [0, K) sort after the rest, are not counted
// and get rank -1 (the wrapper's callers never pass them).
#include "common.cuh"

namespace {

constexpr int kItems = 8;         // rows per thread in a chunk, at most
constexpr int kMaxDigitBits = 6;  // 64 digits: 32 packed counters a thread
constexpr int kOnePassBits = 5;   // key spaces ranked straight from counters
constexpr int kWarpRowBuckets = 4096;  // a warp's histogram, at most
constexpr int kWarpRowRows = 4096;     // a warp's row, at most
constexpr int kWarpRowsPerBlock = 4;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A shared-array index with one word of padding every 32 words.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int padded(int n) { return n + (n >> 5) + 1; }

// p[0, n) = 0 by the whole block, 16 bytes a store where aligned.
__device__ void zero_row(int32_t* p, int n) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int head = min(n, static_cast<int>(
                              (16 - (reinterpret_cast<uintptr_t>(p) & 15)) &
                              15) / 4);
  for (int i = tid; i < head; i += nt) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int nv = (n - head) / 4;
  for (int i = tid; i < nv; i += nt) q[i] = make_int4(0, 0, 0, 0);
  for (int i = head + 4 * nv + tid; i < n; i += nt) p[i] = 0;
}

// Counts this thread's rows' DB-bit digits (key >> shift) in its column of
// packed counters ctr[kLanes][nt], then scans them block-wide in (digit,
// thread) order; ends with a barrier.  Returns nothing: afterwards the word
// of (digit d, thread t) holds, in the half 16 * (d / kLanes), the number
// of rows of smaller digits plus those of digit d in threads before t, and
// pref[i] (bits 16-31 of tag[i]) the rows of digit d among this thread's
// earlier rows.
template <int DB>
__device__ __forceinline__ void count_digits(const uint32_t* key,
                                             int32_t* tag, int n_rows,
                                             int shift, uint32_t* ctr,
                                             int32_t* wtot) {
  constexpr int kLanes = (1 << DB) / 2;
  const int nt = blockDim.x, nw = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // pad(l * nt + tid) = l * (nt + nw) + tid + w, as nt is a multiple of 32
  uint32_t* col = ctr + tid + w;
  const int stride = nt + nw;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) col[l * stride] = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < n_rows) {
      const unsigned d = (key[i] >> shift) & ((1u << DB) - 1);
      const unsigned half = 16 * (d / kLanes);
      uint32_t* c = col + (d % kLanes) * stride;
      const uint32_t old = *c;
      tag[i] |= static_cast<int32_t>(((old >> half) & 0xffffu) << 16);
      *c = old + (1u << half);
    }
  }
  __syncthreads();
  // each thread rakes kLanes consecutive words; the high halves (the upper
  // digits) then follow all the low halves
  uint32_t* rk = ctr + pad(tid * kLanes);  // no pad falls inside the run
  uint32_t sum = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) sum += rk[l];
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wtot[w] = static_cast<int32_t>(incl);
  __syncthreads();
  uint32_t all = lane < nw ? static_cast<uint32_t>(wtot[lane]) : 0u;
  uint32_t before = lane < w ? all : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    all += __shfl_xor_sync(0xffffffffu, all, o);
    before += __shfl_xor_sync(0xffffffffu, before, o);
  }
  uint32_t run = before + incl - sum + ((all & 0xffffu) << 16);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const uint32_t c = rk[l];
    rk[l] = run;
    run += c;
  }
  __syncthreads();
}

// The half-word of ctr holding digit d's count for thread t.
template <int DB>
__device__ __forceinline__ int digit_count(const uint32_t* ctr, unsigned d,
                                           int t) {
  constexpr int kLanes = (1 << DB) / 2;
  const int nt = blockDim.x;  // pad(l * nt + t), as in count_digits
  return static_cast<int>(
      (ctr[(d % kLanes) * (nt + (nt >> 5)) + t + (t >> 5)] >>
       (16 * (d / kLanes))) &
      0xffffu);
}

// Key spaces of at most kOnePassBits bits: the digit is the whole key, so a
// row's rank is its place among its digit's rows, read straight from the
// scanned counters, and the counts are the digit totals (kept per key in
// shared memory across chunks; 2^DB <= 32 words).  No sort, no runs.
template <int DB>
__global__ void __launch_bounds__(kMaxThreads)
    radix_rank_one_pass(const int32_t* __restrict__ keys,
                        int32_t* __restrict__ rank,
                        int32_t* __restrict__ counts, int rows,
                        int n_buckets, int chunk) {
  constexpr int kBins = 1 << DB;
  constexpr int kLanes = kBins / 2;
  extern __shared__ uint32_t smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  uint32_t* skey = smem;                      // [chunk] keys in, ranks out
  uint32_t* ctr = smem + padded(chunk);       // [kLanes][nt] counters
  int32_t* wtot = reinterpret_cast<int32_t*>(ctr + padded(kLanes * nt));
  int32_t* carry = wtot + 32;                 // [kBins] earlier chunks' counts
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const uint32_t dead = static_cast<uint32_t>(n_buckets);
  for (int d = tid; d < kBins; d += nt) carry[d] = 0;

  uint32_t key[kItems];
  int32_t tag[kItems];
  for (int base = 0; base < rows; base += chunk) {
    const int m = min(chunk, rows - base);
    const int per = (m + nt - 1) / nt;
    const int s0 = tid * per;
    const int n_own = max(0, min(per, m - s0));
    __syncthreads();  // the last chunk's ranks and carries are done
    for (int i = tid; i < m; i += nt) {
      const int32_t k = keys[row0 + base + i];
      skey[pad(i)] = static_cast<uint32_t>(k) < dead
                         ? static_cast<uint32_t>(k) : dead;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < n_own) key[i] = skey[pad(s0 + i)];
      tag[i] = 0;
    }
    count_digits<DB>(key, tag, n_own, 0, ctr, wtot);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < n_own) {
        const unsigned d = key[i];
        const int rk = digit_count<DB>(ctr, d, tid) - digit_count<DB>(ctr, d, 0) +
                       (tag[i] >> 16) + carry[d];
        skey[pad(s0 + i)] = d == dead ? 0xffffffffu : static_cast<uint32_t>(rk);
      }
    }
    __syncthreads();
    for (int d = tid; d < kBins; d += nt) {  // this chunk's digit totals
      const int next = d + 1 < kBins ? digit_count<DB>(ctr, d + 1, 0) : m;
      carry[d] += next - digit_count<DB>(ctr, d, 0);
    }
    for (int i = tid; i < m; i += nt)
      rank[row0 + base + i] = static_cast<int32_t>(skey[pad(i)]);
  }
  int32_t* cnt = counts + static_cast<int64_t>(blockIdx.x) * n_buckets;
  for (int d = tid; d < n_buckets; d += nt) cnt[d] = carry[d];
}

// Built twice, by the largest block it takes: 1,024 threads, or 640 with
// the registers that two blocks a SM leave.
template <int DB, int kBlock>
__global__ void __launch_bounds__(kBlock, kBlock == 1024 ? 1 : 2)
    radix_rank_kernel(const int32_t* __restrict__ keys,
                      int32_t* __restrict__ rank, int32_t* __restrict__ counts,
                      int rows, int n_buckets, int passes, int chunk) {
  constexpr int kLanes = (1 << DB) / 2;  // counter words per thread
  extern __shared__ uint32_t smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  uint32_t* skey = smem;                          // [chunk] sort keys, ranks
  int32_t* spos = reinterpret_cast<int32_t*>(smem + padded(chunk));
  uint32_t* ctr = smem + 2 * padded(chunk);       // [kLanes][nt] counters
  int32_t* wtot = reinterpret_cast<int32_t*>(ctr + padded(kLanes * nt));
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  int32_t* cnt = counts + static_cast<int64_t>(blockIdx.x) * n_buckets;
  const uint32_t dead = static_cast<uint32_t>(n_buckets);  // key outside [0, K)

  zero_row(cnt, n_buckets);  // ordered before any count by the barriers below

  uint32_t key[kItems];
  int32_t pos[kItems], rs[kItems];
  for (int base = 0; base < rows; base += chunk) {
    const int m = min(chunk, rows - base);
    const int per = (m + nt - 1) / nt;  // rows per thread, <= kItems
    const int s0 = tid * per;           // this thread's first row
    if (base > 0) __syncthreads();      // the last chunk's ranks are out
    for (int i = tid; i < m; i += nt) {  // coalesced
      const int32_t k = keys[row0 + base + i];
      skey[pad(i)] = static_cast<uint32_t>(k) < dead
                         ? static_cast<uint32_t>(k) : dead;
    }
    __syncthreads();

    // 1. stable LSD radix sort of (key, position)
    for (int p = 0; p < passes; ++p) {
      const int shift = p * DB;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int s = s0 + i;
        if (i < per && s < m) {
          key[i] = skey[pad(s)];
          pos[i] = p == 0 ? s : spos[pad(s)];
        }
      }
      count_digits<DB>(key, pos, max(0, min(per, m - s0)), shift, ctr,
                       wtot);
      // scatter each row after its digit's earlier rows
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (i < per && s0 + i < m) {
          const unsigned d = (key[i] >> shift) & ((1u << DB) - 1);
          const int dst = digit_count<DB>(ctr, d, tid) +
                          (static_cast<uint32_t>(pos[i]) >> 16);
          skey[pad(dst)] = key[i];
          spos[pad(dst)] = pos[i] & 0xffff;
        }
      }
      __syncthreads();
    }

    // 2. runs of equal keys, with the rows striped over the warps' lanes
    // (lane l of warp w holds rows w*32*per + 32j + l), so that a warp's
    // count stores below fall on nearby keys.  A row's run start comes from
    // a ballot of the run heads in its warp, else the last head of the
    // earlier warps.  A run head puts the key's count of the earlier chunks
    // (its carry) in place of its position: spos[s] is read only by the
    // lane that owns row s.
    const int wbase = w * 32 * per;
    const unsigned lt = lanemask_lt();
    unsigned tails = 0;
    int last = -1;  // this warp's last run head so far
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j < per) {
        const int s = wbase + 32 * j + lane;
        const bool live = s < m;
        const uint32_t k = live ? skey[pad(s)] : dead;
        const bool head = live && (s == 0 || skey[pad(s - 1)] != k);
        const bool tail = live && (s == m - 1 || skey[pad(s + 1)] != k);
        key[j] = k;
        pos[j] = live ? spos[pad(s)] : 0;
        const unsigned hm = __ballot_sync(0xffffffffu, head);
        const unsigned le = hm & (lt | (1u << lane));
        const int jb = wbase + 32 * j;
        rs[j] = le ? jb + 31 - __clz(le) : last;
        if (hm) last = jb + 31 - __clz(hm);
        if (head) spos[pad(s)] = (base > 0 && k != dead) ? cnt[k] : 0;
        tails |= static_cast<unsigned>(tail) << j;
      }
    }
    if (lane == 0) wtot[w] = last;
    __syncthreads();
    int earlier = lane < w ? wtot[lane] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      earlier = max(earlier, __shfl_xor_sync(0xffffffffu, earlier, o));
    // 3. ranks, staged by position, and the counts at the run tails
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int s = wbase + 32 * j + lane;
      if (j < per && s < m) {
        const int start = rs[j] < 0 ? earlier : rs[j];
        int32_t rk = -1;
        if (key[j] != dead) {
          rk = s - start + spos[pad(start)];
          if ((tails >> j) & 1u) cnt[key[j]] = rk + 1;
        }
        skey[pad(pos[j])] = static_cast<uint32_t>(rk);
      }
    }
    __syncthreads();
    // 4. out, coalesced; the next chunk rewrites skey only after barriers
    for (int i = tid; i < m; i += nt)
      rank[row0 + base + i] = static_cast<int32_t>(skey[pad(i)]);
  }
}

// Many short rows over a small key space (the sharded exchange and
// restructure): each warp ranks a row of its own, 32 keys a step in order,
// with the lanes of equal keys found by __match_any_sync and a histogram of
// the row's K buckets in shared memory (at most kWarpRowBuckets words a
// warp); the histogram is the row's counts.  Every warp of the block works
// and no barrier is needed.
__global__ void __launch_bounds__(kMaxThreads)
    radix_rank_warp_rows(const int32_t* __restrict__ keys,
                         int32_t* __restrict__ rank,
                         int32_t* __restrict__ counts, int bn, int rows,
                         int n_buckets) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (b >= bn) return;
  int32_t* hist = reinterpret_cast<int32_t*>(smem) +
                  static_cast<int64_t>(w) * n_buckets;
  for (int k = lane; k < n_buckets; k += 32) hist[k] = 0;
  __syncwarp();
  const int32_t* kr = keys + b * rows;
  int32_t* rr = rank + b * rows;
  const unsigned lt = lanemask_lt();
  int32_t next = lane < rows ? kr[lane] : 0;
  for (int base = 0; base < rows; base += 32) {
    const int i = base + lane;
    const int32_t key = next;
    next = i + 32 < rows ? kr[i + 32] : 0;
    const bool live = i < rows;
    const bool counted =
        live && static_cast<uint32_t>(key) < static_cast<uint32_t>(n_buckets);
    const unsigned peers =
        __match_any_sync(0xffffffffu, counted ? key : -1 - lane);
    const int before = counted ? hist[key] : 0;
    __syncwarp();
    if (counted && (peers >> lane) == 1u) hist[key] = before + __popc(peers);
    __syncwarp();
    if (live) rr[i] = counted ? before + __popc(peers & lt) : -1;
  }
  __syncwarp();
  int32_t* cr = counts + b * n_buckets;
  for (int k = lane; k < n_buckets; k += 32) cr[k] = hist[k];
}

template <int DB>
cudaError_t launch_one_pass(const int32_t* keys, int32_t* rank,
                            int32_t* counts, int bn, int rows, int n_buckets,
                            int threads, cudaStream_t stream) {
  const int chunk = min(rows, threads * kItems);
  const size_t smem = (static_cast<size_t>(padded(chunk)) +
                       padded((1 << DB) / 2 * threads) + 32 + (1 << DB)) *
                      sizeof(uint32_t);
  cudaError_t err = set_smem(radix_rank_one_pass<DB>, smem);
  if (err != cudaSuccess) return err;
  radix_rank_one_pass<DB><<<bn, threads, smem, stream>>>(
      keys, rank, counts, rows, n_buckets, chunk);
  return cudaGetLastError();
}

template <int DB, int kBlock>
cudaError_t launch_sort(const int32_t* keys, int32_t* rank, int32_t* counts,
                        int bn, int rows, int n_buckets, int passes,
                        int threads, cudaStream_t stream) {
  const int chunk = min(rows, threads * kItems);
  const size_t smem =
      (2 * static_cast<size_t>(padded(chunk)) +
       padded((1 << DB) / 2 * threads) + 32) *
      sizeof(uint32_t);
  cudaError_t err = set_smem(radix_rank_kernel<DB, kBlock>, smem);
  if (err != cudaSuccess) return err;
  radix_rank_kernel<DB, kBlock><<<bn, threads, smem, stream>>>(
      keys, rank, counts, rows, n_buckets, passes, chunk);
  return cudaGetLastError();
}

// The build with the most registers that the block size allows.
template <int DB>
cudaError_t launch(const int32_t* keys, int32_t* rank, int32_t* counts, int bn,
                   int rows, int n_buckets, int passes, int threads,
                   cudaStream_t stream) {
  if (threads > 640)
    return launch_sort<DB, 1024>(keys, rank, counts, bn, rows, n_buckets,
                                 passes, threads, stream);
  return launch_sort<DB, 640>(keys, rank, counts, bn, rows, n_buckets, passes,
                              threads, stream);
}

}  // namespace

// keys, rank: i32[bn, rows]; counts: i32[bn, n_buckets], written whole by
// the kernel; n_buckets >= 1; threads a multiple of 32 in [32, 1024].
// Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int radix_partition_rank(const void* keys, void* rank,
                                      void* counts, int bn, int rows,
                                      int n_buckets, int threads,
                                      void* stream) {
  // sort keys lie in [0, n_buckets] (n_buckets marks a key outside [0, K))
  const int bits = 32 - __builtin_clz(static_cast<unsigned>(n_buckets));
  const auto* k = static_cast<const int32_t*>(keys);
  auto* r = static_cast<int32_t*>(rank);
  auto* c = static_cast<int32_t*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if (n_buckets <= kWarpRowBuckets && rows <= kWarpRowRows &&
      bn >= kWarpRowsPerBlock * sms) {
    // at most kWarpRowsPerBlock rows a block, so that the rows spread over
    // every SM; fewer where the block size asks for it
    const int warps = min(threads / 32, kWarpRowsPerBlock);
    const size_t smem =
        static_cast<size_t>(warps) * n_buckets * sizeof(int32_t);
    if ((err = set_smem(radix_rank_warp_rows, smem)) != cudaSuccess)
      return static_cast<int>(err);
    radix_rank_warp_rows<<<(bn + warps - 1) / warps, 32 * warps, smem, st>>>(
        k, r, c, bn, rows, n_buckets);
    return static_cast<int>(cudaGetLastError());
  }
  if (bits <= kOnePassBits) {
    switch (bits) {
      case 1: err = launch_one_pass<1>(k, r, c, bn, rows, n_buckets, threads, st); break;
      case 2: err = launch_one_pass<2>(k, r, c, bn, rows, n_buckets, threads, st); break;
      case 3: err = launch_one_pass<3>(k, r, c, bn, rows, n_buckets, threads, st); break;
      case 4: err = launch_one_pass<4>(k, r, c, bn, rows, n_buckets, threads, st); break;
      default: err = launch_one_pass<5>(k, r, c, bn, rows, n_buckets, threads, st); break;
    }
    return static_cast<int>(err);
  }
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int db = (bits + passes - 1) / passes;
  switch (db) {
    case 1: err = launch<1>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
    case 2: err = launch<2>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
    case 3: err = launch<3>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
    case 4: err = launch<4>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
    case 5: err = launch<5>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
    default: err = launch<6>(k, r, c, bn, rows, n_buckets, passes, threads, st); break;
  }
  return static_cast<int>(err);
}
