// Fused chain evaluation of a whole stream of sorted intervals in three
// launches: every interval's segmented scan at once, a per-slot walk of the
// state over the intervals, and every row's apply at once.
//
// Replaces: src/repro/kernels/megakernel/kernel.py::fused_chain_pallas (body
// _fused_chain_kernel), which evaluates ONE interval per dispatch and is
// called once per interval from a scan.  A call here takes a stack of K
// intervals of a batch of B independent problems (the single-device driver:
// B = 1; the sharded driver: one problem per shard), each interval N sorted
// rows over W lanes, each problem a state block of S slots (the last is the
// pad slot).  For each interval k, in order, and each problem:
//   a, b  = (a_lut[fun], b_lut[fun] ? operand : 0), identity (1, 0) if invalid
//   (A, B) = exclusive segmented scan of the maps v -> a*v + b, (Ai, Bi) = the
//           row's own map after it
//   v0 = values[uid], pre = A*v0 + B, post = Ai*v0 + Bi
//   values[uid] = post of each chain's last row; the pad slot becomes 0
//   pre and post of invalid rows are 0.
// pre, post and success are stored in flat (pre-sort) row order.
//
// Why three phases give the per-interval schedule's bits.  Everything but
// v0 is values-independent, and all one interval passes to the next is, per
// slot u touched in interval k, v <- Ai*v + Bi at u's chain's last row, with
// the same two rounded operations the per-interval commit does.  So:
//   1. scan_kernel, one block per (interval, problem): the reference's
//      Hillis-Steele sweep (core/restructure.py::segmented_scan_affine) step
//      for step in shared memory -- shift fills flag = 1, a = 1, b = 0 at the
//      edge, a barrier between steps, every product and sum rounded on its
//      own (__fmul_rn / __fadd_rn: nvcc may not contract them into an FMA).
//      It stops after ceil(log2 L) steps, L the longest chain other than the
//      pad chain: a row's flag is set once its window reaches its chain's
//      start, and a row with its flag set never changes again, so the steps
//      left out would change no row of a real chain.  A row whose flag is
//      unset reads only rows of its own chain, so the pad chain's rows, which
//      may stop short, feed no real row; they are invalid in every driver's
//      data, written as 0 and never committed, so their (A, B) are unused.
//      Where a row of the pad chain is valid, L counts the pad chain too.
//      Writes the exclusive (A, B) of every row, and the composed map
//      (Ai, Bi) of each real chain's last row into a per-slot table.
//   2. carry_kernel, one thread per (problem, slot, lane): walks k = 0..K-1;
//      where the slot has a chain in interval k it records v0[k] = v and sets
//      v = Ai*v + Bi.  Those loads do not depend on v, so a block's eight
//      warps stage a chunk of 64 intervals of 32 slots in shared memory with
//      coalesced loads, and one warp runs the chunk's recurrence from there.
//      The pad slot's own v0 is its initial value in interval 0 and 0
//      after (the per-interval commit zeroes it after every interval).
//      Writes the final v into values, in place; the pad slot ends at 0.
//   3. apply_kernel, one block per (interval, problem): pre and post from
//      v0[k, uid] and the row's (A, B), placed at the row's flat position
//      through the partition's permutation (order) in shared memory, then
//      stored in flat order.
//
// What bounds it on an H100: latency, not bytes.  The function of a GS
// stream (200 intervals of 5,000 rows, W = 1, 10,001 slots) moves about
// 27 MB (each row's columns, flat position, pre, post and success; the
// state in and out): some 8.1 us at 3.35 TB/s.  This design also reads
// the per-interval slot histograms (8 MB more) and writes and reads its
// workspace; the scan's ceil(log2 L) block-wide barriers, the carry's K
// dependent steps per slot, the apply's random state gather and the three
// launches cost more than those bytes.  So every phase issues its
// global loads before it uses any (no load waits on another's value but
// where it must: a LUT entry on its fun, a state gather on its uid).  One
// block per interval (not per stream) puts 200 blocks on the 132 SMs, two
// to an SM at GS's 95 KB of shared memory.  The interval's columns are
// staged with plain coalesced loads, not the bulk copy: an interval's
// 1-byte columns start at any byte offset, and the bulk copy needs 16-byte
// alignment.
#include "common.cuh"

#include <limits.h>

namespace {

// carry_kernel's block: CARRY_LANES (slot, lane) pairs, walked by its first
// warp; all CARRY_WARPS warps stage CARRY_CHUNK intervals of them at a time.
constexpr int CARRY_LANES = 32;
constexpr int CARRY_WARPS = 8;
constexpr int CARRY_CHUNK = 64;

// (a, b) of row r, lane element e.  Every load is issued unconditionally
// (fun is a valid LUT index on every row, padding included), so none waits
// on another before the LUT lookup.
__device__ inline void coefficients(int r, int64_t e, const int32_t* fun,
                                    const uint8_t* valid, const float* operand,
                                    const float* a_lut, const uint8_t* b_lut,
                                    float* a, float* b) {
  const bool ok = valid[r];
  const int f = fun[r];
  const float x = operand[e];
  const float la = a_lut[f];
  const bool lb = b_lut[f];
  *a = ok ? la : 1.f;
  *b = ok && lb ? x : 0.f;
}

template <typename T>
__device__ inline void swap_ptr(T*& x, T*& y) {
  T* t = x;
  x = y;
  y = t;
}

// One block per problem p = k * B + b: rows [p*n, (p+1)*n), slots
// [p*slots, (p+1)*slots).  a_exc, b_exc: the exclusive (A, B) of every row,
// [P, n, w]; m_a, m_b: the composed map (Ai, Bi) of each real chain's last
// row at its slot, [P, slots, w] (slots without a chain are left unwritten).
template <int kW>
__global__ void __launch_bounds__(1024)
scan_kernel(const uint8_t* __restrict__ seg_start,
            const int32_t* __restrict__ fun,
            const uint8_t* __restrict__ valid,
            const int32_t* __restrict__ uid,
            const float* __restrict__ operand,
            const int32_t* __restrict__ counts,
            const float* __restrict__ a_lut,
            const uint8_t* __restrict__ b_lut, float* __restrict__ a_exc,
            float* __restrict__ b_exc, float* __restrict__ m_a,
            float* __restrict__ m_b, int n, int w_any, int slots,
            int pad_uid) {
  const int w = kW > 0 ? kW : w_any;
  extern __shared__ float smem[];
  __shared__ int longest;  // longest real chain of this problem
  {
    const int64_t p = blockIdx.x;
    seg_start += p * n;
    fun += p * n;
    valid += p * n;
    uid += p * n;
    operand += p * n * w;
    counts += p * slots;
    a_exc += p * n * w;
    b_exc += p * n * w;
    m_a += p * slots * w;
    m_b += p * slots * w;
  }
  const int nw = n * w;
  // ping-pong buffers, swapped as pointers (an array of them indexed by a
  // runtime step would live in local memory)
  float* a_cur = smem;
  float* a_nxt = smem + nw;
  float* b_cur = smem + 2 * nw;
  float* b_nxt = smem + 3 * nw;
  uint8_t* f0 = reinterpret_cast<uint8_t*>(smem + 4 * nw);  // seg_start
  uint8_t* f_cur = f0 + n;
  uint8_t* f_nxt = f0 + 2 * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) longest = 0;
  __syncthreads();

  // stage: coefficient expansion (invalid rows become identity), the flags,
  // and the longest real chain from the histogram at each chain's start
  // (the pad chain's at each of its valid rows)
#pragma unroll 4
  for (int e = tid; e < nw; e += nt) {
    coefficients(e / w, e, fun, valid, operand, a_lut, b_lut, &a_cur[e],
                 &b_cur[e]);
  }
  int mine = 0;
#pragma unroll 4
  for (int r = tid; r < n; r += nt) {
    const uint8_t s = seg_start[r];
    const uint8_t ok = valid[r];
    const int u = uid[r];
    f0[r] = s;
    f_cur[r] = s;
    if (u == pad_uid ? ok : s) mine = max(mine, counts[u]);
  }
  // one shared atomic per warp, not one per chain
  mine = __reduce_max_sync(0xffffffffu, mine);
  if ((tid & 31) == 0) atomicMax(&longest, mine);
  __syncthreads();

  // inclusive segmented scan, segmented_scan_affine's step order, for the
  // ceil(log2 longest) steps that can change a real row; lane 0 of a row
  // also steps its flag
  const int steps_to = longest;
  for (int d = 1; d < steps_to; d <<= 1) {
    for (int e = tid; e < nw; e += nt) {
      const int r = e / w;
      const float a = a_cur[e], b = b_cur[e];
      const float ap = r >= d ? a_cur[e - d * w] : 1.f;
      const float bp = r >= d ? b_cur[e - d * w] : 0.f;
      const uint8_t f = f_cur[r];
      if (f) {
        a_nxt[e] = a;
        b_nxt[e] = b;
      } else {
        a_nxt[e] = __fmul_rn(a, ap);
        b_nxt[e] = __fadd_rn(__fmul_rn(a, bp), b);
      }
      if (e == r * w) f_nxt[r] = f | (r >= d ? f_cur[r - d] : 1);
    }
    swap_ptr(a_cur, a_nxt);
    swap_ptr(b_cur, b_nxt);
    swap_ptr(f_cur, f_nxt);
    __syncthreads();
  }

  // exclusive view; each real chain's last row also writes its composed map
  const float* a_inc = a_cur;
  const float* b_inc = b_cur;
#pragma unroll 4
  for (int e = tid; e < nw; e += nt) {
    const int r = e / w;
    const int u = uid[r];
    float a, b;
    coefficients(r, e, fun, valid, operand, a_lut, b_lut, &a, &b);
    float A = r > 0 ? a_inc[e - w] : 1.f;
    float B = r > 0 ? b_inc[e - w] : 0.f;
    if (f0[r]) {
      A = 1.f;
      B = 0.f;
    }
    a_exc[e] = A;
    b_exc[e] = B;
    const bool last = r == n - 1 || f0[r + 1];
    if (last && u != pad_uid) {
      const int64_t m = static_cast<int64_t>(u) * w + (e - r * w);
      m_a[m] = __fmul_rn(a, A);
      m_b[m] = __fadd_rn(__fmul_rn(a, B), b);
    }
  }
}

// Block x walks CARRY_LANES consecutive (problem b, slot u, lane l) triples
// t over the K intervals.  Its warps stage a chunk of intervals' histogram
// entries and composed maps in shared memory with coalesced loads that do
// not depend on the state (maps of slots without a chain are read and left
// unused); then its first warp, one thread per t, runs the chunk's
// recurrence from shared memory.
__global__ void __launch_bounds__(CARRY_LANES * CARRY_WARPS)
carry_kernel(const int32_t* __restrict__ counts,
             const float* __restrict__ m_a, const float* __restrict__ m_b,
             float* __restrict__ v0, float* __restrict__ values, int k_total,
             int batch, int slots, int w, int pad_uid) {
  __shared__ int s_c[CARRY_CHUNK][CARRY_LANES];
  __shared__ float s_a[CARRY_CHUNK][CARRY_LANES];
  __shared__ float s_b[CARRY_CHUNK][CARRY_LANES];
  const int col = threadIdx.x % CARRY_LANES;
  const int64_t sw = static_cast<int64_t>(slots) * w;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * CARRY_LANES + col;
  const bool live = t < batch * sw;
  const int64_t u = (t % sw) / w;
  const int64_t cell = (t / sw) * slots + u;   // counts index at k = 0
  const int64_t k_stride = static_cast<int64_t>(batch) * slots;
  const bool walker = threadIdx.x < CARRY_LANES && live;
  const bool pad = u == pad_uid;
  float v = walker ? values[t] : 0.f;
  for (int k0 = 0; k0 < k_total; k0 += CARRY_CHUNK) {
    const int span = min(CARRY_CHUNK, k_total - k0);
    if (live) {
      for (int j = threadIdx.x / CARRY_LANES; j < span; j += CARRY_WARPS) {
        const int64_t k = k0 + j;
        s_c[j][col] = counts[k * k_stride + cell];
        s_a[j][col] = m_a[k * k_stride * w + t];
        s_b[j][col] = m_b[k * k_stride * w + t];
      }
    }
    __syncthreads();
    if (walker) {
      for (int j = 0; j < span; ++j) {
        if (s_c[j][col] > 0) {
          v0[(k0 + j) * k_stride * w + t] = v;
          v = __fadd_rn(__fmul_rn(s_a[j][col], v), s_b[j][col]);
        }
        if (pad) v = 0.f;  // the pad slot's map is never written
      }
    }
    __syncthreads();
  }
  if (walker) values[t] = v;
}

// One block per problem p: each row's pre and post, stored to shared memory
// at the row's flat position, then copied out in flat order, so the
// permutation scatters into shared memory and global stores coalesce.
// Every load but the state's is issued before any is used.
template <int kW>
__global__ void __launch_bounds__(1024)
apply_kernel(const int32_t* __restrict__ fun,
             const uint8_t* __restrict__ valid,
             const int32_t* __restrict__ uid,
             const float* __restrict__ operand,
             const int32_t* __restrict__ order,
             const float* __restrict__ a_lut,
             const uint8_t* __restrict__ b_lut,
             const float* __restrict__ a_exc, const float* __restrict__ b_exc,
             const float* __restrict__ v0, float* __restrict__ pre,
             float* __restrict__ post, uint8_t* __restrict__ success, int n,
             int w_any, int slots) {
  const int w = kW > 0 ? kW : w_any;
  extern __shared__ float smem[];
  const int nw = n * w;
  {  // this block's problem
    const int64_t p = blockIdx.x;
    fun += p * n;
    valid += p * n;
    uid += p * n;
    order += p * n;
    success += p * n;
    operand += p * nw;
    a_exc += p * nw;
    b_exc += p * nw;
    pre += p * nw;
    post += p * nw;
    v0 += p * slots * w;
  }
  float* s_pre = smem;
  float* s_post = smem + nw;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(smem + 2 * nw);
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll 4
  for (int e = tid; e < nw; e += nt) {
    const int r = e / w, l = e - r * w;
    const bool ok = valid[r];
    const int u = uid[r];
    const int dst = order[r];
    const float A = a_exc[e], B = b_exc[e];
    float a, b;
    coefficients(r, e, fun, valid, operand, a_lut, b_lut, &a, &b);
    float q_pre = 0.f, q_post = 0.f;
    if (ok) {
      const float Ai = __fmul_rn(a, A);
      const float Bi = __fadd_rn(__fmul_rn(a, B), b);
      const float x = v0[static_cast<int64_t>(u) * w + l];
      q_pre = __fadd_rn(__fmul_rn(A, x), B);
      q_post = __fadd_rn(__fmul_rn(Ai, x), Bi);
    }
    s_pre[dst * w + l] = q_pre;
    s_post[dst * w + l] = q_post;
    if (l == 0) s_ok[dst] = ok;
  }
  __syncthreads();
  for (int e = tid; e < nw; e += nt) {
    pre[e] = s_pre[e];
    post[e] = s_post[e];
  }
  for (int r = tid; r < n; r += nt) success[r] = s_ok[r];
}

}  // namespace

// Shared memory one scan block needs for n rows of w lanes (INT_MAX if more);
// it is more than an apply block's.
REPRO_EXPORT int megakernel_smem_bytes(int n, int w) {
  const int64_t bytes = static_cast<int64_t>(n) * w * 4 * sizeof(float) +
                        3 * static_cast<int64_t>(n);
  return bytes > INT_MAX ? INT_MAX : static_cast<int>(bytes);
}

static int megakernel_apply_smem_bytes(int n, int w) {
  return static_cast<int>(static_cast<int64_t>(n) * w * 2 * sizeof(float) +
                          n);
}

// k, batch, n, w > 0; pad_uid = slots - 1.  seg_start, valid:
// u8[k, batch, n]; fun, uid, order: i32[k, batch, n]; operand:
// f32[k, batch, n, w]; counts: i32[k, batch, slots]; a_lut: f32[n_funs];
// b_lut: u8[n_funs]; values: f32[batch, slots, w], updated in place; pre,
// post: f32[k, batch, n, w] and success: u8[k, batch, n], in flat row
// order; workspace: f32[k * batch * w * (2 * n + 3 * slots)]: exclusive A
// and B per row, the composed map per slot (Ai, Bi) and v0 per slot.
REPRO_EXPORT int megakernel_stream(
    const void* seg_start, const void* fun, const void* valid, const void* uid,
    const void* operand, const void* order, const void* counts,
    const void* a_lut, const void* b_lut, void* values, void* pre, void* post,
    void* success, void* workspace, int k, int batch, int n, int w, int slots,
    int pad_uid, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t problems = static_cast<int64_t>(k) * batch;
  const int64_t rows_w = problems * n * w;
  const int64_t slots_w = problems * slots * w;
  float* ws = static_cast<float*>(workspace);
  float* a_exc = ws;
  float* b_exc = a_exc + rows_w;
  float* m_a = b_exc + rows_w;
  float* m_b = m_a + slots_w;
  float* v0 = m_b + slots_w;
  // W = 1 (GS) gets kernels with the lane count fixed at compile time
  auto scan = w == 1 ? scan_kernel<1> : scan_kernel<0>;
  auto apply = w == 1 ? apply_kernel<1> : apply_kernel<0>;
  const size_t smem = static_cast<size_t>(megakernel_smem_bytes(n, w));
  cudaError_t err = set_smem(scan, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan<<<static_cast<unsigned>(problems), threads, smem, st>>>(
      static_cast<const uint8_t*>(seg_start), static_cast<const int32_t*>(fun),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(uid),
      static_cast<const float*>(operand), static_cast<const int32_t*>(counts),
      static_cast<const float*>(a_lut), static_cast<const uint8_t*>(b_lut),
      a_exc, b_exc, m_a, m_b, n, w, slots, pad_uid);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int64_t lanes = static_cast<int64_t>(batch) * slots * w;
  carry_kernel<<<static_cast<unsigned>((lanes + CARRY_LANES - 1) /
                                       CARRY_LANES),
                 CARRY_LANES * CARRY_WARPS, 0, st>>>(
      static_cast<const int32_t*>(counts), m_a, m_b, v0,
      static_cast<float*>(values), k, batch, slots, w, pad_uid);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t smem_apply =
      static_cast<size_t>(megakernel_apply_smem_bytes(n, w));
  if ((err = set_smem(apply, smem_apply)) != cudaSuccess)
    return static_cast<int>(err);
  apply<<<static_cast<unsigned>(problems), threads, smem_apply, st>>>(
      static_cast<const int32_t*>(fun), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(uid), static_cast<const float*>(operand),
      static_cast<const int32_t*>(order), static_cast<const float*>(a_lut),
      static_cast<const uint8_t*>(b_lut), a_exc, b_exc, v0,
      static_cast<float*>(pre), static_cast<float*>(post),
      static_cast<uint8_t*>(success), n, w, slots);
  return static_cast<int>(cudaGetLastError());
}
