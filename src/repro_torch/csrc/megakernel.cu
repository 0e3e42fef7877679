// Fused chain evaluation of sorted intervals: coefficients, segmented affine
// scan, state gather, apply and commit in one launch, one block per problem.
//
// Replaces: src/repro/kernels/megakernel/kernel.py::fused_chain_pallas (body
// _fused_chain_kernel).  A launch takes a batch of independent problems, each
// one interval of N sorted rows over W lanes with its own state block of S
// slots (the single-device driver: a batch of one; the sharded driver: one
// interval of every shard).  For each problem:
//   a, b  = (a_lut[fun], b_lut[fun] ? operand : 0), identity (1, 0) if invalid
//   (A, B) = exclusive segmented scan of the maps v -> a*v + b, (Ai, Bi) = the
//           row's own map after it
//   v0 = values[uid], pre = A*v0 + B, post = Ai*v0 + Bi
//   values[uid] = post of each chain's last row; the pad slot becomes 0
//   pre and post of invalid rows are written as 0.
//
// What bounds it on an H100: launch latency.  One GS interval (5,000 rows,
// W = 1) reads each row's columns and writes its pre and post (110 KB), and
// gathers and commits one value per chain (at most 40 KB more): under
// 0.15 MB, some 0.045 us at 3.35 TB/s, and a few hundred thousand flops; the
// launch and the log2(N) block-wide barriers cost far more.
//
// Design.  The result must equal the plain twin (the staged pipeline) bit for
// bit, so the scan is the reference's explicit Hillis-Steele sweep
// (core/restructure.py::segmented_scan_affine) step for step: shift fills
// flag = 1, a = 1, b = 0 at the edge, a barrier between steps, ping-pong
// buffers in shared memory, and every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: nvcc may not contract them into an FMA).  One block
// holds the whole interval, so no carry crosses blocks.  The state is
// gathered directly from global memory, where the TPU kernel used a one-hot
// matmul, and each chain's last row stores its post with a plain store: every
// slot has one writer, so no atomics.  All gathers finish before the first
// commit store (the unmasked posts wait in shared memory across a barrier),
// and the commit writes the carried state in place.  Problems share nothing,
// so block b reads and writes only problem b's rows and state block (strides
// N and S * W); one block per problem keeps each problem's shared-memory
// need at one problem's: flattening every shard into one block would put
// GS's 4 shards x 2,504 received rows (slack 2) near the one-block limit of
// about 13,000 rows x lanes.
#include "common.cuh"

#include <limits.h>

namespace {

__device__ inline void coefficients(int r, int e, const int32_t* fun,
                                    const uint8_t* valid, const float* operand,
                                    const float* a_lut, const uint8_t* b_lut,
                                    float* a, float* b) {
  if (valid[r]) {
    const int f = fun[r];
    *a = a_lut[f];
    *b = b_lut[f] ? operand[e] : 0.f;
  } else {
    *a = 1.f;
    *b = 0.f;
  }
}

__global__ void fused_chain_kernel(const uint8_t* __restrict__ seg_start,
                                   const int32_t* __restrict__ fun,
                                   const uint8_t* __restrict__ valid,
                                   const int32_t* __restrict__ uid,
                                   const float* __restrict__ operand,
                                   const float* __restrict__ a_lut,
                                   const uint8_t* __restrict__ b_lut,
                                   float* __restrict__ values,
                                   float* __restrict__ pre,
                                   float* __restrict__ post, int n, int w,
                                   int slots, int pad_uid) {
  extern __shared__ float smem[];
  {  // this block's problem
    const int64_t b = blockIdx.x;
    seg_start += b * n;
    fun += b * n;
    valid += b * n;
    uid += b * n;
    operand += b * n * w;
    values += b * slots * w;
    pre += b * n * w;
    post += b * n * w;
  }
  const int nw = n * w;
  float* abuf[2] = {smem, smem + nw};
  float* bbuf[2] = {smem + 2 * nw, smem + 3 * nw};
  uint8_t* f0 = reinterpret_cast<uint8_t*>(smem + 4 * nw);  // seg_start
  uint8_t* fbuf[2] = {f0 + n, f0 + 2 * n};
  const int tid = threadIdx.x, nt = blockDim.x;

  // stage 1: coefficient expansion; invalid rows become identity
  for (int e = tid; e < nw; e += nt) {
    coefficients(e / w, e, fun, valid, operand, a_lut, b_lut, &abuf[0][e],
                 &bbuf[0][e]);
  }
  for (int r = tid; r < n; r += nt) {
    f0[r] = seg_start[r];
    fbuf[0][r] = seg_start[r];
  }
  __syncthreads();

  // stage 2: inclusive segmented scan, segmented_scan_affine's step order
  int cur = 0;
  for (int d = 1; d < n; d <<= 1) {
    const float* ai = abuf[cur];
    const float* bi = bbuf[cur];
    const uint8_t* fi = fbuf[cur];
    for (int e = tid; e < nw; e += nt) {
      const int r = e / w;
      const float a = ai[e], b = bi[e];
      const float ap = r >= d ? ai[e - d * w] : 1.f;
      const float bp = r >= d ? bi[e - d * w] : 0.f;
      if (fi[r]) {
        abuf[cur ^ 1][e] = a;
        bbuf[cur ^ 1][e] = b;
      } else {
        abuf[cur ^ 1][e] = __fmul_rn(a, ap);
        bbuf[cur ^ 1][e] = __fadd_rn(__fmul_rn(a, bp), b);
      }
    }
    for (int r = tid; r < n; r += nt)
      fbuf[cur ^ 1][r] = fi[r] | (r >= d ? fi[r - d] : 1);
    cur ^= 1;
    __syncthreads();
  }

  // stage 3: exclusive view, inclusive composition, gather, apply.  The
  // unmasked post goes to the free buffer for the commit.
  const float* a_inc = abuf[cur];
  const float* b_inc = bbuf[cur];
  float* post_buf = abuf[cur ^ 1];
  for (int e = tid; e < nw; e += nt) {
    const int r = e / w;
    float A = r > 0 ? a_inc[e - w] : 1.f;
    float B = r > 0 ? b_inc[e - w] : 0.f;
    if (f0[r]) {
      A = 1.f;
      B = 0.f;
    }
    float a, b;
    coefficients(r, e, fun, valid, operand, a_lut, b_lut, &a, &b);
    const float Ai = __fmul_rn(a, A);
    const float Bi = __fadd_rn(__fmul_rn(a, B), b);
    const float v0 = values[static_cast<int64_t>(uid[r]) * w + (e - r * w)];
    const float p = __fadd_rn(__fmul_rn(A, v0), B);
    const float q = __fadd_rn(__fmul_rn(Ai, v0), Bi);
    post_buf[e] = q;
    pre[e] = valid[r] ? p : 0.f;
    post[e] = valid[r] ? q : 0.f;
  }
  __syncthreads();

  // stage 4: commit each chain's last post into its slot (one writer each)
  for (int e = tid; e < nw; e += nt) {
    const int r = e / w;
    const bool last = r == n - 1 || f0[r + 1];
    if (last && uid[r] != pad_uid)
      values[static_cast<int64_t>(uid[r]) * w + (e - r * w)] = post_buf[e];
  }
  for (int l = tid; l < w; l += nt) values[static_cast<int64_t>(pad_uid) * w + l] = 0.f;
}

}  // namespace

// Shared memory one block needs for n rows of w lanes (INT_MAX if more).
REPRO_EXPORT int megakernel_smem_bytes(int n, int w) {
  const int64_t bytes = static_cast<int64_t>(n) * w * 4 * sizeof(float) +
                        3 * static_cast<int64_t>(n);
  return bytes > INT_MAX ? INT_MAX : static_cast<int>(bytes);
}

// seg_start, valid: u8[batch, n]; fun, uid: i32[batch, n]; operand, pre,
// post: f32[batch, n, w]; a_lut: f32[n_funs]; b_lut: u8[n_funs]; values:
// f32[batch, slots, w], updated in place.
REPRO_EXPORT int megakernel_fused_chain(const void* seg_start, const void* fun,
                                        const void* valid, const void* uid,
                                        const void* operand, const void* a_lut,
                                        const void* b_lut, void* values,
                                        void* pre, void* post, int batch, int n,
                                        int w, int slots, int pad_uid,
                                        int threads, void* stream) {
  const size_t smem = static_cast<size_t>(megakernel_smem_bytes(n, w));
  cudaError_t err = set_smem(fused_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_chain_kernel<<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg_start), static_cast<const int32_t*>(fun),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(uid),
      static_cast<const float*>(operand), static_cast<const float*>(a_lut),
      static_cast<const uint8_t*>(b_lut), static_cast<float*>(values),
      static_cast<float*>(pre), static_cast<float*>(post), n, w, slots,
      pad_uid);
  return static_cast<int>(cudaGetLastError());
}
