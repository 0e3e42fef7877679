// Exclusive segmented scans over the sorted operation stream.
//
// Replaces: src/repro/kernels/segscan/kernel.py::segscan_affine_pallas (body
// _segscan_affine_kernel) and ::segscan_max_pallas (body _segscan_max_kernel).
// Over rows r of [N, W] with seg-start flags f[r]:
//   affine: (A, B)[r] = composition of the maps v -> a*v + b of the rows since
//           the segment start up to r - 1, identity (1, 0) at a start;
//   max:    M[r] = running max of the rows since the start up to r - 1,
//           identity -inf at a start.
//
// What bounds it on an H100: bytes.  Affine reads flags, a and b and writes
// A and B (TP: 400,000 rows x 32 lanes, 205 MB, about 61 us at 3.35 TB/s);
// max reads flags and m and writes M (102 MB, about 31 us).  Three flops per
// element are far below the f32 rate.
//
// Design.  The TPU kernel walked tiles in its sequential grid and carried the
// running segment in scratch.  Blocks here run in no order, so the carry
// becomes three launches:
//   1. tiles:  one thread per (tile of kTile rows, lane) scans its tile in
//      order, writes the tile-local exclusive result (identity before the
//      tile's first start) and the tile's aggregate; lane 0 records whether
//      the tile holds a segment start;
//   2. carry:  one block per lane scans the tile aggregates (a segmented
//      Hillis-Steele sweep in shared memory, kCarry tiles at a time, with a
//      running carry between rounds) into each tile's incoming carry;
//   3. fixup:  one thread per (tile, lane) composes that carry into the rows
//      before the tile's first start (the fold of segscan/kernel.py:80-92).
// Neighbouring threads take neighbouring lanes of a row, so row loads are
// coalesced for W = 32.  The association differs from the reference's
// Hillis-Steele sweep, as the TPU kernel's cross-block fold already did; the
// bar is rtol = atol = 1e-5 against the plain twin.  Flags are one byte a row.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTile = 128;   // rows per pass-1 tile
constexpr int kCarry = 512;  // tiles per pass-2 round (= its block size)

// An element is K floats: (a, b) for the affine scan, (m) for the max scan.
// compose(x, prev) is x applied after prev.
template <bool kMax>
struct Op {
  static constexpr int K = kMax ? 1 : 2;
  __device__ static void identity(float* o) {
    if (kMax) {
      o[0] = -INFINITY;
    } else {
      o[0] = 1.f;
      o[1] = 0.f;
    }
  }
  __device__ static void compose(const float* x, const float* prev, float* o) {
    if (kMax) {
      o[0] = fmaxf(x[0], prev[0]);
    } else {
      const float b = __fadd_rn(__fmul_rn(x[0], prev[1]), x[1]);
      o[0] = __fmul_rn(x[0], prev[0]);
      o[1] = b;
    }
  }
};

struct Arrays {
  const uint8_t* flags;  // [n]
  const float* in[2];    // [n, w] each
  float* out[2];         // [n, w] each
  float* agg[2];         // [n_tiles, w] each
  float* cin[2];         // [n_tiles, w] each
  uint8_t* tile_flag;    // [n_tiles]
  int64_t n, n_tiles;
  int w;
};

template <bool kMax>
__global__ void scan_tiles(Arrays p) {
  using O = Op<kMax>;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= p.n_tiles * p.w) return;
  const int64_t t = g / p.w;
  const int lane = static_cast<int>(g - t * p.w);
  const int64_t r0 = t * kTile, r1 = min(p.n, r0 + kTile);
  float c[2], x[2];
  O::identity(c);
  bool any = false;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t e = r * p.w + lane;
    if (p.flags[r]) {
      O::identity(c);
      any = true;
    }
#pragma unroll
    for (int k = 0; k < O::K; ++k) {
      p.out[k][e] = c[k];
      x[k] = p.in[k][e];
    }
    O::compose(x, c, c);
  }
#pragma unroll
  for (int k = 0; k < O::K; ++k) p.agg[k][g] = c[k];
  if (lane == 0) p.tile_flag[t] = any;
}

// One block per lane.  inclusive[t] = flag[t] ? agg[t] : agg[t] after
// inclusive[t - 1]; cin[t] = inclusive[t - 1], identity for t = 0.
template <bool kMax>
__global__ void scan_carry(Arrays p) {
  using O = Op<kMax>;
  __shared__ float sv[2][2][kCarry];
  __shared__ uint8_t sf[2][kCarry];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  float carry[2];
  O::identity(carry);
  for (int64_t base = 0; base < p.n_tiles; base += kCarry) {
    const int64_t t = base + tid;
    const bool live = t < p.n_tiles;
    float v[2];
    O::identity(v);
    uint8_t f = 0;
    if (live) {
#pragma unroll
      for (int k = 0; k < O::K; ++k) v[k] = p.agg[k][t * p.w + lane];
      f = p.tile_flag[t];
    }
    int cur = 0;
#pragma unroll
    for (int k = 0; k < O::K; ++k) sv[cur][k][tid] = v[k];
    sf[cur][tid] = f;
    __syncthreads();
    for (int d = 1; d < kCarry; d <<= 1) {
      float nv[2];
      uint8_t nf = sf[cur][tid];
#pragma unroll
      for (int k = 0; k < O::K; ++k) nv[k] = sv[cur][k][tid];
      if (!nf && tid >= d) {
        float prev[2], mine[2];
#pragma unroll
        for (int k = 0; k < O::K; ++k) {
          prev[k] = sv[cur][k][tid - d];
          mine[k] = nv[k];
        }
        O::compose(mine, prev, nv);
        nf = sf[cur][tid - d];
      }
#pragma unroll
      for (int k = 0; k < O::K; ++k) sv[cur ^ 1][k][tid] = nv[k];
      sf[cur ^ 1][tid] = nf;
      cur ^= 1;
      __syncthreads();
    }
    // fold in the carry of the earlier rounds where no start was seen
    float inc[2];
#pragma unroll
    for (int k = 0; k < O::K; ++k) inc[k] = sv[cur][k][tid];
    if (!sf[cur][tid]) O::compose(inc, carry, inc);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < O::K; ++k) sv[cur][k][tid] = inc[k];
    __syncthreads();
    if (live) {
#pragma unroll
      for (int k = 0; k < O::K; ++k)
        p.cin[k][t * p.w + lane] = tid == 0 ? carry[k] : sv[cur][k][tid - 1];
    }
#pragma unroll
    for (int k = 0; k < O::K; ++k) carry[k] = sv[cur][k][kCarry - 1];
    __syncthreads();
  }
}

template <bool kMax>
__global__ void scan_fixup(Arrays p) {
  using O = Op<kMax>;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= p.n_tiles * p.w) return;
  const int64_t t = g / p.w;
  const int lane = static_cast<int>(g - t * p.w);
  float c[2], x[2];
#pragma unroll
  for (int k = 0; k < O::K; ++k) c[k] = p.cin[k][g];
  const int64_t r0 = t * kTile, r1 = min(p.n, r0 + kTile);
  for (int64_t r = r0; r < r1 && !p.flags[r]; ++r) {
    const int64_t e = r * p.w + lane;
#pragma unroll
    for (int k = 0; k < O::K; ++k) x[k] = p.out[k][e];
    O::compose(x, c, x);
#pragma unroll
    for (int k = 0; k < O::K; ++k) p.out[k][e] = x[k];
  }
}

template <bool kMax>
int launch(const Arrays& p, int threads, cudaStream_t s) {
  const int64_t work = p.n_tiles * p.w;
  const unsigned blocks = static_cast<unsigned>((work + threads - 1) / threads);
  scan_tiles<kMax><<<blocks, threads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_carry<kMax><<<p.w, kCarry, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_fixup<kMax><<<blocks, threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT int segscan_tile_rows() { return kTile; }

// flags: u8[n]; a, b, A, B: f32[n, w]; agg_a, agg_b, cin_a, cin_b:
// f32[n_tiles, w]; tile_flag: u8[n_tiles], n_tiles = ceil(n / kTile).
REPRO_EXPORT int segscan_affine(const void* flags, const void* a, const void* b,
                                void* A, void* B, void* agg_a, void* agg_b,
                                void* cin_a, void* cin_b, void* tile_flag,
                                int64_t n, int w, int threads, void* stream) {
  Arrays p{};
  p.flags = static_cast<const uint8_t*>(flags);
  p.in[0] = static_cast<const float*>(a);
  p.in[1] = static_cast<const float*>(b);
  p.out[0] = static_cast<float*>(A);
  p.out[1] = static_cast<float*>(B);
  p.agg[0] = static_cast<float*>(agg_a);
  p.agg[1] = static_cast<float*>(agg_b);
  p.cin[0] = static_cast<float*>(cin_a);
  p.cin[1] = static_cast<float*>(cin_b);
  p.tile_flag = static_cast<uint8_t*>(tile_flag);
  p.n = n;
  p.n_tiles = (n + kTile - 1) / kTile;
  p.w = w;
  return launch<false>(p, threads, static_cast<cudaStream_t>(stream));
}

// flags: u8[n]; m, M: f32[n, w]; agg, cin: f32[n_tiles, w]; tile_flag:
// u8[n_tiles].
REPRO_EXPORT int segscan_max(const void* flags, const void* m, void* M,
                             void* agg, void* cin, void* tile_flag, int64_t n,
                             int w, int threads, void* stream) {
  Arrays p{};
  p.flags = static_cast<const uint8_t*>(flags);
  p.in[0] = static_cast<const float*>(m);
  p.out[0] = static_cast<float*>(M);
  p.agg[0] = static_cast<float*>(agg);
  p.cin[0] = static_cast<float*>(cin);
  p.tile_flag = static_cast<uint8_t*>(tile_flag);
  p.n = n;
  p.n_tiles = (n + kTile - 1) / kTile;
  p.w = w;
  return launch<true>(p, threads, static_cast<cudaStream_t>(stream));
}
