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
// What bounds it on an H100: bytes.  Affine reads flags, a and b once and
// writes A and B once (TP: 400,000 rows x 32 lanes, 205 MB, about 61 us at
// 3.35 TB/s); max reads flags and m and writes M (102 MB, about 31 us).
// Three flops per element are far below the f32 rate.
//
// Design: one launch per scan, each element read once from and written once
// to device memory.  The TPU kernel walked tiles in its sequential grid and
// carried the running segment in scratch; here every block takes one tile:
//   1. Tiles.  A tile is a block of rows x a group of at most 32 lanes (the
//      lanes are independent scans that share the flags).  Its geometry is a
//      function of W alone: W = 1 takes 4,096 rows as 256 chunks of 16; any
//      wider W takes 256 rows x 32 lanes, 16 chunks of 16 rows per lane.  The
//      block size only decides how many threads share this fixed work, so
//      no association depends on it.
//   2. Loads first.  The block copies its tile's flags and coefficients into
//      shared memory with cp.async (16 bytes a copy where aligned: at W = 1
//      four rows, at W = 32 a quarter of a row's 128-byte line), all issued
//      before anything waits on them.
//   3. In-tile scan.  Each (chunk, lane) item scans its 16 rows serially from
//      registers and leaves the chunk-local exclusive result in place; a
//      segmented Kogge-Stone sweep over the chunk index (a fixed tree, the
//      same for every call) combines the chunk aggregates into each chunk's
//      carry-in and the tile's aggregate: the composition from the tile's
//      last start to its end, or of the whole tile if it holds no start.
//   4. Carry across tiles, in a fixed order.  Tile t publishes its inclusive
//      carry I_t = agg_t if it holds a start, else agg_t after I_{t-1}: the
//      value words, a fence, then a status word with a release store.  A
//      tile with a start publishes as soon as its reduction is done; only
//      runs of start-less tiles wait on each other.  Warp 0 of the next tile
//      spins on an acquire load and broadcasts the carry through shared
//      memory.  Tiles take their index from an atomic counter, so a tile's
//      predecessor is always resident (forward progress).  No tile reads an
//      earlier tile's prefix because it happens to be ready (the decoupled
//      look-back's shortcut), so the association never depends on timing
//      and two calls give the same bits.
//   5. Write-out.  Rows before their chunk's first start get the chunk's
//      carry composed in (the tile carry too where no start precedes them
//      in the tile), and the tile goes back to device memory with the same
//      coalesced 16-byte stores.
// Scratch: only the status words (with the tile counter, zeroed by the
// wrapper) and the carry words.  Compositions round each product and sum on
// its own (__fmul_rn / __fadd_rn).  The association differs from the twin's
// Hillis-Steele sweep and depends on where a chain lies among the tiles, as
// the TPU kernel's cross-block fold already did: the affine bar is
// rtol = atol = 1e-5 against the plain twin.  The max scan is exact under any
// association.  Flags are one byte a row.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kChunkRows = 16;   // rows one item scans serially
constexpr int kMinTileRows = 256;

// Tile geometry, a function of W alone: kChunks chunks of 16 rows x kLanes
// lanes, kItems (chunk, lane) items.  at(row, lane) is the element's float
// offset in the tile's shared copy of one array.
template <bool kNarrow>
struct Geo;

template <>
struct Geo<true> {   // W = 1
  static constexpr int kLanes = 1, kChunks = 256;
  static constexpr int kRows = kChunks * kChunkRows, kItems = kChunks * kLanes;
  // 16 rows and 4 floats of padding a chunk: the 16-byte reads of 8
  // consecutive chunks (a quarter warp) land on distinct banks
  static constexpr int kStride = 20;
  static constexpr int kVals = kChunks * kStride;
  __device__ static int at(int row, int) {
    return (row >> 4) * kStride + (row & 15);
  }
};

template <>
struct Geo<false> {  // W >= 2, groups of 32 lanes
  static constexpr int kLanes = 32, kChunks = 16;
  static constexpr int kRows = kChunks * kChunkRows, kItems = kChunks * kLanes;
  static constexpr int kVals = kRows * 32;
  __device__ static int at(int row, int lane) { return row * 32 + lane; }
};

static_assert(Geo<false>::kRows >= kMinTileRows, "tile rows");
static_assert(Geo<true>::kRows >= kMinTileRows, "tile rows");

// An element is K floats: (a, b) for the affine scan, (m) for the max scan.
// compose(x, prev) is x applied after prev; o may alias x or prev.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

struct Shape {
  int64_t n;         // rows
  int64_t n_tiles;   // row tiles
  int w;             // lanes
  int n_groups;      // lane groups of a row tile
  int vec;           // every float pointer 16-byte aligned (and W % 4 == 0)
  int fvec;          // the flags pointer 16-byte aligned
};

// Shared memory of one block: the tile's K arrays, two Kogge-Stone buffers
// of K x kItems floats, the tile carry of each lane, the flags, the sweep's
// start flags (two buffers of a byte per chunk) and each chunk's first start.
template <bool kMax, bool kNarrow>
constexpr size_t smem_bytes() {
  using G = Geo<kNarrow>;
  constexpr int K = Op<kMax>::K;
  return sizeof(float) * (K * G::kVals + 2 * K * G::kItems + K * 32) +
         G::kRows + 3 * G::kChunks;
}

// Tile t of group g is the block that draws t * n_groups + g from the
// counter.  status[0] is the counter, status[1 + slot] the slot's flag;
// carry[slot] holds K x 32 floats.
template <bool kMax, bool kNarrow>
__global__ void __launch_bounds__(1024)
    segscan_kernel(const uint8_t* __restrict__ flags,
                   const float* __restrict__ in0,
                   const float* __restrict__ in1, float* __restrict__ out0,
                   float* __restrict__ out1, unsigned* __restrict__ status,
                   float* __restrict__ carry, Shape s) {
  using O = Op<kMax>;
  using G = Geo<kNarrow>;
  constexpr int K = O::K, C = G::kChunks, L = G::kLanes, T = G::kRows;
  constexpr int kItems = G::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);   // [K][kVals]
  float* sk = sv + K * G::kVals;                // [2][K][kItems]
  float* sprev = sk + 2 * K * kItems;           // [K][32]
  uint8_t* sf = reinterpret_cast<uint8_t*>(sprev + K * 32);   // [T]
  uint8_t* sinc = sf + T;                       // [2][C]
  uint8_t* sfs = sinc + 2 * C;                  // [C]
  __shared__ unsigned s_tile;

  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) s_tile = atomicAdd(status, 1u);
  __syncthreads();
  const int64_t slot = s_tile;
  const int64_t t = slot / s.n_groups;
  const int g = static_cast<int>(slot - t * s.n_groups);
  const int64_t r0 = t * T;
  const int64_t left = s.n - r0;
  const int rows = left < T ? static_cast<int>(left) : T;
  const int lanes = kNarrow ? 1 : min(32, s.w - g * 32);
  const float* in[2] = {in0, in1};
  float* out[2] = {out0, out1};
  float id[2];
  O::identity(id);

  // 2. loads first: every copy is issued before the block waits on any
  if constexpr (kNarrow) {
    const int nv = s.vec ? rows & ~3 : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (int i = tid * 4; i < nv; i += nt * 4)
        cp_async16(sv + k * G::kVals + G::at(i, 0), in[k] + r0 + i);
      for (int i = nv + tid; i < rows; i += nt)
        cp_async4(sv + k * G::kVals + G::at(i, 0), in[k] + r0 + i);
    }
    for (int i = rows + tid; i < T; i += nt)
#pragma unroll
      for (int k = 0; k < K; ++k) sv[k * G::kVals + G::at(i, 0)] = id[k];
  } else {
    const int64_t base = r0 * s.w + g * 32;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* src = in[k] + base;
      float* dst = sv + k * G::kVals;
      if (s.vec) {
        const int q = lanes >> 2;
        for (int i = tid; i < rows * q; i += nt) {
          const int r = lanes == 32 ? i >> 3 : i / q;
          const int c4 = (i - r * q) * 4;
          cp_async16(dst + r * 32 + c4, src + r * s.w + c4);
        }
      } else {
        for (int i = tid; i < rows * lanes; i += nt) {
          const int r = i / lanes, l = i - r * lanes;
          cp_async4(dst + r * 32 + l, src + r * s.w + l);
        }
      }
    }
    if (rows < T || lanes < 32)
      for (int i = tid; i < T * 32; i += nt) {
        const int r = i >> 5, l = i & 31;
        if (r >= rows || l >= lanes)
#pragma unroll
          for (int k = 0; k < K; ++k) sv[k * G::kVals + i] = id[k];
      }
  }
  {
    const int nf = s.fvec ? rows & ~15 : 0;
    for (int i = tid * 16; i < nf; i += nt * 16)
      cp_async16(sf + i, flags + r0 + i);
    for (int i = nf + tid; i < T; i += nt) sf[i] = i < rows ? flags[r0 + i] : 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. each (chunk, lane) item scans its 16 rows; the local exclusive result
  // replaces the inputs, the chunk aggregate goes to sweep buffer 0
  for (int it = tid; it < kItems; it += nt) {
    const int c = kNarrow ? it : it >> 5, l = kNarrow ? 0 : it & 31;
    const uint4 fw = *reinterpret_cast<const uint4*>(sf + c * kChunkRows);
    const unsigned fwords[4] = {fw.x, fw.y, fw.z, fw.w};
    float x[K][kChunkRows];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* src = sv + k * G::kVals;
      if constexpr (kNarrow) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              src + c * G::kStride + q * 4);
          x[k][q * 4] = v.x;
          x[k][q * 4 + 1] = v.y;
          x[k][q * 4 + 2] = v.z;
          x[k][q * 4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j)
          x[k][j] = src[G::at(c * kChunkRows + j, l)];
      }
    }
    float cur[K];
    O::identity(cur);
    int first = kChunkRows;
#pragma unroll
    for (int j = 0; j < kChunkRows; ++j) {
      if ((fwords[j >> 2] >> ((j & 3) * 8)) & 0xff) {
        O::identity(cur);
        first = min(first, j);
      }
      float xj[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xj[k] = x[k][j];
        x[k][j] = cur[k];
      }
      O::compose(xj, cur, cur);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float* dst = sv + k * G::kVals;
      if constexpr (kNarrow) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(dst + c * G::kStride + q * 4) =
              make_float4(x[k][q * 4], x[k][q * 4 + 1], x[k][q * 4 + 2],
                          x[k][q * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j)
          dst[G::at(c * kChunkRows + j, l)] = x[k][j];
      }
      sk[k * kItems + it] = cur[k];
    }
    if (l == 0) {
      sinc[c] = first < kChunkRows;
      sfs[c] = static_cast<uint8_t>(first);
    }
  }
  __syncthreads();

  // the chunk aggregates' segmented Kogge-Stone sweep over the chunk index,
  // inclusive: a fixed tree, whatever the block size
  int cb = 0;
  for (int d = 1; d < C; d <<= 1) {
    const float* src = sk + cb * K * kItems;
    float* dst = sk + (cb ^ 1) * K * kItems;
    const uint8_t* fsrc = sinc + cb * C;
    uint8_t* fdst = sinc + (cb ^ 1) * C;
    for (int it = tid; it < kItems; it += nt) {
      const int c = kNarrow ? it : it >> 5, l = kNarrow ? 0 : it & 31;
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = src[k * kItems + it];
      uint8_t f = fsrc[c];
      if (!f && c >= d) {
        float pv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) pv[k] = src[k * kItems + it - d * L];
        O::compose(v, pv, v);
        f = fsrc[c - d];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) dst[k * kItems + it] = v[k];
      if (l == 0) fdst[c] = f;
    }
    cb ^= 1;
    __syncthreads();
  }
  const float* inc = sk + cb * K * kItems;
  const uint8_t* incf = sinc + cb * C;

  // 4. the carry across tiles: warp 0 publishes I_t and fetches I_{t-1}
  if (tid < 32) {
    const int l = tid;
    float agg[K], prev[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      agg[k] = l < L ? inc[k * kItems + (C - 1) * L + l] : id[k];
    O::identity(prev);
    const int64_t pslot = t > 0 ? slot - s.n_groups : slot;
    const unsigned* pstat = status + 1 + pslot;
    const float* pcarry = carry + pslot * K * 32;
    bool have = false;
    if (!incf[C - 1] && t > 0) {
      while (ld_acquire(pstat) == 0) {
      }
#pragma unroll
      for (int k = 0; k < K; ++k) prev[k] = __ldcg(pcarry + k * 32 + l);
      have = true;
      O::compose(agg, prev, agg);
    }
    if (t + 1 < s.n_tiles) {
      float* mine = carry + slot * K * 32;
#pragma unroll
      for (int k = 0; k < K; ++k) __stcg(mine + k * 32 + l, agg[k]);
      __threadfence();
      __syncwarp();
      if (l == 0) st_release(status + 1 + slot, 1u);
    }
    if (!have && t > 0 && !sf[0]) {
      while (ld_acquire(pstat) == 0) {
      }
#pragma unroll
      for (int k = 0; k < K; ++k) prev[k] = __ldcg(pcarry + k * 32 + l);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) sprev[k * 32 + l] = prev[k];
  }
  __syncthreads();

  // 5. write-out.  fix(c, l, v): a row of chunk c before the chunk's first
  // start gets the chunk's carry composed in: the inclusive sweep value of
  // chunk c - 1, after the tile carry where no start precedes it in the tile
  auto fix = [&](int c, int l, float* v) {
    float fc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) fc[k] = sprev[k * 32 + l];
    if (c > 0) {
      float cin[K];
#pragma unroll
      for (int k = 0; k < K; ++k) cin[k] = inc[k * kItems + (c - 1) * L + l];
      if (incf[c - 1]) {
#pragma unroll
        for (int k = 0; k < K; ++k) fc[k] = cin[k];
      } else {
        O::compose(cin, fc, fc);
      }
    }
    O::compose(v, fc, v);
  };
  // fix4: the same for the 4 elements of a 16-byte store, element j at row
  // (within chunk c) row0 + j * drow and lane l0 + j * dl
  auto fix4 = [&](float4* v, int c, int row0, int drow, int l0, int dl) {
    if (row0 >= sfs[c]) return;
    float e[4][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[0][k] = v[k].x;
      e[1][k] = v[k].y;
      e[2][k] = v[k].z;
      e[3][k] = v[k].w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (row0 + j * drow < sfs[c]) fix(c, l0 + j * dl, e[j]);
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = make_float4(e[0][k], e[1][k], e[2][k], e[3][k]);
  };
  if constexpr (kNarrow) {
    const int nv = s.vec ? rows & ~3 : 0;
    for (int i = tid * 4; i < nv; i += nt * 4) {
      float4 v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = *reinterpret_cast<const float4*>(sv + k * G::kVals +
                                                G::at(i, 0));
      fix4(v, i >> 4, i & 15, 1, 0, 0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        *reinterpret_cast<float4*>(out[k] + r0 + i) = v[k];
    }
    for (int i = nv + tid; i < rows; i += nt) {
      float e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = sv[k * G::kVals + G::at(i, 0)];
      if ((i & 15) < sfs[i >> 4]) fix(i >> 4, 0, e);
#pragma unroll
      for (int k = 0; k < K; ++k) out[k][r0 + i] = e[k];
    }
  } else {
    const int64_t base = r0 * s.w + g * 32;
    if (s.vec) {
      const int q = lanes >> 2;
      for (int i = tid; i < rows * q; i += nt) {
        const int r = lanes == 32 ? i >> 3 : i / q;
        const int c4 = (i - r * q) * 4;
        float4 v[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          v[k] = *reinterpret_cast<const float4*>(sv + k * G::kVals + r * 32 +
                                                  c4);
        fix4(v, r >> 4, r & 15, 0, c4, 1);
#pragma unroll
        for (int k = 0; k < K; ++k)
          *reinterpret_cast<float4*>(out[k] + base + r * s.w + c4) = v[k];
      }
    } else {
      for (int i = tid; i < rows * lanes; i += nt) {
        const int r = i / lanes, l = i - r * lanes, c = r >> 4;
        float e[K];
#pragma unroll
        for (int k = 0; k < K; ++k) e[k] = sv[k * G::kVals + r * 32 + l];
        if ((r & 15) < sfs[c]) fix(c, l, e);
#pragma unroll
        for (int k = 0; k < K; ++k) out[k][base + r * s.w + l] = e[k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kMax, bool kNarrow>
int launch(const uint8_t* flags, const float* in0, const float* in1,
           float* out0, float* out1, unsigned* status, float* carry,
           int64_t slots, int64_t n, int w, int threads, cudaStream_t st) {
  constexpr int T = Geo<kNarrow>::kRows;
  Shape s{};
  s.n = n;
  s.w = w;
  s.n_tiles = (n + T - 1) / T;
  s.n_groups = (w + 31) / 32;
  s.vec = aligned16(in0) && aligned16(out0) &&
          (kMax || (aligned16(in1) && aligned16(out1))) &&
          (kNarrow || w % 4 == 0);
  s.fvec = aligned16(flags);
  const int64_t blocks = s.n_tiles * s.n_groups;
  if (blocks > slots || blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = segscan_kernel<kMax, kNarrow>;
  constexpr size_t smem = smem_bytes<kMax, kNarrow>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      flags, in0, in1, out0, out1, status, carry, s);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMax>
int dispatch(const void* flags, const void* in0, const void* in1, void* out0,
             void* out1, void* status, void* carry, int64_t slots, int64_t n,
             int w, int threads, void* stream) {
  auto f = w == 1 ? launch<kMax, true> : launch<kMax, false>;
  return f(static_cast<const uint8_t*>(flags), static_cast<const float*>(in0),
           static_cast<const float*>(in1), static_cast<float*>(out0),
           static_cast<float*>(out1), static_cast<unsigned*>(status),
           static_cast<float*>(carry), slots, n, w, threads,
           static_cast<cudaStream_t>(stream));
}

}  // namespace

// Scratch of both entries, for `slots` >= ceil(n / 256) * ceil(w / 32) tile
// slots (256 rows is the smallest tile): status, u32[1 + slots], zeroed;
// carry, f32[slots, K, 32] (K = 2 for affine, 1 for max), uninitialised.

// flags: u8[n]; a, b, A, B: f32[n, w].
REPRO_EXPORT int segscan_affine(const void* flags, const void* a, const void* b,
                                void* A, void* B, void* status, void* carry,
                                int64_t slots, int64_t n, int w, int threads,
                                void* stream) {
  return dispatch<false>(flags, a, b, A, B, status, carry, slots, n, w,
                         threads, stream);
}

// flags: u8[n]; m, M: f32[n, w].
REPRO_EXPORT int segscan_max(const void* flags, const void* m, void* M,
                             void* status, void* carry, int64_t slots,
                             int64_t n, int w, int threads, void* stream) {
  return dispatch<true>(flags, m, nullptr, M, nullptr, status, carry, slots,
                        n, w, threads, stream);
}
