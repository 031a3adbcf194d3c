// Segmented group sums over lexsorted rows: finalize.cu's three-launch scan
// (scan.cu runs its own single pass with a decoupled look-back).
//
// A row carries nine non-negative int32 values (count, four left one-hots,
// four right one-hots) and a group-start flag.
// The segmented operator (f1, x1) . (f2, x2) = (f1 | f2, f2 ? x2 : x1 + x2)
// gives each row its group's inclusive sums. The adds saturate at INT32_MAX,
// so with non-negative values a later clamp at any c <= INT32_MAX equals the
// clamp of the exact sum (the reference clamps its exact sums at the end).
//
// CUDA blocks run in no order, so the TPU kernels' in-order carry from one
// grid step to the next has no counterpart. The scan is three launches:
//   seg_aggregate: each kTile-row block reduces its rows to one Seg;
//   seg_carry:     one block scans those aggregates into a carry-in per block;
//   <apply>:       each block rescans its rows from its carry-in
//                  (seg_block_rows) and writes its own outputs.
// Rows are produced by a Rows policy: `Seg row(int64_t r) const`.
#pragma once

#include "common.cuh"

namespace {

constexpr int kSegThreads = 256;
constexpr int kSegItems = 4;
constexpr int kSegTile = kSegThreads * kSegItems;
constexpr int kSegCarryThreads = 1024;
constexpr int kSegValues = 9;

struct Seg {
  int f;                // a group starts inside this range
  int v[kSegValues];    // sums since the last start (or over the whole range)
};

__device__ __forceinline__ Seg seg_zero() {
  Seg s;
  s.f = 0;
#pragma unroll
  for (int c = 0; c < kSegValues; ++c) s.v[c] = 0;
  return s;
}

__device__ __forceinline__ int sat_add(int a, int b) {
  const unsigned s = (unsigned)a + (unsigned)b;  // both >= 0: no wrap in 32 bits
  return s > 0x7FFFFFFFu ? 0x7FFFFFFF : (int)s;
}

// a precedes b
__device__ __forceinline__ Seg seg_combine(const Seg& a, const Seg& b) {
  Seg r;
  r.f = a.f | b.f;
#pragma unroll
  for (int c = 0; c < kSegValues; ++c) r.v[c] = b.f ? b.v[c] : sat_add(a.v[c], b.v[c]);
  return r;
}

__device__ __forceinline__ Seg seg_shfl_up(const Seg& x, int off) {
  Seg r;
  r.f = __shfl_up_sync(0xffffffffu, x.f, off);
#pragma unroll
  for (int c = 0; c < kSegValues; ++c) r.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], off);
  return r;
}

// Exclusive block scan (blockDim a multiple of 32): returns carry combined
// with the aggregates of all lower threads; *total = carry + everything.
__device__ Seg seg_block_exclusive(const Seg& x, const Seg& carry, Seg* swarp, Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  Seg inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg o = seg_shfl_up(inc, off);
    if (lane >= off) inc = seg_combine(o, inc);
  }
  if (lane == 31) swarp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg wi = lane < nwarps ? swarp[lane] : seg_zero();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Seg o = seg_shfl_up(wi, off);
      if (lane >= off) wi = seg_combine(o, wi);
    }
    Seg prev = seg_shfl_up(wi, 1);
    Seg ex = lane == 0 ? carry : seg_combine(carry, prev);
    if (lane < nwarps) swarp[lane] = ex;
    if (lane == nwarps - 1) *total = seg_combine(carry, wi);
  }
  __syncthreads();
  Seg lane_prev = seg_shfl_up(inc, 1);
  Seg res = lane == 0 ? swarp[warp] : seg_combine(swarp[warp], lane_prev);
  __syncthreads();
  return res;
}

__device__ __forceinline__ Seg seg_load_agg(const int* agg_f, const int* agg_v, int64_t u) {
  Seg s;
  s.f = agg_f[u];
#pragma unroll
  for (int c = 0; c < kSegValues; ++c) s.v[c] = agg_v[u * kSegValues + c];
  return s;
}

// (1) one Seg per kSegTile-row block: agg_f (T,), agg_v (T * 9,)
template <class Rows>
__global__ void seg_aggregate(Rows rows, int64_t N, int* agg_f, int* agg_v) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  const int64_t base = (int64_t)blockIdx.x * kSegTile + threadIdx.x * kSegItems;
  Seg x = seg_zero();
  for (int q = 0; q < kSegItems; ++q) {
    if (base + q < N) x = seg_combine(x, rows.row(base + q));
  }
  seg_block_exclusive(x, seg_zero(), swarp, &stotal);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = stotal.f;
#pragma unroll
    for (int c = 0; c < kSegValues; ++c) agg_v[(int64_t)blockIdx.x * kSegValues + c] = stotal.v[c];
  }
}

// (2) one block: carry[u] = sums since the last group start before block u
__global__ void seg_carry(const int* agg_f, const int* agg_v, int64_t T, int* carry) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  const int64_t chunk = (T + blockDim.x - 1) / blockDim.x;
  int64_t u0 = (int64_t)threadIdx.x * chunk;
  int64_t u1 = u0 + chunk < T ? u0 + chunk : T;
  if (u0 > T) u0 = T;
  Seg x = seg_zero();
  for (int64_t u = u0; u < u1; ++u) x = seg_combine(x, seg_load_agg(agg_f, agg_v, u));
  Seg run = seg_block_exclusive(x, seg_zero(), swarp, &stotal);
  for (int64_t u = u0; u < u1; ++u) {
#pragma unroll
    for (int c = 0; c < kSegValues; ++c) carry[u * kSegValues + c] = run.v[c];
    run = seg_combine(run, seg_load_agg(agg_f, agg_v, u));
  }
}

// (3), inside an apply kernel launched like seg_aggregate: the inclusive
// segmented sums of this thread's rows base .. base + kSegItems - 1 (rows
// past N are zero), from the block's carry-in. Every thread must call it.
template <class Rows>
__device__ __forceinline__ void seg_block_rows(const Rows& rows, int64_t N, const int* carry,
                                               int64_t base, Seg (&inc)[kSegItems]) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  Seg x = seg_zero();
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    inc[q] = base + q < N ? rows.row(base + q) : seg_zero();
    x = seg_combine(x, inc[q]);
  }
  Seg run;
  run.f = 0;
#pragma unroll
  for (int c = 0; c < kSegValues; ++c) run.v[c] = carry[(int64_t)blockIdx.x * kSegValues + c];
  run = seg_block_exclusive(x, run, swarp, &stotal);
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    run = seg_combine(run, inc[q]);
    inc[q] = run;
  }
}

// Rows of a sorted k-mer record run: WEFF key lanes, then in the packed
// layout (sep == 0) the 7-bit payload valid | left<<1 | right<<4 in the free
// low bits of the last key lane (keymask = its key bits; all-ones key bits
// mark a sentinel row), or in the separate-payload layout (sep == 1, keymask
// all-ones) one more lane count | left<<16 | right<<24 (count 0 marks a
// sentinel row). A row's values: count and the count on its left / right
// extension's one-hot; it starts a group where its key differs from the
// previous row's.
template <int WEFF>
struct KeyRows {
  CLanes in;
  uint32_t keymask;
  int sep;

  __device__ __forceinline__ void key(int64_t r, uint32_t (&k)[WEFF]) const {
#pragma unroll
    for (int l = 0; l < WEFF - 1; ++l) k[l] = in.p[l][r];
    k[WEFF - 1] = in.p[WEFF - 1][r] & keymask;
  }

  __device__ __forceinline__ bool same(const uint32_t (&a)[WEFF], int64_t r) const {
    uint32_t b[WEFF];
    key(r, b);
    bool eq = true;
#pragma unroll
    for (int l = 0; l < WEFF; ++l) eq = eq && (a[l] == b[l]);
    return eq;
  }

  __device__ __forceinline__ bool sentinel_key(const uint32_t (&k)[WEFF]) const {
    bool s = k[WEFF - 1] == keymask;
#pragma unroll
    for (int l = 0; l < WEFF - 1; ++l) s = s && (k[l] == 0xFFFFFFFFu);
    return s;
  }

  // count, left and right codes of row r (k: its key)
  __device__ __forceinline__ void payload(int64_t r, const uint32_t (&k)[WEFF], uint32_t& cnt,
                                         uint32_t& left, uint32_t& right) const {
    if (sep) {
      const uint32_t p = in.p[WEFF][r];
      cnt = p & 0xFFFFu;
      left = (p >> 16) & 7u;
      right = (p >> 24) & 7u;
    } else {
      const uint32_t s = in.p[WEFF - 1][r];
      cnt = sentinel_key(k) ? 0u : 1u;
      left = (s >> 1) & 7u;
      right = (s >> 4) & 7u;
    }
  }

  __device__ __forceinline__ Seg row(int64_t r) const {
    uint32_t k[WEFF];
    key(r, k);
    Seg e;
    e.f = (r == 0) || !same(k, r - 1);
    uint32_t cnt, left, right;
    payload(r, k, cnt, left, right);
    e.v[0] = (int)cnt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e.v[1 + j] = left == (uint32_t)j ? (int)cnt : 0;
      e.v[5 + j] = right == (uint32_t)j ? (int)cnt : 0;
    }
    return e;
  }
};

}  // namespace
