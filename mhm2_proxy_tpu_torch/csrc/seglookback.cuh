// Segmented group sums over lexsorted rows in one pass with a decoupled
// look-back: the pieces that scan.cu and finalize.cu share.
//
// A row carries nine values (count, four left one-hots, four right
// one-hots) and a group-start flag; the segmented operator (f1, x1) . (f2,
// x2) = (f1 | f2, f2 ? x2 : x1 + x2) gives each row its group's inclusive
// sums. The adds saturate: where the clamp is <= 0xFFFF the nine sums are
// 16-bit halves of five words (NW = 5), added with unsigned saturation
// (__vaddus2) after each input is clamped at 0xFFFF, and for x >= 0
// min(sum min(x, F), F) = min(sum x, F), so the result is the reference's
// clamp of the exact sum; the 32-bit form (NW = 9) saturates at INT32_MAX.
//
// A 256-thread block takes a 2048-row tile by atomic ticket (lookback.cuh:
// Hopper starts blocks in no order, and a look-back needs earlier tiles to
// be live) and holds its rows in registers, 8 consecutive rows a thread
// (load_rows: 16-byte loads where the lane is 16-byte aligned). tile_scan
// reduces them to the tile's aggregate (a start flag and the sums since
// the tile's last start), publishes it, and warp 0 looks back over the
// predecessors' status words, 32 at a time, to the nearest tile that has
// published its inclusive prefix or holds a group start: the sums of the
// tiles after that one are the tile's carry. A tile that holds a start
// publishes its inclusive prefix at once, so a chain of waits is only as
// long as a group. A status word is generation << 3 | flag << 2 | state,
// written with release order after the tile's values; readers load it
// with acquire order, so no memset runs between calls.
#pragma once

#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kSegThreads = 256;
constexpr int kSegItems = 8;                       // consecutive rows a thread
constexpr int kSegTile = kSegThreads * kSegItems;  // 2048 rows a tile
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegMaxWords = 9;                    // the 32-bit form's words a row
constexpr uint32_t kHalfMax = 0xFFFFu;

// The look-back scratch: per tile a status word and 2 * kSegMaxWords value
// words (the tile's aggregate, then its inclusive prefix).
struct LookBack {
  unsigned long long* status;
  uint32_t* vals;
  int* ticket;
  unsigned long long gen;
  int64_t T;
};

// a range's sums: NW = 5 (nine 16-bit sums, saturating at 0xFFFF) or NW = 9
// (32-bit sums saturating at INT32_MAX); f: a group starts in the range
template <int NW>
struct Seg {
  uint32_t f;
  uint32_t w[NW];
};

template <int NW>
__device__ __forceinline__ uint32_t sat(uint32_t a, uint32_t b) {
  if (NW == 5) return __vaddus2(a, b);
  const uint32_t s = a + b;  // both <= INT32_MAX: no wrap
  return s > 0x7FFFFFFFu ? 0x7FFFFFFFu : s;
}

template <int NW>
__device__ __forceinline__ Seg<NW> seg_zero() {
  Seg<NW> s;
  s.f = 0;
#pragma unroll
  for (int c = 0; c < NW; ++c) s.w[c] = 0;
  return s;
}

// a precedes b
template <int NW>
__device__ __forceinline__ Seg<NW> combine(const Seg<NW>& a, const Seg<NW>& b) {
  Seg<NW> r;
  r.f = a.f | b.f;
#pragma unroll
  for (int c = 0; c < NW; ++c) r.w[c] = b.f ? b.w[c] : sat<NW>(a.w[c], b.w[c]);
  return r;
}

template <int NW>
__device__ __forceinline__ Seg<NW> shfl_up(const Seg<NW>& x, int off) {
  Seg<NW> r;
  r.f = __shfl_up_sync(0xffffffffu, x.f, off);
#pragma unroll
  for (int c = 0; c < NW; ++c) r.w[c] = __shfl_up_sync(0xffffffffu, x.w[c], off);
  return r;
}

// one thread: the tile's values, then its status word (release order)
template <int NW>
__device__ __forceinline__ void publish(const LookBack& lb, int64_t t, unsigned long long state,
                                        uint32_t f, const uint32_t (&w)[NW]) {
  uint32_t* v = lb.vals + t * (2 * kSegMaxWords) + (state == kPrefix ? kSegMaxWords : 0);
#pragma unroll
  for (int c = 0; c < NW; ++c) v[c] = w[c];
  st_release(lb.status + t, (lb.gen << 3) | ((unsigned long long)f << 2) | state);
}

// warp 0: the sums carried into tile t, from the nearest predecessor that
// has its inclusive prefix or holds a group start, and every tile after it
template <int NW>
__device__ void look_back(const LookBack& lb, int64_t t, uint32_t (&excl)[NW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NW; ++c) excl[c] = 0;
  for (int64_t p = t - 1;; p -= 32) {
    const int64_t idx = p - lane;
    unsigned long long s = 0;
    if (idx >= 0) s = wait_status<true>(lb.status + idx, lb.gen, 3, 0);
    const bool stop = idx < 0 || (s & 3ull) == kPrefix || ((s >> 2) & 1ull);
    const unsigned m = __ballot_sync(0xffffffffu, stop);
    const int last = m ? __ffs(m) - 1 : 31;
    uint32_t x[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) x[c] = 0;
    if (lane <= last && idx >= 0) {
      const uint32_t* v =
          lb.vals + idx * (2 * kSegMaxWords) + ((s & 3ull) == kPrefix ? kSegMaxWords : 0);
#pragma unroll
      for (int c = 0; c < NW; ++c) x[c] = __ldcg(v + c);
    }
    // no group starts between the tiles summed: saturating adds commute
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < NW; ++c) x[c] = sat<NW>(x[c], __shfl_xor_sync(0xffffffffu, x[c], o));
    }
#pragma unroll
    for (int c = 0; c < NW; ++c) excl[c] = sat<NW>(excl[c], x[c]);
    if (m) return;
  }
}

template <int NW>
struct TileShared {
  Seg<NW> warp[kSegWarps];
  uint32_t excl[NW];
  int first_start;
};

// Every thread: its kSegItems rows' values v (start flags: bits of fl) become
// their inclusive segmented sums, carried in from the tiles before t.
template <int NW>
__device__ __forceinline__ void tile_scan(const LookBack& lb, int64_t t, uint32_t fl,
                                          uint32_t (&v)[kSegItems][NW], TileShared<NW>& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Seg<NW> agg = seg_zero<NW>();
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    Seg<NW> e;
    e.f = (fl >> q) & 1u;
#pragma unroll
    for (int c = 0; c < NW; ++c) e.w[c] = v[q][c];
    agg = combine(agg, e);
  }
  Seg<NW> inc = agg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg<NW> o = shfl_up(inc, off);
    if (lane >= off) inc = combine(o, inc);
  }
  const Seg<NW> lane_prev = shfl_up(inc, 1);
  if (lane == 31) sh.warp[warp] = inc;
  if (tid == 0) sh.first_start = fl & 1u;
  __syncthreads();
  Seg<NW> ex = seg_zero<NW>();
  for (int w = 0; w < warp; ++w) ex = combine(ex, sh.warp[w]);
  if (lane > 0) ex = combine(ex, lane_prev);
  if (warp == 0) {
    Seg<NW> tot = seg_zero<NW>();
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) tot = combine(tot, sh.warp[w]);
    // a tile that holds a start knows its inclusive prefix without a carry
    const bool direct = t == 0 || tot.f;
    if (lane == 0) publish<NW>(lb, t, direct ? kPrefix : kAggregate, tot.f, tot.w);
    uint32_t excl[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) excl[c] = 0;
    if (t > 0 && !sh.first_start) look_back<NW>(lb, t, excl);
    if (lane == 0) {
      if (!direct) {
        uint32_t incl[NW];
#pragma unroll
        for (int c = 0; c < NW; ++c) incl[c] = sat<NW>(excl[c], tot.w[c]);
        publish<NW>(lb, t, kPrefix, tot.f, incl);
      }
#pragma unroll
      for (int c = 0; c < NW; ++c) sh.excl[c] = excl[c];
    }
  }
  __syncthreads();
  Seg<NW> run;
  run.f = 0;
#pragma unroll
  for (int c = 0; c < NW; ++c) run.w[c] = sh.excl[c];
  run = combine(run, ex);
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    Seg<NW> e;
    e.f = (fl >> q) & 1u;
#pragma unroll
    for (int c = 0; c < NW; ++c) e.w[c] = v[q][c];
    run = combine(run, e);
#pragma unroll
    for (int c = 0; c < NW; ++c) v[q][c] = run.w[c];
  }
}

// kSegItems u32 of rows row0.. of lane p (0 past N): two 16-byte loads when the
// whole run lies inside N and the lane is 16-byte aligned
__device__ __forceinline__ void load_rows(const uint32_t* p, int64_t row0, int64_t N, bool vec,
                                          uint32_t (&x)[kSegItems]) {
  if (vec && row0 + kSegItems <= N) {
    const uint4 a = __ldcs((const uint4*)(p + row0));
    const uint4 b = __ldcs((const uint4*)(p + row0) + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) x[q] = row0 + q < N ? p[row0 + q] : 0u;
  }
}

__device__ __forceinline__ void store_rows(uint32_t* p, int64_t row0, int64_t N, bool vec,
                                           const uint32_t (&x)[kSegItems]) {
  if (vec && row0 + kSegItems <= N) {
    __stcs((uint4*)(p + row0), make_uint4(x[0], x[1], x[2], x[3]));
    __stcs((uint4*)(p + row0) + 1, make_uint4(x[4], x[5], x[6], x[7]));
  } else {
#pragma unroll
    for (int q = 0; q < kSegItems; ++q)
      if (row0 + q < N) p[row0 + q] = x[q];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// the look-back scratch of a call over N rows (T = ceil(N / 2048) tiles)
LookBack make_look_back(int64_t N, void* status, void* vals, void* ticket, int64_t gen) {
  LookBack lb;
  lb.status = (unsigned long long*)status;
  lb.vals = (uint32_t*)vals;
  lb.ticket = (int*)ticket;
  lb.gen = (unsigned long long)gen;
  lb.T = (N + kSegTile - 1) / kSegTile;
  return lb;
}

}  // namespace
