// scan: segmented group sums over lexsorted rows, one pass.
//
// Replaces mhm2_proxy_tpu/ops/pallas_scan.py:245 `group_sums_scan_packed`
// (kernel body `_packed_scan_kernel`, :163) and :277 `group_sums_scan_lanes`
// (`_scan_kernel`, :79, over `seg_group_sums`, :105). Two entry points:
//   lanes:  n_pay <= 9 int32 payload lanes (values >= 0) and a group-start
//           flag per row -> each lane's inclusive group sum up to the row,
//           clamped;
//   packed: weff sorted packed record lanes (the 7-bit read payload in the
//           last lane's free low bits, all-ones sentinels) -> the count and
//           ext one-hot group sums, clamped, as the five lanes of
//           ops/count.py::_pack_sums. Group starts and one-hots come from
//           the key bits, as in the TPU kernel.
// Both are valid at group-last rows, which is where callers read them.
//
// What bounds it on an H100: memory. The function reads its input lanes
// once and writes its output lanes once: the lanes form 9 x 4 + 1 + 9 x 4
// bytes a row, the packed one 4 weff + 20. The segmented operator is a few
// integer operations a value.
// Design: one launch with a decoupled look-back. A 256-thread block takes a
// 2048-row tile by atomic ticket (Hopper starts blocks in no order, and a
// look-back needs earlier tiles to be live) and loads its rows once into
// registers, 8 consecutive rows a thread (16-byte loads where the lane is
// 16-byte aligned). It reduces them to the tile's aggregate (a start flag
// and the sums since the tile's last start), publishes it, and warp 0
// looks back over the predecessors' status words, 32 at a time, to the
// nearest tile that has published its inclusive prefix or holds a group
// start: the sums of the tiles after that one are the tile's carry. A tile
// that holds a start publishes its inclusive prefix at once, so a chain of
// waits is only as long as a group. A status word is generation | flag |
// state, written with release order after the tile's values; readers load
// it with acquire order, so no memset runs between calls. The rows' sums
// then come from the rows still in registers, and are stored once.
// Where the clamp is <= 0xFFFF (every caller: MAX_KMER_COUNT) the nine sums
// are 16-bit halves of five words, added with unsigned saturation
// (__vaddus2) after each input is clamped at 0xFFFF: for x >= 0,
// min(sum min(x, F), F) = min(sum x, F), so the result is the reference's
// clamp of the exact sum, and each scan step moves six words, not ten. A
// larger clamp takes the 32-bit form, which saturates at INT32_MAX. Lane
// counts are template parameters (a runtime lane index would put the lane
// pointers in local memory). The packed form masks the payload bits with a
// plain AND: the TPU kernel's subtraction form dodges a Mosaic miscompile
// only.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // consecutive rows a thread
constexpr int kTile = kThreads * kItems;  // 2048 rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 9;              // the 32-bit form's words a row
constexpr uint32_t kHalfMax = 0xFFFFu;

// status word (lookback.cuh): generation << 3 | tile holds a group start
// << 2 | state

// The look-back scratch: per tile a status word and 2 * kMaxWords value
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
  uint32_t* v = lb.vals + t * (2 * kMaxWords) + (state == kPrefix ? kMaxWords : 0);
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
          lb.vals + idx * (2 * kMaxWords) + ((s & 3ull) == kPrefix ? kMaxWords : 0);
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
  Seg<NW> warp[kWarps];
  uint32_t excl[NW];
  int first_start;
};

// Every thread: its kItems rows' values v (start flags: bits of fl) become
// their inclusive segmented sums, carried in from the tiles before t.
template <int NW>
__device__ __forceinline__ void tile_scan(const LookBack& lb, int64_t t, uint32_t fl,
                                          uint32_t (&v)[kItems][NW], TileShared<NW>& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Seg<NW> agg = seg_zero<NW>();
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
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
    for (int w = 0; w < kWarps; ++w) tot = combine(tot, sh.warp[w]);
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
  for (int q = 0; q < kItems; ++q) {
    Seg<NW> e;
    e.f = (fl >> q) & 1u;
#pragma unroll
    for (int c = 0; c < NW; ++c) e.w[c] = v[q][c];
    run = combine(run, e);
#pragma unroll
    for (int c = 0; c < NW; ++c) v[q][c] = run.w[c];
  }
}

// kItems u32 of rows row0.. of lane p (0 past N): two 16-byte loads when the
// whole run lies inside N and the lane is 16-byte aligned
__device__ __forceinline__ void load_rows(const uint32_t* p, int64_t row0, int64_t N, bool vec,
                                          uint32_t (&x)[kItems]) {
  if (vec && row0 + kItems <= N) {
    const uint4 a = __ldcs((const uint4*)(p + row0));
    const uint4 b = __ldcs((const uint4*)(p + row0) + 1);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < kItems; ++q) x[q] = row0 + q < N ? p[row0 + q] : 0u;
  }
}

__device__ __forceinline__ void store_rows(uint32_t* p, int64_t row0, int64_t N, bool vec,
                                           const uint32_t (&x)[kItems]) {
  if (vec && row0 + kItems <= N) {
    __stcs((uint4*)(p + row0), make_uint4(x[0], x[1], x[2], x[3]));
    __stcs((uint4*)(p + row0) + 1, make_uint4(x[4], x[5], x[6], x[7]));
  } else {
#pragma unroll
    for (int q = 0; q < kItems; ++q)
      if (row0 + q < N) p[row0 + q] = x[q];
  }
}

struct LanesArgs {
  CLanes pay;
  const uint8_t* start;
  Lanes out;
  int64_t N;
  uint32_t clamp;
  unsigned aligned;  // bit c: pay lane c 16-byte aligned; bit 16 + c: out lane c
  int start_aligned;
  LookBack lb;
};

// NPAY payload lanes; NW = 5: lane c in half c & 1 of word c >> 1
template <int NPAY, int NW>
__global__ void __launch_bounds__(kThreads) scan_lanes_kernel(const __grid_constant__ LanesArgs a) {
  __shared__ TileShared<NW> sh;
  __shared__ int64_t s_tile;
  const int64_t t = take_tile(a.lb.ticket, a.lb.T, &s_tile);
  const int64_t row0 = t * kTile + (int64_t)threadIdx.x * kItems;
  uint32_t fl = 0;
  if (a.start_aligned && row0 + kItems <= a.N) {
    const uint2 b = __ldcs((const uint2*)(a.start + row0));
#pragma unroll
    for (int q = 0; q < kItems; ++q) fl |= (((q < 4 ? b.x : b.y) >> (8 * (q & 3))) & 0xFFu) ? 1u << q : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < kItems; ++q) fl |= (row0 + q < a.N && a.start[row0 + q]) ? 1u << q : 0u;
  }
  uint32_t v[kItems][NW];
#pragma unroll
  for (int q = 0; q < kItems; ++q)
#pragma unroll
    for (int c = 0; c < NW; ++c) v[q][c] = 0;
#pragma unroll
  for (int c = 0; c < NPAY; ++c) {
    uint32_t x[kItems];
    load_rows(a.pay.p[c], row0, a.N, (a.aligned >> c) & 1u, x);
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (NW == 5)
        v[q][c >> 1] |= (x[q] < kHalfMax ? x[q] : kHalfMax) << (16 * (c & 1));
      else
        v[q][c] = x[q];
    }
  }
  tile_scan<NW>(a.lb, t, fl, v, sh);
#pragma unroll
  for (int c = 0; c < NPAY; ++c) {
    uint32_t y[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const uint32_t s = NW == 5 ? (v[q][c >> 1] >> (16 * (c & 1))) & kHalfMax : v[q][c];
      y[q] = s < a.clamp ? s : a.clamp;
    }
    store_rows(a.out.p[c], row0, a.N, (a.aligned >> (16 + c)) & 1u, y);
  }
}

struct PackedArgs {
  CLanes in;
  Lanes out;
  int64_t N;
  uint32_t keymask;
  uint32_t clamp2;   // the clamp in both halves
  unsigned aligned;  // bit l: in lane l 16-byte aligned; bit 16 + l: out lane l
  LookBack lb;
};

template <int WEFF>
__global__ void __launch_bounds__(kThreads) scan_packed_kernel(const __grid_constant__ PackedArgs a) {
  __shared__ TileShared<5> sh;
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_key[kThreads][WEFF];  // each thread's last key
  const int64_t t = take_tile(a.lb.ticket, a.lb.T, &s_tile);
  const int tid = threadIdx.x;
  const int64_t row0 = t * kTile + (int64_t)tid * kItems;
  uint32_t k[kItems][WEFF];
#pragma unroll
  for (int l = 0; l < WEFF; ++l) {
    uint32_t x[kItems];
    load_rows(a.in.p[l], row0, a.N, (a.aligned >> l) & 1u, x);
#pragma unroll
    for (int q = 0; q < kItems; ++q) k[q][l] = x[q];
  }
  uint32_t last_raw[kItems];  // the key bits and the read payload
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    last_raw[q] = k[q][WEFF - 1];
    k[q][WEFF - 1] &= a.keymask;
  }
#pragma unroll
  for (int l = 0; l < WEFF; ++l) s_key[tid][l] = k[kItems - 1][l];
  __syncthreads();
  // the key of the row before this thread's first
  uint32_t prev[WEFF];
  bool have_prev = true;
  if (tid > 0) {
#pragma unroll
    for (int l = 0; l < WEFF; ++l) prev[l] = s_key[tid - 1][l];
  } else if (row0 > 0 && row0 < a.N) {
#pragma unroll
    for (int l = 0; l < WEFF; ++l) prev[l] = a.in.p[l][row0 - 1];
    prev[WEFF - 1] &= a.keymask;
  } else {
    have_prev = false;
#pragma unroll
    for (int l = 0; l < WEFF; ++l) prev[l] = 0;
  }
  uint32_t fl = 0;
  uint32_t v[kItems][5];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    bool same = q > 0 || have_prev;
    bool sent = k[q][WEFF - 1] == a.keymask;
#pragma unroll
    for (int l = 0; l < WEFF; ++l) {
      same = same && k[q][l] == (q > 0 ? k[q - 1][l] : prev[l]);
      if (l < WEFF - 1) sent = sent && k[q][l] == 0xFFFFFFFFu;
    }
    const bool live = row0 + q < a.N;
    fl |= (live && !same) ? 1u << q : 0u;
    const uint32_t cnt = (live && !sent) ? 1u : 0u;
    const uint32_t left = (last_raw[q] >> 1) & 7u, right = (last_raw[q] >> 4) & 7u;
    v[q][0] = cnt;
    v[q][1] = (left == 0 ? cnt : 0u) | ((left == 1 ? cnt : 0u) << 16);
    v[q][2] = (left == 2 ? cnt : 0u) | ((left == 3 ? cnt : 0u) << 16);
    v[q][3] = (right == 0 ? cnt : 0u) | ((right == 1 ? cnt : 0u) << 16);
    v[q][4] = (right == 2 ? cnt : 0u) | ((right == 3 ? cnt : 0u) << 16);
  }
  tile_scan<5>(a.lb, t, fl, v, sh);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    uint32_t y[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) y[q] = __vminu2(v[q][c], a.clamp2);
    store_rows(a.out.p[c], row0, a.N, (a.aligned >> (16 + c)) & 1u, y);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

unsigned aligned_mask(const void* const* in, int n_in, void* const* out, int n_out) {
  unsigned m = 0;
  for (int i = 0; i < n_in; ++i) m |= aligned16(in[i]) ? 1u << i : 0u;
  for (int i = 0; i < n_out; ++i) m |= aligned16(out[i]) ? 1u << (16 + i) : 0u;
  return m;
}

template <int NW, int NPAY>
void launch_lanes(const LanesArgs& a, cudaStream_t s) {
  scan_lanes_kernel<NPAY, NW><<<(unsigned)a.lb.T, kThreads, 0, s>>>(a);
}

template <int NW>
int launch_lanes_n(int n_pay, const LanesArgs& a, cudaStream_t s) {
  switch (n_pay) {
    case 1: launch_lanes<NW, 1>(a, s); break;
    case 2: launch_lanes<NW, 2>(a, s); break;
    case 3: launch_lanes<NW, 3>(a, s); break;
    case 4: launch_lanes<NW, 4>(a, s); break;
    case 5: launch_lanes<NW, 5>(a, s); break;
    case 6: launch_lanes<NW, 6>(a, s); break;
    case 7: launch_lanes<NW, 7>(a, s); break;
    case 8: launch_lanes<NW, 8>(a, s); break;
    case 9: launch_lanes<NW, 9>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

LookBack make_look_back(int64_t N, void* status, void* vals, void* ticket, int64_t gen) {
  LookBack lb;
  lb.status = (unsigned long long*)status;
  lb.vals = (uint32_t*)vals;
  lb.ticket = (int*)ticket;
  lb.gen = (unsigned long long)gen;
  lb.T = (N + kTile - 1) / kTile;
  return lb;
}

}  // namespace

// pay: n_pay (<= 9) int32 lanes of N rows, values >= 0; start: (N,) bool;
// outs: n_pay int32 lanes; status: >= T u64 words, zero or of earlier
// generations; vals: T * 18 u32; ticket: one int32, 0 between calls; gen in
// [1, 2^31), one more than the last call's (T = ceil(N / 2048)).
// 0 <= clamp; clamp <= 0xFFFF takes the 16-bit form.
extern "C" int mhm2_scan_lanes(const void* const* pay, int n_pay, const void* start, int64_t N,
                               int clamp, void* const* outs, void* status, int64_t status_words,
                               void* vals, void* ticket, int64_t gen, void* stream) {
  MHM2_REQUIRE(n_pay >= 1 && n_pay <= kMaxWords && clamp >= 0 && N >= 0 && N < (1ll << 31));
  MHM2_REQUIRE(gen >= 1 && gen < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  LanesArgs a;
  a.pay = make_clanes(pay, n_pay);
  a.start = (const uint8_t*)start;
  a.out = make_lanes(outs, n_pay);
  a.N = N;
  a.clamp = (uint32_t)clamp;
  a.aligned = aligned_mask(pay, n_pay, outs, n_pay);
  a.start_aligned = ((uintptr_t)start & 7u) == 0;
  a.lb = make_look_back(N, status, vals, ticket, gen);
  MHM2_REQUIRE(status_words >= a.lb.T);
  cudaStream_t s = (cudaStream_t)stream;
  return clamp <= (int)kHalfMax ? launch_lanes_n<5>(n_pay, a, s) : launch_lanes_n<9>(n_pay, a, s);
}

// lanes: weff sorted packed lanes of N rows; keymask: the key bits of the
// last lane; outs: the 5 _pack_sums lanes of N rows; scratch as above.
// 0 <= clamp <= 0xFFFF (sums are packed in 16-bit fields).
extern "C" int mhm2_scan_packed(const void* const* lanes, int weff, int64_t N, uint32_t keymask,
                                int clamp, void* const* outs, void* status, int64_t status_words,
                                void* vals, void* ticket, int64_t gen, void* stream) {
  MHM2_REQUIRE(weff >= 1 && weff <= 7 && clamp >= 0 && clamp <= (int)kHalfMax);
  MHM2_REQUIRE(N >= 0 && N < (1ll << 31) && gen >= 1 && gen < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  PackedArgs a;
  a.in = make_clanes(lanes, weff);
  a.out = make_lanes(outs, 5);
  a.N = N;
  a.keymask = keymask;
  a.clamp2 = (uint32_t)clamp | ((uint32_t)clamp << 16);
  a.aligned = aligned_mask(lanes, weff, outs, 5);
  a.lb = make_look_back(N, status, vals, ticket, gen);
  MHM2_REQUIRE(status_words >= a.lb.T);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned T = (unsigned)a.lb.T;
  switch (weff) {
    case 1: scan_packed_kernel<1><<<T, kThreads, 0, s>>>(a); break;
    case 2: scan_packed_kernel<2><<<T, kThreads, 0, s>>>(a); break;
    case 3: scan_packed_kernel<3><<<T, kThreads, 0, s>>>(a); break;
    case 4: scan_packed_kernel<4><<<T, kThreads, 0, s>>>(a); break;
    case 5: scan_packed_kernel<5><<<T, kThreads, 0, s>>>(a); break;
    case 6: scan_packed_kernel<6><<<T, kThreads, 0, s>>>(a); break;
    case 7: scan_packed_kernel<7><<<T, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
