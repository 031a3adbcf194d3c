// finalize: group sums, extension calls, purge and compaction of a merged,
// sorted raw run into the final table, in one launch.
//
// Replaces mhm2_proxy_tpu/ops/pallas_finalize.py:246 `scan_purge_compact`
// (kernel body `_kernel`, :123) with the ragged_append that concatenates
// its tiles. Input: weff u32 lanes lexsorted, either in the packed layout
// (the 7-bit read payload valid | left<<1 | right<<4 in the last lane's
// free low bits, all-ones sentinel rows at the tail) or, for k whose
// payload does not fit the key bits (k = 63, 77), weff key lanes plus one
// count | left<<16 | right<<24 lane, 0 on sentinel rows (the reference's
// `pay` variant, :164-176). A row's group sums are the inclusive sums of
// (count, 4 left one-hots, 4 right one-hots) over its key's rows, clamped
// at 65535 (the reference's saturating sums, ops/count.py:203-216). A
// group's last row is kept unless it is a sentinel, and, with purge,
// unless its count is below 2 or both its extension calls are X
// (kcount_cpu.cpp:173-182, 497-517; ties T>G>C>A, integer dmin_dyn).
// Output: the kept rows in order as (N, W) words (the key lanes, payload
// bits cleared, then W - weff zero words), all-ones past the kept count;
// one count | lcall<<16 | rcall<<24 lane (purge) or the five
// ops/count.py::_pack_sums lanes (no purge), zero past the count; and the
// kept count.
//
// What bounds it on an H100: memory. It reads each input lane once and
// writes (W + n_pay) words a row over all N rows, kept rows in front and
// the fill behind them: 20 bytes a row at k = 21 with purge. The sums,
// calls, keep rule and destinations are ~35 integer operations a row.
// Design: one launch, which replaces the old pass's three launches, its
// N-row flag lane and the compact launch after it.
// - A 256-thread block takes a 2048-row tile by atomic ticket and loads
//   its rows once, 8 a thread (seglookback.cuh, as scan.cu; 16-byte loads
//   where aligned), together with the row before the tile (its first
//   row's group start) and the row after it (its last row's group end).
//   The keys then wait in shared memory for the kept rows' stores, so
//   that registers hold only the sums through the look-backs: a tile's
//   time is a chain of global round trips (ticket, loads, two look-backs),
//   and the blocks an SM holds at once are what hides them.
// - The nine sums are 16-bit saturating halves of five words through
//   seglookback.cuh's segmented look-back. At group-last rows the calls
//   and the keep rule come from the sums in registers.
// - A second look-back, unsegmented, counts the kept rows of the tiles
//   before (lookback.cuh's count_look_back, as compact.cu). A tile knows
//   its kept count only once its sums' carry has arrived, so it publishes
//   that count only then, and only then waits on its predecessors'
//   counts: every wait is on a tile that holds a lower ticket, whose own
//   waits are on lower tickets still, so the launch cannot deadlock.
// - Kept rows go straight to their output rows, a row's words in 8-byte
//   stores. The tile's other rows fill [N - q - r, N - q)
//   from the end of the output (q: the rows that earlier tiles dropped, r:
//   this tile's), as compact.cu does, so no tile waits for the total and
//   every output row is written once.
#include "seglookback.cuh"

namespace {

constexpr uint32_t kExtF = 4;
constexpr uint32_t kExtX = 5;

__device__ __forceinline__ uint32_t ext_call(const int (&c4)[4], int count, int dmin_thres) {
  int key[4];
  int top = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    key[j] = c4[j] * 4 + j;
    top = key[j] > top ? key[j] : top;
  }
  int runner = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = key[j] == top ? -1 : key[j];
    runner = x > runner ? x : runner;
  }
  const int top_code = top & 3, top_cnt = top >> 2;
  const int runner_cnt = runner >= 0 ? (runner >> 2) : -1;
  int dmin_dyn = (count + 9) / 10 - 1;
  dmin_dyn = dmin_dyn > dmin_thres ? dmin_dyn : dmin_thres;
  if (top_cnt < dmin_dyn) return kExtX;
  return runner_cnt >= dmin_dyn ? kExtF : (uint32_t)top_code;
}

struct FinArgs {
  CLanes in;                         // weff key lanes (+ the payload lane)
  uint32_t* words;                   // (N, W) row-major
  Lanes pay;                         // 1 (purge) or 5 payload lanes
  int32_t* count;                    // the kept count
  int64_t N;
  int W;
  uint32_t keymask;                  // the last lane's key bits (all-ones: separate payload)
  int dmin_thres;
  unsigned aligned;                  // bit l: input lane l 16-byte aligned
  LookBack lb;                       // the sums' look-back
  unsigned long long* kept_status;   // (T,) the kept counts' look-back
};

// the dynamic shared memory of a block: its rows' keys, [l][q][thread]
template <int WEFF>
constexpr int key_bytes() {
  return WEFF * kSegItems * kSegThreads * 4;
}

template <int WEFF, bool SEP, bool PURGE>
__global__ void __launch_bounds__(kSegThreads)
    finalize_kernel(const __grid_constant__ FinArgs a) {
  constexpr int kPay = PURGE ? 1 : 5;
  extern __shared__ uint32_t s_keys[];            // WEFF x kSegItems x kSegThreads
  __shared__ TileShared<5> sh;
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_edge[2][WEFF];            // the rows before and after the tile
  __shared__ uint32_t s_start[kSegThreads];       // each thread's group-start flags
  __shared__ int s_kept[kSegWarps];
  __shared__ int64_t s_off;
  const int64_t t = take_tile(a.lb.ticket, a.lb.T, &s_tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = t * kSegTile, row0 = base + (int64_t)tid * kSegItems;
  auto key = [&](int l, int q, int th) -> uint32_t& {
    return s_keys[(l * kSegItems + q) * kSegThreads + th];
  };

  // 1. the rows (keys with the payload bits cleared, and the read payload),
  // and the rows before and after the tile, all loaded at once; the keys
  // wait in shared memory for the kept rows' stores, so that registers hold
  // only the sums through the look-backs
  uint32_t k[kSegItems][WEFF], raw[kSegItems];
#pragma unroll
  for (int l = 0; l < WEFF; ++l) {
    uint32_t x[kSegItems];
    load_rows(a.in.p[l], row0, a.N, (a.aligned >> l) & 1u, x);
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) k[q][l] = x[q];
  }
  if (SEP) {
    load_rows(a.in.p[WEFF], row0, a.N, (a.aligned >> WEFF) & 1u, raw);
  } else {
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) {
      raw[q] = k[q][WEFF - 1];
      k[q][WEFF - 1] &= a.keymask;
    }
  }
  if (tid == 0 || tid == kSegThreads - 1) {
    const int e = tid == 0 ? 0 : 1;
    const int64_t r = e ? base + kSegTile : base - 1;  // -1: none; N or past: none
#pragma unroll
    for (int l = 0; l < WEFF; ++l) {
      const uint32_t x = r >= 0 && r < a.N ? a.in.p[l][r] : 0u;
      s_edge[e][l] = x & (l == WEFF - 1 ? a.keymask : ~0u);
    }
  }
#pragma unroll
  for (int l = 0; l < WEFF; ++l)
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) key(l, q, tid) = k[q][l];
  __syncthreads();

  // 2. group starts (rows past N start groups of their own), counts and
  // one-hots as 16-bit halves
  const bool have_prev = tid > 0 || (row0 > 0 && row0 < a.N);
  uint32_t fl = 0, has = 0;  // bit q: row q starts a group / has a count (not a sentinel)
  uint32_t v[kSegItems][5];
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    bool same = q > 0 || have_prev;
    bool sent = k[q][WEFF - 1] == a.keymask;
#pragma unroll
    for (int l = 0; l < WEFF; ++l) {
      const uint32_t before =
          q > 0 ? k[q - 1][l] : (tid > 0 ? key(l, kSegItems - 1, tid - 1) : s_edge[0][l]);
      same = same && k[q][l] == before;
      if (l < WEFF - 1) sent = sent && k[q][l] == 0xFFFFFFFFu;
    }
    const bool live = row0 + q < a.N;
    fl |= (!live || !same) ? 1u << q : 0u;
    uint32_t cnt, left, right;
    if (SEP) {
      cnt = raw[q] & kHalfMax;
      left = (raw[q] >> 16) & 7u;
      right = (raw[q] >> 24) & 7u;
    } else {
      cnt = sent ? 0u : 1u;
      left = (raw[q] >> 1) & 7u;
      right = (raw[q] >> 4) & 7u;
    }
    cnt = live ? cnt : 0u;
    has |= cnt ? 1u << q : 0u;
    v[q][0] = cnt;
    v[q][1] = (left == 0 ? cnt : 0u) | ((left == 1 ? cnt : 0u) << 16);
    v[q][2] = (left == 2 ? cnt : 0u) | ((left == 3 ? cnt : 0u) << 16);
    v[q][3] = (right == 0 ? cnt : 0u) | ((right == 1 ? cnt : 0u) << 16);
    v[q][4] = (right == 2 ? cnt : 0u) | ((right == 3 ? cnt : 0u) << 16);
  }
  // a row ends its group where the next row starts one (the row after the
  // tile: where it exists and differs)
  uint32_t end7 = 1;
  if (tid == kSegThreads - 1 && base + kSegTile < a.N) {
    bool same = true;
#pragma unroll
    for (int l = 0; l < WEFF; ++l) same = same && s_edge[1][l] == k[kSegItems - 1][l];
    end7 = same ? 0u : 1u;
  }
  s_start[tid] = fl;
  __syncthreads();
  if (tid < kSegThreads - 1) end7 = s_start[tid + 1] & 1u;
  const uint32_t last = (fl >> 1) | (end7 << (kSegItems - 1));

  // 3. the group sums, carried in from the tiles before
  tile_scan<5>(a.lb, t, fl, v, sh);

  // 4. calls and keep at group-last rows
  uint32_t kp = 0, pw[kSegItems];
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    const int count = (int)(v[q][0] & kHalfMax);
    bool keep = ((last & has) >> q) & 1u;
    if (PURGE) {
      const int l4[4] = {(int)(v[q][1] & kHalfMax), (int)(v[q][1] >> 16),
                         (int)(v[q][2] & kHalfMax), (int)(v[q][2] >> 16)};
      const int r4[4] = {(int)(v[q][3] & kHalfMax), (int)(v[q][3] >> 16),
                         (int)(v[q][4] & kHalfMax), (int)(v[q][4] >> 16)};
      const uint32_t lcall = ext_call(l4, count, a.dmin_thres);
      const uint32_t rcall = ext_call(r4, count, a.dmin_thres);
      keep = keep && count >= 2 && !(lcall == kExtX && rcall == kExtX);
      pw[q] = (uint32_t)count | (lcall << 16) | (rcall << 24);
    }
    kp |= keep ? 1u << q : 0u;
  }

  // 5. the kept rows before this thread's: in the tile, then (warp 0's
  // look-back) in the tiles before
  const int kc = __popc(kp);
  int inc = kc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) s_kept[warp] = inc;
  __syncthreads();
  int ex = inc - kc, tk = 0;
#pragma unroll
  for (int w = 0; w < kSegWarps; ++w) {
    const int x = s_kept[w];
    ex += w < warp ? x : 0;
    tk += x;
  }
  if (warp == 0) {
    unsigned long long* own = a.kept_status + t;
    const unsigned long long gen = a.lb.gen;
    if (lane == 0) st_relaxed(own, count_status(gen, t == 0 ? kPrefix : kAggregate, tk));
    const int64_t excl = t == 0 ? 0 : count_look_back(a.kept_status, 1, t, gen);
    if (lane == 0) {
      s_off = excl;
      if (t > 0) st_relaxed(own, count_status(gen, kPrefix, excl + tk));
      if (t == a.lb.T - 1) *a.count = (int32_t)(excl + tk);
    }
  }
  __syncthreads();

  // 6. kept rows to their output rows; the tile's other rows to its share
  // of the tail
  const int64_t off = s_off;
  int64_t o = off + ex;
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    if (!((kp >> q) & 1u)) continue;
    uint32_t* row = a.words + o * a.W;
#pragma unroll
    for (int l = 0; l < 8; l += 2) {
      if (l < a.W) {
        const uint32_t x0 = l < WEFF ? key(l, q, tid) : 0u;
        const uint32_t x1 = l + 1 < WEFF ? key(l + 1, q, tid) : 0u;
        *reinterpret_cast<uint2*>(row + l) = make_uint2(x0, x1);
      }
    }
    if (PURGE) {
      a.pay.p[0][o] = pw[q];
    } else {
#pragma unroll
      for (int c = 0; c < 5; ++c) a.pay.p[c][o] = v[q][c];
    }
    ++o;
  }
  const int rows = (int)(a.N - base < kSegTile ? a.N - base : kSegTile);
  const int rest = rows - tk;
  const int64_t tail0 = a.N - (base - off) - rest;
  uint32_t* fill = a.words + tail0 * a.W;
  for (int i = tid; i < rest * a.W; i += kSegThreads) fill[i] = 0xFFFFFFFFu;
#pragma unroll
  for (int c = 0; c < kPay; ++c)
    for (int i = tid; i < rest; i += kSegThreads) a.pay.p[c][tail0 + i] = 0u;
}

template <int WEFF, bool SEP, bool PURGE>
int launch_one(const FinArgs& a, cudaStream_t s) {
  constexpr int smem = key_bytes<WEFF>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        finalize_kernel<WEFF, SEP, PURGE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  finalize_kernel<WEFF, SEP, PURGE><<<(unsigned)a.lb.T, kSegThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int WEFF>
int launch(int sep, int purge, const FinArgs& a, cudaStream_t s) {
  if (sep) return purge ? launch_one<WEFF, true, true>(a, s) : launch_one<WEFF, true, false>(a, s);
  return purge ? launch_one<WEFF, false, true>(a, s) : launch_one<WEFF, false, false>(a, s);
}

}  // namespace

// lanes: weff sorted lanes of N rows (packed layout, sep = 0) or weff key
// lanes + the payload lane (sep = 1, keymask ignored); words: (N, W)
// int32, W even, weff <= W <= 8; pays: 1 (purge) or 5 int32 lanes of N
// rows; count: one int32; status: >= 2 T u64 words (T = ceil(N / 2048)),
// zero or of earlier generations (the sums' look-back in the first half,
// the kept counts' in the second); vals: T * 18 u32; ticket: one int32, 0
// between calls; gen in [1, 2^31), one more than the last call's.
extern "C" int mhm2_finalize(const void* const* lanes, int weff, int sep, int64_t N,
                             uint32_t keymask, int dmin_thres, int purge, int W, void* words,
                             void* const* pays, void* count, void* status, int64_t status_words,
                             void* vals, void* ticket, int64_t gen, void* stream) {
  MHM2_REQUIRE(weff >= 1 && weff <= 7 && (sep == 0 || sep == 1));
  MHM2_REQUIRE(W >= weff && W <= 8 && W % 2 == 0 && ((uintptr_t)words & 7u) == 0);
  MHM2_REQUIRE(N >= 0 && N < (1ll << 31) && gen >= 1 && gen < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  FinArgs a;
  a.in = make_clanes(lanes, weff + sep);
  a.words = (uint32_t*)words;
  a.pay = make_lanes(pays, purge ? 1 : 5);
  a.count = (int32_t*)count;
  a.N = N;
  a.W = W;
  a.keymask = sep ? 0xFFFFFFFFu : keymask;
  a.dmin_thres = dmin_thres;
  a.aligned = 0;
  for (int l = 0; l < weff + sep; ++l) a.aligned |= aligned16(lanes[l]) ? 1u << l : 0u;
  a.lb = make_look_back(N, status, vals, ticket, gen);
  MHM2_REQUIRE(status_words >= 2 * a.lb.T);
  a.kept_status = (unsigned long long*)status + status_words / 2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (weff) {
    case 1: return launch<1>(sep, purge, a, s);
    case 2: return launch<2>(sep, purge, a, s);
    case 3: return launch<3>(sep, purge, a, s);
    case 4: return launch<4>(sep, purge, a, s);
    case 5: return launch<5>(sep, purge, a, s);
    case 6: return launch<6>(sep, purge, a, s);
    case 7: return launch<7>(sep, purge, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
