// join: answer propagation over a merged sort-join run, routed back to
// query order.
//
// Two source layouts. Fused (mhm2_join): one u32 source lane, described
// below. Separate lanes (mhm2_join_sep, for tables or query sets of 2^25
// rows and more, or wide payloads: the reference's XLA branch,
// mhm2_proxy_tpu/ops/lookup.py:144-247): a source lane of row idx with bit
// 31 set on query rows, and a payload lane; a valid table row answers the
// u64 (idx + 1) << 32 | payload. The computation is the same.
//
// Replaces mhm2_proxy_tpu/ops/pallas_join.py:157 `propagate_compact`
// (kernel body `_kernel` :57) together with the two steps its caller runs
// after it (mhm2_proxy_tpu/ops/lookup.py:127-137): the ragged_append of the
// compacted (dest, answer) pairs and the stable sort by dest. The input is
// ops/lookup.py's merge of the sorted table rows and the sorted query rows:
// kw key lanes plus one source lane, table idx | payload << 26 or query idx
// | 1 << 25 (pad rows 0x01FFFFFF). A valid table row (idx < n_valid) answers
// (idx + 1) << payload_bits | payload; every query row gets the largest
// answer among the rows of its equal-key run that lie within `reach` rows
// of it, 0 if there is none, stored at its query index (query ids >= Q are
// not stored).
//
// What bounds it on an H100: memory. The function reads each row's key and
// source lanes once and writes one answer a query; the answers land in
// query order, a scatter, since the merged rows are in key order.
// Design: the TPU kernel spreads the answer with log2(max_dup) doubling
// shifts over a tile canvas with a one-row halo, then compacts the tile's
// query rows, because Mosaic can neither index a neighbour freely nor
// scatter. Here a 256-thread block takes a window of 1536 merged rows, a
// tile of 1536 - 2 reach rows and `reach` halo rows on each side (reach <=
// 255, so a tile holds 1026 rows or more, 1474 at the ladder's reach of
// 31, and every thread has six window rows), and loads them once with
// coalesced loads: each row's answer goes to shared memory, and one key
// compare with the row before, taken from the lane below by a shuffle,
// gives the run starts. Each key word is loaded once, and no load waits
// on another's compare (a short-circuit compare would make each key lane
// a memory round trip of its own). The tile takes what the halos leave
// of the window, not a size fixed for the largest halo, so at the
// ladder's reach of 31 each block answers 1474 rows for the same fixed
// costs (block scans, barriers). Since the rows are sorted, equal keys at
// distance d mean an equal run between, so a row's answer is the maximum
// over [a, c] = its run within `reach` rows, what the reference's shifts
// compute. A van Herk/Gil-Werman window maximum
// gives it in a fixed number of steps, whatever the run's length
// (build_edges puts every all-ones query and padded table row in one run
// of millions): one forward and one backward block scan give each row its
// run bounds and the maxima from its segment's start and to its segment's
// end, where segments end at run bounds and at multiples of B = 2 reach +
// 1; [a, c] spans at most two B-blocks, so two reads answer it. The tile's
// query rows with a nonzero answer then store it (build_edges' all-ones
// queries answer 0). Where all answers fit 4 MB they are stored directly
// into zero-filled answers. Past that, random stores are what cost: L2
// takes each random 8-byte store as a transaction of its own, even inside
// a 64 KB window, so they cost several times the same bytes written in
// order. So the tile stages (dest, answer) pairs by 4 MB
// window of answers, grouped in shared memory so that each window's slots
// are written in a row; join_split regroups each window's pairs by 64 KB
// image the same way; and join_image builds each image in shared memory
// (zeros where no query answered) and writes it out in order. Repeated
// query ids would overflow a window's or an image's slots: the kernels
// then set the scratch's overflow word, and the wrapper raises. The staging
// holds at most 512 windows (2^28 u64 or 2^29 u32 answers); past that the
// three launches run in passes, each over the next 512 windows of query
// ids [q0, q1): the tile launch takes a query id in it as its id less q0
// and drops the others, and the pass writes answers from ans + q0, so each
// pass is a call of fewer than 512 windows with the same scratch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 6;                  // window rows a thread
constexpr int kWin = kPer * kThreads;    // 1536 window rows: a tile and two halos
constexpr int kMaxReach = 255;           // the tile keeps kWin - 2 reach >= 1026 rows
constexpr uint32_t kQueryBit = 1u << 25;
constexpr uint32_t kIdxMask = kQueryBit - 1u;

// the fused source lane: table idx | payload << 26, or query idx | 1 << 25
struct FusedSrc {
  const uint32_t* src;
  int payload_bits;
  typedef uint32_t Answer;
  // row p's answer, and its query index (-1: a table or pad row)
  __device__ __forceinline__ Answer row(int64_t p, uint32_t n_valid, int64_t* dest) const {
    const uint32_t s = src[p];
    const uint32_t idx = s & kIdxMask;
    if (s & kQueryBit) {
      *dest = idx;
      return 0u;
    }
    *dest = -1;
    return idx < n_valid ? ((idx + 1u) << payload_bits) | (s >> 26) : 0u;
  }
};

// separate lanes: row idx (bit 31 on query rows) and the table's payload
struct SepSrc {
  const uint32_t* src;
  const uint32_t* pay;
  typedef unsigned long long Answer;
  __device__ __forceinline__ Answer row(int64_t p, uint32_t n_valid, int64_t* dest) const {
    const uint32_t s = src[p];
    const uint32_t v = pay[p];
    if (s >> 31) {
      *dest = s & 0x7FFFFFFFu;
      return 0ull;
    }
    *dest = -1;
    return s < n_valid ? ((unsigned long long)(s + 1u) << 32) | v : 0ull;
  }
};

// Whether window rows j = q * kThreads + tid start an equal-key run: each
// key word is loaded once, coalesced, and compared with the row before
// from the lane below (lane 0 loads its row before). The lanes are taken
// one at a time, every load of a lane in flight at once, and the compares
// do not short-circuit, so no load waits on another's result.
template <int KW>
__device__ __forceinline__ void run_starts(const CLanes& keys, int64_t wb, int n,
                                           bool (&sv)[kPer]) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t ne[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) ne[q] = wb + q * kThreads + tid == 0 ? 1u : 0u;
#pragma unroll
  for (int l = 0; l < KW; ++l) {
    const uint32_t* __restrict__ k = keys.p[l];
    uint32_t x[kPer], y[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = q * kThreads + tid;
      const int64_t p = wb + j;
      x[q] = j < n ? __ldg(k + p) : 0u;
      y[q] = lane == 0 && j < n && p > 0 ? __ldg(k + p - 1) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, x[q], 1);
      ne[q] |= x[q] ^ (lane == 0 ? y[q] : up);
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) sv[q] = ne[q] != 0;
}

// Answers land in query order, which the merged rows' key order does not
// follow. Where they all fit one bucket (4 MB) the tile stores them
// directly; else the tile stages (dest, answer) pairs in one bucket a 4 MB
// window of answers (dest >> shift), join_split regroups each bucket's
// pairs by 64 KB image (dest >> img_shift), and join_image builds each
// image in shared memory and writes it out in order.
constexpr int64_t kWindowBytes = 4ll << 20;
constexpr int64_t kImageBytes = 64ll << 10;
constexpr int kSubBits = 6;
constexpr int kSub = 1 << kSubBits;  // images a bucket
static_assert(kImageBytes * kSub == kWindowBytes, "a bucket is kSub images");
constexpr int kMaxBuckets = 512;
constexpr int kSplitThreads = 256;
constexpr int kSplitChunk = kSplitThreads * 8;  // pairs a split block
constexpr int kImageThreads = 512;

template <class Answer>
struct Staging {
  int shift;       // dest >> shift: its bucket (0 buckets: direct stores)
  int n_buckets;
  int64_t cap;     // pairs a bucket holds: 1 << shift
  int img_shift;   // dest >> img_shift: its image
  uint32_t* dest;  // (n_buckets * cap) staged query indices, by bucket
  Answer* val;     // (n_buckets * cap) staged answers
  uint32_t* dest2; // the same pairs, by image (1 << img_shift slots each)
  Answer* val2;
  int* cursor;     // (n_buckets,) pairs a bucket, 0 before a call
  int* cursor2;    // (n_buckets * kSub,) pairs an image, 0 before a call
  int* overflow;   // set where a bucket or an image overflowed (query ids repeat)
};

// Every thread of a block of `threads`: each group's first slot among the
// block's pairs grouped by group (off, and the total, from warp 0) and its
// first slot in the group's region (base, one global atomic a group, spread
// over the threads); n groups <= 32 * G.
template <int G>
__device__ __forceinline__ void reserve(const int* cnt, int n, int* cursor, int* off, int* base,
                                        int* total, int threads) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int c[G];
    int sum = 0;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int k = lane * G + u;
      c[u] = k < n ? cnt[k] : 0;
      sum += c[u];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    int at = inc - sum;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      off[lane * G + u] = at;
      at += c[u];
    }
    if (lane == 31) *total = inc;
  }
  for (int k = threadIdx.x; k < n; k += threads)
    if (cnt[k]) base[k] = atomicAdd(cursor + k, cnt[k]);
}

template <class Answer>
struct JoinShared {
  Answer pre[kWin];      // max from the row's segment start to the row (PP)
  Answer suf[kWin];      // max from the row to its segment end (SS)
  uint8_t start[kWin];   // the window row starts an equal-key run
  int32_t dest[kWin];    // the tile's rows: query index, or -1
  int warp_i[kWarps][2];
  Answer warp_v[kWarps][2];
  int warp_f[kWarps][2];
  int cnt[kMaxBuckets];   // the tile's staged pairs a bucket
  int off[kMaxBuckets];   // their first slot in the tile's grouped pairs
  int base[kMaxBuckets];  // their first slot in the bucket
  int total;
};

template <class Answer>
__device__ __forceinline__ Answer amax(Answer a, Answer b) {
  return a > b ? a : b;
}

// segmented max, a precedes b: (fa, va) . (fb, vb) = (fa | fb, fb ? vb : max)
template <class Answer>
__device__ __forceinline__ void seg_max(int& fa, Answer& va, int fb, Answer vb) {
  va = fb ? vb : amax(va, vb);
  fa |= fb;
}

// x / B for 0 <= x < 2^11 and odd B <= 511, by multiply-high with mB =
// ceil(2^32 / B) (exact while x (mB B - 2^32) < 2^32)
__device__ __forceinline__ uint32_t div_block(int x, int B, uint32_t mB) {
  return B == 1 ? (uint32_t)x : __umulhi((uint32_t)x, mB);
}

template <int KW, class Src>
__global__ void __launch_bounds__(kThreads, 4)
    join_kernel(CLanes keys, Src src, int64_t M, const int32_t* __restrict__ n_valid_p, int reach,
                typename Src::Answer* __restrict__ ans, int64_t q0, int64_t Q,
                Staging<typename Src::Answer> stg) {
  typedef typename Src::Answer Answer;
  __shared__ JoinShared<Answer> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = kWin - 2 * reach;  // merged rows a block answers
  const int64_t b = (int64_t)blockIdx.x * tile;
  const int64_t wb = b - reach > 0 ? b - reach : 0;
  const int64_t we = b + tile + reach < M ? b + tile + reach : M;
  const int n = (int)(we - wb);  // window rows
  const int t0 = (int)(b - wb);  // the tile's first window row
  const int tn = (int)(M - b < tile ? M - b : tile);
  const uint32_t n_valid = (uint32_t)*n_valid_p;
  const int B = 2 * reach + 1;   // the van Herk/Gil-Werman block

  // 1. each window row once (coalesced): its answer, whether it starts a
  // run, and the tile rows' query indices
  {
    Answer av[kPer];
    int64_t dq[kPer];
    bool sv[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = q * kThreads + tid;
      if (j < n) av[q] = src.row(wb + j, n_valid, &dq[q]);
    }
    run_starts<KW>(keys, wb, n, sv);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = q * kThreads + tid;
      if (j < n) {
        sh.pre[j] = av[q];
        sh.start[j] = sv[q];
        const int i = j - t0;
        if (i >= 0 && i < tn) sh.dest[i] = dq[q] >= q0 && dq[q] < Q ? (int32_t)(dq[q] - q0) : -1;
      }
    }
  }
  for (int k = tid; k < stg.n_buckets; k += kThreads) sh.cnt[k] = 0;
  __syncthreads();

  // 2. kPer consecutive window rows a thread, one forward and one backward
  // block scan: each row's run start lo and end hi inside the window, and
  // the maxima pre / suf over the row's segment, whose bounds are run
  // bounds and the multiples of B
  const int j0 = tid * kPer;
  Answer v[kPer];
  bool st[kPer + 1];
#pragma unroll
  for (int q = 0; q <= kPer; ++q) st[q] = j0 + q < n ? sh.start[j0 + q] != 0 : true;
#pragma unroll
  for (int q = 0; q < kPer; ++q) v[q] = j0 + q < n ? sh.pre[j0 + q] : Answer(0);
  // segment starts (gs) and ends (ge): run bounds and the B-block edges
  const uint32_t mB = B > 1 ? 0xFFFFFFFFu / (uint32_t)B + 1u : 0u;  // ceil(2^32 / B), B odd
  bool gs[kPer], ge[kPer];
  int m = j0 - (int)div_block(j0, B, mB) * B;  // j0 % B
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    gs[q] = st[q] || m == 0;
    ge[q] = st[q + 1] || m == B - 1;
    m = m + 1 == B ? 0 : m + 1;
  }
  int lo[kPer], hi[kPer];
  Answer pre[kPer], suf[kPer];
  int fl_f = 0, fl_b = 0;  // a segment starts (ends) among the thread's rows
  int run = 0;
  Answer acc = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = j0 + q;
    run = st[q] ? j : run;
    lo[q] = run;
    seg_max(fl_f, acc, gs[q] ? 1 : 0, v[q]);
    pre[q] = acc;
  }
  int up = run;
  Answer up_v = acc;
  int up_f = fl_f;
  int end = n - 1;
  acc = 0;
#pragma unroll
  for (int q = kPer - 1; q >= 0; --q) {
    const int j = j0 + q;
    end = st[q + 1] ? j : end;
    hi[q] = end;
    // backward: the row after precedes
    acc = ge[q] ? v[q] : amax(acc, v[q]);
    fl_b |= ge[q] ? 1 : 0;
    suf[q] = acc;
  }
  int down = end;
  Answer down_v = acc;
  int down_f = fl_b;
  // warp scans: up (inclusive, from the left), down (from the right)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ui = __shfl_up_sync(0xffffffffu, up, o);
    const Answer uv = __shfl_up_sync(0xffffffffu, up_v, o);
    const int uf = __shfl_up_sync(0xffffffffu, up_f, o);
    const int di = __shfl_down_sync(0xffffffffu, down, o);
    const Answer dv = __shfl_down_sync(0xffffffffu, down_v, o);
    const int df = __shfl_down_sync(0xffffffffu, down_f, o);
    if (lane >= o) {
      up = ui > up ? ui : up;
      int f = uf;
      Answer x = uv;
      seg_max(f, x, up_f, up_v);
      up_f = f, up_v = x;
    }
    if (lane + o < 32) {
      down = di < down ? di : down;
      int f = df;
      Answer x = dv;
      seg_max(f, x, down_f, down_v);
      down_f = f, down_v = x;
    }
  }
  if (lane == 31) sh.warp_i[warp][0] = up, sh.warp_v[warp][0] = up_v, sh.warp_f[warp][0] = up_f;
  if (lane == 0) sh.warp_i[warp][1] = down, sh.warp_v[warp][1] = down_v, sh.warp_f[warp][1] = down_f;
  // exclusive: what the lanes before (after) carry in
  int before = __shfl_up_sync(0xffffffffu, up, 1);
  Answer before_v = __shfl_up_sync(0xffffffffu, up_v, 1);
  int after = __shfl_down_sync(0xffffffffu, down, 1);
  Answer after_v = __shfl_down_sync(0xffffffffu, down_v, 1);
  int before_f = __shfl_up_sync(0xffffffffu, up_f, 1);
  int after_f = __shfl_down_sync(0xffffffffu, down_f, 1);
  if (lane == 0) before = 0, before_v = 0, before_f = 0;
  if (lane == 31) after = n - 1, after_v = 0, after_f = 0;
  __syncthreads();
  {
    int f = 0;
    Answer x = 0;
    int bi = 0;
    for (int w = 0; w < warp; ++w) {
      bi = sh.warp_i[w][0] > bi ? sh.warp_i[w][0] : bi;
      seg_max(f, x, sh.warp_f[w][0], sh.warp_v[w][0]);
    }
    before = bi > before ? bi : before;
    seg_max(f, x, before_f, before_v);
    before_v = x;
    f = 0;
    x = 0;
    int ai = n - 1;
    for (int w = kWarps - 1; w > warp; --w) {
      ai = sh.warp_i[w][1] < ai ? sh.warp_i[w][1] : ai;
      seg_max(f, x, sh.warp_f[w][1], sh.warp_v[w][1]);
    }
    after = ai < after ? ai : after;
    seg_max(f, x, after_f, after_v);
    after_v = x;
  }
  bool open_f = true, open_b = true;  // no segment bound yet from the left (right)
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    open_f = open_f && !gs[q];
    lo[q] = lo[q] > before ? lo[q] : before;
    if (open_f) pre[q] = amax(pre[q], before_v);
  }
#pragma unroll
  for (int q = kPer - 1; q >= 0; --q) {
    open_b = open_b && !ge[q];
    hi[q] = hi[q] < after ? hi[q] : after;
    if (open_b) suf[q] = amax(suf[q], after_v);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (j0 + q < n) {
      sh.pre[j0 + q] = pre[q];
      sh.suf[j0 + q] = suf[q];
    }
  }
  __syncthreads();

  // 3. each tile row: the maximum over [a, c], its run within reach, from
  // at most two segments (a and c lie in one B-block or in two adjacent)
  Answer out[kPer];
  int dst[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = j0 + q;
    const int i = j - t0;
    dst[q] = -1;
    if (i >= 0 && i < tn) {
      dst[q] = sh.dest[i];
      const int a = j - reach > lo[q] ? j - reach : lo[q];
      const int c = j + reach < hi[q] ? j + reach : hi[q];
      if (div_block(a, B, mB) != div_block(c, B, mB))
        out[q] = amax(sh.suf[a], sh.pre[c]);
      else
        out[q] = c == hi[q] ? sh.suf[a] : sh.pre[c];
    }
  }

  // 4. the tile's query rows with a nonzero answer store it (the caller
  // zero-fills ans), directly or staged
  if (stg.n_buckets == 0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (dst[q] >= 0 && out[q]) ans[dst[q]] = out[q];
    return;
  }
  int rank[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    rank[q] = dst[q] >= 0 && out[q] ? atomicAdd(&sh.cnt[dst[q] >> stg.shift], 1) : -1;
  __syncthreads();
  // each bucket's offset among the tile's pairs, and its slots in the bucket
  reserve<kMaxBuckets / 32>(sh.cnt, stg.n_buckets, stg.cursor, sh.off, sh.base, &sh.total,
                            kThreads);
  __syncthreads();
  // the tile's pairs grouped by bucket in the window maximum's buffers (read
  // before the last barrier), so each bucket's slots are written in a row
  uint32_t* s_dest = (uint32_t*)sh.dest;
  Answer* s_val = sh.pre;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (rank[q] < 0) continue;
    const int e = sh.off[dst[q] >> stg.shift] + rank[q];
    s_dest[e] = (uint32_t)dst[q];
    s_val[e] = out[q];
  }
  __syncthreads();
  for (int e = tid; e < sh.total; e += kThreads) {
    const uint32_t d = s_dest[e];
    const int k = (int)(d >> stg.shift);
    const int64_t slot = (int64_t)sh.base[k] + (e - sh.off[k]);
    if (slot >= stg.cap) {  // more queries than ids in the window: ids repeat
      *stg.overflow = 1;
      continue;
    }
    stg.dest[k * stg.cap + slot] = d;
    stg.val[k * stg.cap + slot] = s_val[e];
  }
}

// Pass 2: each block regroups up to kSplitChunk of a bucket's pairs by
// image, in shared memory, and writes each image's share in a row.
template <class Answer>
__global__ void __launch_bounds__(kSplitThreads)
    join_split(Staging<Answer> stg, int chunks) {
  constexpr int kPairs = kSplitChunk / kSplitThreads;
  __shared__ uint32_t s_dest[kSplitChunk];
  __shared__ Answer s_val[kSplitChunk];
  __shared__ int cnt[kSub], off[kSub], base[kSub];
  __shared__ int total;
  const int tid = threadIdx.x;
  const int k = blockIdx.x / chunks;
  const int64_t c0 = (int64_t)(blockIdx.x % chunks) * kSplitChunk + tid;
  int64_t n = stg.cursor[k];
  n = n < stg.cap ? n : stg.cap;
  if (tid < kSub) cnt[tid] = 0;
  __syncthreads();
  const uint32_t* __restrict__ d = stg.dest + k * stg.cap;
  const Answer* __restrict__ v = stg.val + k * stg.cap;
  uint32_t dd[kPairs];
  Answer vv[kPairs];
  int rank[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int64_t e = c0 + q * kSplitThreads;
    rank[q] = -1;
    if (e < n) {
      dd[q] = __ldcs(d + e), vv[q] = __ldcs(v + e);
      rank[q] = atomicAdd(&cnt[(dd[q] >> stg.img_shift) & (kSub - 1)], 1);
    }
  }
  __syncthreads();
  reserve<kSub / 32>(cnt, kSub, stg.cursor2 + k * kSub, off, base, &total, kSplitThreads);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    if (rank[q] < 0) continue;
    const int e = off[(dd[q] >> stg.img_shift) & (kSub - 1)] + rank[q];
    s_dest[e] = dd[q];
    s_val[e] = vv[q];
  }
  __syncthreads();
  const int64_t img = 1ll << stg.img_shift;
  for (int e = tid; e < total; e += kSplitThreads) {
    const uint32_t x = s_dest[e];
    const int sb = (x >> stg.img_shift) & (kSub - 1);
    const int64_t slot = (int64_t)base[sb] + (e - off[sb]);
    if (slot >= img) {  // more pairs than ids in the image: ids repeat
      *stg.overflow = 1;
      continue;
    }
    const int64_t at = ((int64_t)k * kSub + sb) * img + slot;
    stg.dest2[at] = x;
    stg.val2[at] = s_val[e];
  }
}

// Pass 3: one block an image: its answers (0 where no query answered) in
// shared memory, then written out in order.
template <class Answer>
__global__ void __launch_bounds__(kImageThreads)
    join_image(Staging<Answer> stg, int64_t Q, Answer* __restrict__ ans) {
  extern __shared__ __align__(16) unsigned char smem[];
  Answer* img = (Answer*)smem;
  const int W = 1 << stg.img_shift;
  const int64_t g = blockIdx.x;
  const int64_t w0 = g << stg.img_shift;
  for (int i = threadIdx.x; i < W; i += kImageThreads) img[i] = 0;
  __syncthreads();
  int n = stg.cursor2[g];
  n = n < W ? n : W;
  const uint32_t* __restrict__ d = stg.dest2 + w0;
  const Answer* __restrict__ v = stg.val2 + w0;
  for (int e = threadIdx.x; e < n; e += kImageThreads) img[__ldcs(d + e) - w0] = __ldcs(v + e);
  __syncthreads();
  for (int i = threadIdx.x; i < W && w0 + i < Q; i += kImageThreads) ans[w0 + i] = img[i];
}

// The staging's bytes for Q answers of `answer_bytes` each: 0 where they
// fit one bucket (direct stores), else those of one pass (at most
// kMaxBuckets buckets); -1 from Q = 2^31 on.
int64_t scratch_bytes_for(int64_t Q, int64_t answer_bytes) {
  if (Q >= (1ll << 31)) return -1;
  const int64_t cap = kWindowBytes / answer_bytes;
  if (Q <= cap) return 0;
  int64_t n_buckets = (Q + cap - 1) / cap;
  n_buckets = n_buckets < kMaxBuckets ? n_buckets : kMaxBuckets;
  return 2 * n_buckets * cap * (answer_bytes + 4) + 4 * (n_buckets * (1 + kSub) + 1);
}

// One pass: the answers of query ids [q0, Q), with the call's staging (its
// buckets laid out for stg.n_buckets; none: direct stores, in one pass).
template <class Src>
int launch(int kw, int64_t M, cudaStream_t s, const CLanes& k, const Src& src, const int32_t* nv,
           int reach, typename Src::Answer* ans, int64_t q0, int64_t Q,
           Staging<typename Src::Answer> stg, bool first) {
  typedef typename Src::Answer Answer;
  if (stg.n_buckets) {
    // the cursors, and on the first pass the overflow word after them
    cudaMemsetAsync(stg.cursor, 0, 4 * ((size_t)stg.n_buckets * (1 + kSub) + first), s);
    stg.n_buckets = (int)((Q - q0 + stg.cap - 1) / stg.cap);
  }
  const int64_t tile = kWin - 2 * reach;
  const unsigned blocks = (unsigned)((M + tile - 1) / tile);
  switch (kw) {
#define MHM2_JOIN_CASE(KW)                                                                  \
  case KW:                                                                                  \
    join_kernel<KW, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, q0, Q, stg); \
    break;
    MHM2_JOIN_CASE(1)
    MHM2_JOIN_CASE(2)
    MHM2_JOIN_CASE(3)
    MHM2_JOIN_CASE(4)
    MHM2_JOIN_CASE(5)
    MHM2_JOIN_CASE(6)
    MHM2_JOIN_CASE(7)
    MHM2_JOIN_CASE(8)
#undef MHM2_JOIN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (stg.n_buckets) {
    const int chunks = (int)((stg.cap + kSplitChunk - 1) / kSplitChunk);
    join_split<Answer><<<(unsigned)(stg.n_buckets * chunks), kSplitThreads, 0, s>>>(stg, chunks);
    cudaFuncSetAttribute(join_image<Answer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kImageBytes);
    const int64_t images = (Q - q0 + (1ll << stg.img_shift) - 1) >> stg.img_shift;
    join_image<Answer><<<(unsigned)images, kImageThreads, kImageBytes, s>>>(stg, Q - q0,
                                                                             ans + q0);
  }
  return (int)cudaGetLastError();
}

// A call: the staging laid out for at most kMaxBuckets buckets, then one
// pass, or passes of that many windows of query ids where Q needs more.
template <class Src>
int launch_passes(int kw, int64_t M, cudaStream_t s, const CLanes& k, const Src& src,
                  const int32_t* nv, int reach, typename Src::Answer* ans, int64_t Q,
                  void* scratch, int64_t scratch_bytes) {
  typedef typename Src::Answer Answer;
  Staging<Answer> stg = {};
  const int64_t need = scratch_bytes_for(Q, sizeof(Answer));
  if (need < 0 || scratch_bytes < need) return (int)cudaErrorInvalidValue;
  int64_t span = Q;  // query ids a pass
  if (need > 0) {
    stg.cap = kWindowBytes / (int64_t)sizeof(Answer);
    while ((1ll << stg.shift) < stg.cap) ++stg.shift;
    stg.img_shift = stg.shift - kSubBits;
    const int64_t n_buckets = (Q + stg.cap - 1) / stg.cap;
    stg.n_buckets = (int)(n_buckets < kMaxBuckets ? n_buckets : kMaxBuckets);
    const int64_t pairs = (int64_t)stg.n_buckets * stg.cap;
    stg.val = (Answer*)scratch;
    stg.val2 = stg.val + pairs;
    stg.dest = (uint32_t*)(stg.val2 + pairs);
    stg.dest2 = stg.dest + pairs;
    stg.cursor = (int*)(stg.dest2 + pairs);
    stg.cursor2 = stg.cursor + stg.n_buckets;
    stg.overflow = stg.cursor2 + stg.n_buckets * kSub;  // the scratch's last int32
    span = pairs;
  }
  int64_t q0 = 0;
  do {  // once where Q is 0
    const int64_t q1 = Q - q0 < span ? Q : q0 + span;
    const int rc = launch(kw, M, s, k, src, nv, reach, ans, q0, q1, stg, q0 == 0);
    if (rc) return rc;
    q0 = q1;
  } while (q0 < Q);
  return 0;
}

}  // namespace

// The staging bytes that a call with Q answers of answer_bytes (4: mhm2_join,
// 8: mhm2_join_sep) needs: 0 where the answers are stored directly, else at
// most 512 buckets of 4 MB, which passes reuse; -1 from Q = 2^31 on.
extern "C" int64_t mhm2_join_scratch_bytes(int64_t Q, int answer_bytes) {
  return scratch_bytes_for(Q, answer_bytes);
}

// keys: kw lane pointers and src: the source lane, M merged rows sorted on
// the keys, query ids distinct; n_valid: device pointer to the table's
// valid row count (i32); reach in [0, 255]; ans: Q u32 answers, one per
// query index (zero-filled by the caller where mhm2_join_scratch_bytes(Q,
// 4) is 0; else every answer is written); scratch: that many bytes, whose
// last int32 the call sets to 1 where repeated query ids overflowed the
// staging (answers were then dropped).
extern "C" int mhm2_join(const void* const* keys, int kw, const void* src, int64_t M,
                         const void* n_valid, int payload_bits, int reach, void* ans, int64_t Q,
                         void* scratch, int64_t scratch_bytes, void* stream) {
  MHM2_REQUIRE(kw >= 1 && kw <= 8 && payload_bits >= 0 && payload_bits <= 6);
  MHM2_REQUIRE(reach >= 0 && reach <= kMaxReach);
  MHM2_REQUIRE(M >= 0 && M < (1ll << 31) && Q >= 0 && Q <= (1ll << 25));
  if (M == 0) return (int)cudaGetLastError();
  return launch_passes(kw, M, (cudaStream_t)stream, make_clanes(keys, kw),
                       FusedSrc{(const uint32_t*)src, payload_bits}, (const int32_t*)n_valid,
                       reach, (uint32_t*)ans, Q, scratch, scratch_bytes);
}

// The separate-lane layout: src (row idx, bit 31 on query rows) and pay
// (the table rows' payload); ans: Q u64 answers, zero-filled by the caller
// where mhm2_join_scratch_bytes(Q, 8) is 0; scratch: that many bytes, its
// last int32 the overflow flag as above.
extern "C" int mhm2_join_sep(const void* const* keys, int kw, const void* src, const void* pay,
                             int64_t M, const void* n_valid, int reach, void* ans, int64_t Q,
                             void* scratch, int64_t scratch_bytes, void* stream) {
  MHM2_REQUIRE(kw >= 1 && kw <= 8 && reach >= 0 && reach <= kMaxReach);
  MHM2_REQUIRE(M >= 0 && M < (1ll << 31) && Q >= 0 && Q < (1ll << 31));
  if (M == 0) return (int)cudaGetLastError();
  return launch_passes(kw, M, (cudaStream_t)stream, make_clanes(keys, kw),
                       SepSrc{(const uint32_t*)src, (const uint32_t*)pay},
                       (const int32_t*)n_valid, reach, (unsigned long long*)ans, Q, scratch,
                       scratch_bytes);
}
