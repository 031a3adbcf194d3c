// sort: merge of two sorted multi-lane runs, a partitioned merge path.
//
// Replaces mhm2_proxy_tpu/ops/pallas_sort.py:158 `_bitonic_network`
// (kernels `_tail_kernel` :110 and `_cross_kernel` :120; entry points
// `_merge_anylen_core` :243, merge_sorted_lanes_padded :289,
// merge_sorted_lanes_tiled :296, merge_sorted_lanes :307). Rows are tuples
// of u32 lanes lexsorted on their first kw lanes (lane 0 most significant,
// unsigned, so the all-ones sentinel sorts last). The output has exactly
// len(A) + len(B) rows. Every lane, in or out, is a pointer plus an element
// stride, so the columns of a row-major (N, W) words tensor are read and
// written in place.
//
// What bounds it on an H100: memory. A merge reads and writes every lane
// once (the bitonic network on the TPU makes ~1.5 log2(n_tiles) + 2 passes
// because its grid cannot search).
// Design: (1) merge_partition: one thread per tile boundary finds the
// boundary's co-rank (how many A rows precede it in the merge) by binary
// search over device memory, so the searches' dependent loads are paid
// once, across the whole card, in one wave, not at the head of every
// block. (2) merge_tile: each 256-thread block owns a tile of output rows
// (4096 for kw <= 2, 2048 for kw <= 4, else 1024: the keys take at most 32
// KB of shared memory, so five or more blocks share an SM), reads its two
// splits, stages only its key lanes, A's and B's ranges side by side, into
// shared memory with cp.async (a row-major key block is one contiguous
// range), lets each thread co-rank its slice in shared memory and merge it
// serially, records each output's source row, and writes the keys out of
// shared memory; the payload lanes follow the recorded source rows, whose
// A and B parts are two increasing ranges, so those reads coalesce, with
// eight loads in flight a thread before their stores. The merge is stable
// (A before B on equal keys), so it equals a stable lexsort of the
// concatenation bit for bit at any lengths.
//
// range_cuts (mhm2_range_cuts): the key-range cuts of a ranged fold over R
// sorted runs, which replaces no TPU kernel: the reference copies every
// run's word 0 to the host for numpy's quantile and searchsorted
// (mhm2_proxy_tpu/kcount/kmer_store.py:476-495). It generalises
// merge_partition's co-rank search from two runs to R, searching by value:
// one warp an edge q = 1 .. Q - 1 bisects the 32-bit key values for the
// smallest v whose count of rows <= v over every run passes the rank
// t_q = floor((N - 1) q / Q) (numpy's "lower" order statistic), the warp's
// lanes taking the runs, one binary search each; run j's cut is then its
// count of rows < v, so every row of a key falls in one range. What bounds
// it: dependent loads, ~32 x log2(rows) a run an edge, a fraction of a
// millisecond; no column leaves the card.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // gathered loads a thread keeps in flight

struct MergeDesc {
  const uint32_t* a[MHM2_MAX_LANES];
  int64_t a_stride[MHM2_MAX_LANES];
  const uint32_t* b[MHM2_MAX_LANES];
  int64_t b_stride[MHM2_MAX_LANES];
  uint32_t* out[MHM2_MAX_LANES];
  int64_t out_stride[MHM2_MAX_LANES];
  int64_t na, nb;
  int n_lanes;
  int a_block, b_block;  // the key lanes are one row-major (n, kw) block
};

__host__ __device__ constexpr int tile_rows(int kw) { return kw <= 2 ? 4096 : kw <= 4 ? 2048 : 1024; }

// A row i < B row j on the key lanes, both in device memory
template <int KW>
__device__ __forceinline__ bool lt_global(const MergeDesc& d, int64_t j, int64_t i) {
#pragma unroll
  for (int l = 0; l < KW; ++l) {
    const uint32_t b = d.b[l][j * d.b_stride[l]], a = d.a[l][i * d.a_stride[l]];
    if (a != b) return b < a;
  }
  return false;
}

// rows of A among the first `diag` merged rows (stable: A first on ties):
// the smallest i with B[diag - i - 1] < A[i]
template <int KW>
__global__ void merge_partition(const __grid_constant__ MergeDesc d, int64_t tile, int64_t n_splits,
                                int64_t* splits) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_splits) return;
  const int64_t total = d.na + d.nb;
  const int64_t diag = t * tile < total ? t * tile : total;
  int64_t lo = diag - d.nb > 0 ? diag - d.nb : 0;
  int64_t hi = diag < d.na ? diag : d.na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (lt_global<KW>(d, diag - mid - 1, mid)) hi = mid;
    else lo = mid + 1;
  }
  splits[t] = lo;
}

// shared-memory keys are row-major: row u at s[u * KW]
template <int KW>
__device__ __forceinline__ bool lt_shared(const uint32_t* s, int x, int y) {
#pragma unroll
  for (int l = 0; l < KW; ++l) {
    const uint32_t a = s[x * KW + l], b = s[y * KW + l];
    if (a != b) return a < b;
  }
  return false;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

// the key lanes of rows [r0, r0 + n) of one run into s[u0 * KW ...]
template <int KW>
__device__ __forceinline__ void stage_keys(const uint32_t* const* p, const int64_t* stride,
                                           bool block, int64_t r0, int n, uint32_t* s) {
  if (block) {  // one contiguous range of n * KW words
    const uint32_t* g = p[0] + r0 * KW;
    for (int w = threadIdx.x; w < n * KW; w += kThreads) cp_async4(s + w, g + w);
  } else {
    for (int u = threadIdx.x; u < n; u += kThreads) {
#pragma unroll
      for (int l = 0; l < KW; ++l) cp_async4(s + u * KW + l, p[l] + (r0 + u) * stride[l]);
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(kThreads) merge_tile(const __grid_constant__ MergeDesc d,
                                                       const int64_t* __restrict__ splits) {
  constexpr int kTile = tile_rows(KW);
  constexpr int kItems = kTile / kThreads;
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;                                   // kTile * KW keys
  uint16_t* ssrc = (uint16_t*)(smem + (size_t)kTile * KW);  // kTile source rows
  const int64_t total = d.na + d.nb;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = d0 + kTile < total ? d0 + kTile : total;
  const int64_t a0 = splits[blockIdx.x], a1 = splits[blockIdx.x + 1];
  const int64_t b0 = d0 - a0;
  const int la = (int)(a1 - a0);
  const int lb = (int)((d1 - a1) - b0);
  const int cnt = la + lb;
  // A's rows at shared rows [0, la), B's at [la, cnt)
  stage_keys<KW>(d.a, d.a_stride, d.a_block, a0, la, skey);
  stage_keys<KW>(d.b, d.b_stride, d.b_block, b0, lb, skey + (size_t)la * KW);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  // co-rank this thread's first output in shared memory, then merge serially
  int dt = threadIdx.x * kItems;
  if (dt > cnt) dt = cnt;
  int lo = dt - lb > 0 ? dt - lb : 0;
  int hi = dt < la ? dt : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lt_shared<KW>(skey, la + (dt - mid - 1), mid)) hi = mid;
    else lo = mid + 1;
  }
  int i = lo, j = dt - lo;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (dt + q >= cnt) break;
    const bool take_a = j >= lb || (i < la && !lt_shared<KW>(skey, la + j, i));
    ssrc[dt + q] = (uint16_t)(take_a ? i++ : la + j++);
  }
  __syncthreads();
  // keys out of shared memory
  for (int u = threadIdx.x; u < cnt; u += kThreads) {
    const int s = ssrc[u];
#pragma unroll
    for (int l = 0; l < KW; ++l) d.out[l][(d0 + u) * d.out_stride[l]] = skey[s * KW + l];
  }
  // payload lanes from the recorded source rows, kBatch loads in flight a
  // thread before their stores
  for (int l = KW; l < d.n_lanes; ++l) {
    const uint32_t* pa = d.a[l];
    const uint32_t* pb = d.b[l];
    const int64_t sa = d.a_stride[l], sb = d.b_stride[l];
    uint32_t* o = d.out[l];
    const int64_t so = d.out_stride[l];
    for (int u0 = threadIdx.x; u0 < cnt; u0 += kThreads * kBatch) {
      uint32_t v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int u = u0 + k * kThreads;
        if (u < cnt) {
          const int s = ssrc[u];
          v[k] = s < la ? pa[(a0 + s) * sa] : pb[(b0 + (s - la)) * sb];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int u = u0 + k * kThreads;
        if (u < cnt) o[(d0 + u) * so] = v[k];
      }
    }
  }
}

template <int KW>
int launch(const MergeDesc& d, void* splits, int64_t n_splits, cudaStream_t s) {
  constexpr int kTile = tile_rows(KW);
  const int64_t total = d.na + d.nb;
  const int64_t T = (total + kTile - 1) / kTile;
  MHM2_REQUIRE(n_splits == T + 1);
  constexpr size_t sm = (size_t)kTile * KW * sizeof(uint32_t) + (size_t)kTile * sizeof(uint16_t);
  static_assert(sm <= 48 * 1024, "a tile's keys and sources fit 48 KB without an opt-in");
  merge_partition<KW><<<(unsigned)((n_splits + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      d, kTile, n_splits, (int64_t*)splits);
  merge_tile<KW><<<(unsigned)T, kThreads, sm, s>>>(d, (const int64_t*)splits);
  return (int)cudaGetLastError();
}

// the range cuts' runs, by value (pointer, element stride, live rows) in
// the kernel's 4 KB of parameters; ops/sort.py's RANGE_MAX_RUNS
constexpr int kRangeMaxParts = 160;
constexpr int kRangeWarps = 8;  // edges a block, one a warp

struct RangeDesc {
  const uint32_t* p[kRangeMaxParts];
  int64_t stride[kRangeMaxParts];
  int32_t n[kRangeMaxParts];
  int parts, ranges;
  int64_t total;
};

// rows of run j whose key is <= v (kUpper) or < v
template <bool kUpper>
__device__ __forceinline__ int64_t rank_in_run(const RangeDesc& d, int j, uint32_t v) {
  const uint32_t* p = d.p[j];
  const int64_t s = d.stride[j];
  int64_t lo = 0, hi = d.n[j];
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const uint32_t x = p[mid * s];
    if (kUpper ? x <= v : x < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kRangeWarps * 32)
    range_cuts_kernel(const __grid_constant__ RangeDesc d, int64_t* __restrict__ cuts,
                      int64_t* __restrict__ edges) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kRangeWarps + (threadIdx.x >> 5) + 1;
  if (q >= d.ranges) return;  // the whole warp
  const int64_t row = d.ranges + 1;
  uint32_t v = 0;
  if (d.total > 0) {
    const long long t = (d.total - 1) * q / d.ranges;
    uint32_t lo = 0, hi = 0xFFFFFFFFu;  // the answer lies in [lo, hi]
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      long long c = 0;
      for (int j = lane; j < d.parts; j += 32) c += rank_in_run<true>(d, j, mid);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
      if (c > t) hi = mid;
      else lo = mid + 1;
    }
    v = lo;
  }
  for (int j = lane; j < d.parts; j += 32) {
    cuts[j * row + q] = rank_in_run<false>(d, j, v);
    if (q == 1) {
      cuts[j * row] = 0;
      cuts[j * row + d.ranges] = d.n[j];
    }
  }
  if (lane == 0) edges[q - 1] = v;
}

}  // namespace

extern "C" int mhm2_merge_tile_rows(int kw) { return tile_rows(kw); }

// a, b: n_lanes lanes (pointer, element stride) of na / nb rows, sorted on
// their first kw lanes; out: n_lanes lanes of na + nb rows; splits: int64
// scratch of ceil((na + nb) / tile rows) + 1 entries (the tile co-ranks).
extern "C" int mhm2_merge(const void* const* a, const int64_t* a_stride, int64_t na,
                          const void* const* b, const int64_t* b_stride, int64_t nb,
                          void* const* out, const int64_t* out_stride, int n_lanes, int kw,
                          void* splits, int64_t n_splits, void* stream) {
  MHM2_REQUIRE(n_lanes >= kw && kw >= 1 && kw <= 8 && n_lanes <= MHM2_MAX_LANES);
  MHM2_REQUIRE(na >= 0 && nb >= 0 && na + nb < (1ll << 31));
  if (na + nb == 0) return (int)cudaGetLastError();
  MergeDesc d = {};
  for (int l = 0; l < n_lanes; ++l) {
    d.a[l] = (const uint32_t*)a[l];
    d.a_stride[l] = a_stride[l];
    d.b[l] = (const uint32_t*)b[l];
    d.b_stride[l] = b_stride[l];
    d.out[l] = (uint32_t*)out[l];
    d.out_stride[l] = out_stride[l];
  }
  d.na = na;
  d.nb = nb;
  d.n_lanes = n_lanes;
  d.a_block = d.b_block = 1;
  for (int l = 0; l < kw; ++l) {
    d.a_block &= d.a[l] == d.a[0] + l && d.a_stride[l] == kw;
    d.b_block &= d.b[l] == d.b[0] + l && d.b_stride[l] == kw;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (kw) {
    case 1: return launch<1>(d, splits, n_splits, s);
    case 2: return launch<2>(d, splits, n_splits, s);
    case 3: return launch<3>(d, splits, n_splits, s);
    case 4: return launch<4>(d, splits, n_splits, s);
    case 5: return launch<5>(d, splits, n_splits, s);
    case 6: return launch<6>(d, splits, n_splits, s);
    case 7: return launch<7>(d, splits, n_splits, s);
    case 8: return launch<8>(d, splits, n_splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lanes: n_parts runs' word 0 (pointer, element stride), each sorted as
// u32, with counts[j] live rows (< 2^31); n_ranges = Q >= 2. cuts: (n_parts,
// Q + 1) int64, run j's row offsets of the Q ranges (0 and counts[j] at the
// ends); edges: (Q - 1) int64, the key each inner cut starts at (0 when no
// run has a row).
extern "C" int mhm2_range_cuts(const void* const* lanes, const int64_t* strides,
                               const int64_t* counts, int n_parts, int n_ranges, void* cuts,
                               void* edges, void* stream) {
  MHM2_REQUIRE(n_parts >= 1 && n_parts <= kRangeMaxParts && n_ranges >= 2);
  RangeDesc d = {};
  int64_t total = 0;
  for (int j = 0; j < n_parts; ++j) {
    MHM2_REQUIRE(counts[j] >= 0 && counts[j] < (1ll << 31));
    d.p[j] = (const uint32_t*)lanes[j];
    d.stride[j] = strides[j];
    d.n[j] = (int32_t)counts[j];
    total += counts[j];
  }
  d.parts = n_parts;
  d.ranges = n_ranges;
  d.total = total;
  const int blocks = (n_ranges - 1 + kRangeWarps - 1) / kRangeWarps;
  range_cuts_kernel<<<blocks, kRangeWarps * 32, 0, (cudaStream_t)stream>>>(d, (int64_t*)cuts,
                                                                            (int64_t*)edges);
  return (int)cudaGetLastError();
}
