// join: answer propagation over a merged sort-join run, routed back to
// query order.
//
// Two source layouts. Fused (mhm2_join): one u32 source lane, described
// below. Separate lanes (mhm2_join_sep, for tables or query sets of 2^25
// rows and more, or wide payloads: the reference's XLA branch,
// mhm2_proxy_tpu/ops/lookup.py:144-247): a source lane of row idx with bit
// 31 set on query rows, and a payload lane; a valid table row answers the
// u64 (idx + 1) << 32 | payload. The walk is the same.
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
// of it, 0 if there is none, stored at its query index.
//
// What bounds it on an H100: memory. Each row's key and source lanes are
// read once in a coalesced sweep; a query row's run neighbours are the
// adjacent rows, served from L1/L2; the answers are 4-byte stores in query
// order, scattered, since the merged rows are in key order.
// Design: the TPU kernel spreads the answer with log2(max_dup) doubling
// shifts over a tile canvas with a one-row halo carried from the previous
// tile and peeked from the next, then compacts the query rows in the tile,
// because Mosaic can neither index a neighbour freely nor scatter. Hopper
// can do both, so one thread per merged row: a query row walks its own run
// backward and forward, at most `reach` rows each way, stopping at the
// first different key, and stores the maximum answer at its query index.
// Since the rows are sorted, equal keys at distance d imply an equal run
// between, so this is exactly what the doubling shifts compute (reach =
// the doubling's span, 2^ceil(log2 max_dup) - 1), and no tile, halo,
// compaction or destination sort is left.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kQueryBit = 1u << 25;
constexpr uint32_t kIdxMask = kQueryBit - 1u;

// the fused source lane: table idx | payload << 26, or query idx | 1 << 25
struct FusedSrc {
  const uint32_t* src;
  int payload_bits;
  typedef uint32_t Answer;
  __device__ __forceinline__ bool query(int64_t p, int64_t* dest) const {
    const uint32_t s = src[p];
    *dest = s & kIdxMask;
    return (s & kQueryBit) != 0;
  }
  __device__ __forceinline__ Answer answer(int64_t p, uint32_t n_valid) const {
    const uint32_t s = src[p];
    const uint32_t idx = s & kIdxMask;
    if ((s & kQueryBit) || idx >= n_valid) return 0u;
    return ((idx + 1u) << payload_bits) | (s >> 26);
  }
};

// separate lanes: row idx (bit 31 on query rows) and the table's payload
struct SepSrc {
  const uint32_t* src;
  const uint32_t* pay;
  typedef unsigned long long Answer;
  __device__ __forceinline__ bool query(int64_t p, int64_t* dest) const {
    const uint32_t s = src[p];
    *dest = s & 0x7FFFFFFFu;
    return (s >> 31) != 0;
  }
  __device__ __forceinline__ Answer answer(int64_t p, uint32_t n_valid) const {
    const uint32_t s = src[p];
    if ((s >> 31) || s >= n_valid) return 0ull;
    return ((unsigned long long)(s + 1u) << 32) | pay[p];
  }
};

template <int KW>
__device__ __forceinline__ bool same_key(const CLanes& keys, int64_t q, const uint32_t* kp) {
#pragma unroll
  for (int l = 0; l < KW; ++l)
    if (keys.p[l][q] != kp[l]) return false;
  return true;
}

template <int KW, class Src>
__global__ void join_kernel(CLanes keys, Src src, int64_t M, const int32_t* __restrict__ n_valid_p,
                            int reach, typename Src::Answer* __restrict__ ans, int64_t Q) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= M) return;
  int64_t dest;
  if (!src.query(p, &dest)) return;
  if (dest >= Q) return;  // query ids are arange(Q): never taken
  const uint32_t n_valid = (uint32_t)*n_valid_p;
  uint32_t kp[KW];
#pragma unroll
  for (int l = 0; l < KW; ++l) kp[l] = keys.p[l][p];
  typename Src::Answer best = 0;
  for (int d = 1; d <= reach && p - d >= 0; ++d) {
    if (!same_key<KW>(keys, p - d, kp)) break;
    const typename Src::Answer a = src.answer(p - d, n_valid);
    best = a > best ? a : best;
  }
  for (int d = 1; d <= reach && p + d < M; ++d) {
    if (!same_key<KW>(keys, p + d, kp)) break;
    const typename Src::Answer a = src.answer(p + d, n_valid);
    best = a > best ? a : best;
  }
  ans[dest] = best;
}

template <class Src>
int launch(int kw, int64_t M, cudaStream_t s, const CLanes& k, const Src& src, const int32_t* nv,
           int reach, typename Src::Answer* ans, int64_t Q) {
  const unsigned blocks = (unsigned)((M + kThreads - 1) / kThreads);
  switch (kw) {
    case 1: join_kernel<1, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 2: join_kernel<2, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 3: join_kernel<3, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 4: join_kernel<4, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 5: join_kernel<5, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 6: join_kernel<6, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 7: join_kernel<7, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    case 8: join_kernel<8, Src><<<blocks, kThreads, 0, s>>>(k, src, M, nv, reach, ans, Q); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// keys: kw lane pointers and src: the source lane, M merged rows sorted on
// the keys; n_valid: device pointer to the table's valid row count (i32);
// ans: Q u32 answers, one per query index (the caller zero-fills it).
extern "C" int mhm2_join(const void* const* keys, int kw, const void* src, int64_t M,
                         const void* n_valid, int payload_bits, int reach, void* ans, int64_t Q,
                         void* stream) {
  MHM2_REQUIRE(kw >= 1 && kw <= 8 && payload_bits >= 0 && payload_bits <= 6 && reach >= 0);
  MHM2_REQUIRE(M >= 0 && M < (1ll << 31) && Q >= 0 && Q <= (1ll << 25));
  if (M == 0) return (int)cudaGetLastError();
  return launch(kw, M, (cudaStream_t)stream, make_clanes(keys, kw),
                FusedSrc{(const uint32_t*)src, payload_bits}, (const int32_t*)n_valid, reach,
                (uint32_t*)ans, Q);
}

// The separate-lane layout: src (row idx, bit 31 on query rows) and pay
// (the table rows' payload); ans: Q u64 answers (zero-filled by the caller).
extern "C" int mhm2_join_sep(const void* const* keys, int kw, const void* src, const void* pay,
                             int64_t M, const void* n_valid, int reach, void* ans, int64_t Q,
                             void* stream) {
  MHM2_REQUIRE(kw >= 1 && kw <= 8 && reach >= 0);
  MHM2_REQUIRE(M >= 0 && M < (1ll << 31) && Q >= 0 && Q < (1ll << 31));
  if (M == 0) return (int)cudaGetLastError();
  return launch(kw, M, (cudaStream_t)stream, make_clanes(keys, kw),
                SepSrc{(const uint32_t*)src, (const uint32_t*)pay}, (const int32_t*)n_valid,
                reach, (unsigned long long*)ans, Q);
}
