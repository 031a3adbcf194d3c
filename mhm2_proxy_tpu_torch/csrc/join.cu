// join: answer propagation over a merged sort-join run, routed back to
// query order.
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

__device__ __forceinline__ uint32_t answer(uint32_t src, uint32_t n_valid, int payload_bits) {
  const uint32_t idx = src & kIdxMask;
  if ((src & kQueryBit) || idx >= n_valid) return 0u;
  return ((idx + 1u) << payload_bits) | (src >> 26);
}

template <int KW>
__device__ __forceinline__ bool same_key(const CLanes& keys, int64_t q, const uint32_t* kp) {
#pragma unroll
  for (int l = 0; l < KW; ++l)
    if (keys.p[l][q] != kp[l]) return false;
  return true;
}

template <int KW>
__global__ void join_kernel(CLanes keys, const uint32_t* __restrict__ src, int64_t M,
                            const int32_t* __restrict__ n_valid_p, int payload_bits, int reach,
                            uint32_t* __restrict__ ans, int64_t Q) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= M) return;
  const uint32_t s = src[p];
  if (!(s & kQueryBit)) return;
  const int64_t dest = s & kIdxMask;
  if (dest >= Q) return;  // query ids are arange(Q): never taken
  const uint32_t n_valid = (uint32_t)*n_valid_p;
  uint32_t kp[KW];
#pragma unroll
  for (int l = 0; l < KW; ++l) kp[l] = keys.p[l][p];
  uint32_t best = 0u;
  for (int d = 1; d <= reach && p - d >= 0; ++d) {
    if (!same_key<KW>(keys, p - d, kp)) break;
    best = max(best, answer(src[p - d], n_valid, payload_bits));
  }
  for (int d = 1; d <= reach && p + d < M; ++d) {
    if (!same_key<KW>(keys, p + d, kp)) break;
    best = max(best, answer(src[p + d], n_valid, payload_bits));
  }
  ans[dest] = best;
}

template <int KW>
void launch(int64_t blocks, cudaStream_t s, const CLanes& k, const uint32_t* src, int64_t M,
            const int32_t* nv, int pb, int reach, uint32_t* ans, int64_t Q) {
  join_kernel<KW><<<(unsigned)blocks, kThreads, 0, s>>>(k, src, M, nv, pb, reach, ans, Q);
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
  CLanes k = make_clanes(keys, kw);
  const int64_t blocks = (M + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* sp = (const uint32_t*)src;
  const int32_t* nv = (const int32_t*)n_valid;
  uint32_t* a = (uint32_t*)ans;
  switch (kw) {
    case 1: launch<1>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 2: launch<2>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 3: launch<3>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 4: launch<4>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 5: launch<5>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 6: launch<6>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 7: launch<7>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    case 8: launch<8>(blocks, s, k, sp, M, nv, payload_bits, reach, a, Q); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
