// sort: merge of two sorted multi-lane runs.
//
// Replaces mhm2_proxy_tpu/ops/pallas_sort.py:158 `_bitonic_network`
// (kernels `_tail_kernel` :110 and `_cross_kernel` :120; entry points
// `_merge_anylen_core` :243, merge_sorted_lanes_padded :289,
// merge_sorted_lanes_tiled :296, merge_sorted_lanes :307). Rows are tuples
// of u32 lanes lexsorted on their first kw lanes (lane 0 most significant,
// unsigned, so the all-ones sentinel sorts last). Output rows at positions
// >= len(A) + len(B) are pad rows: all-ones keys and fill[l] in the other
// lanes (the `_tiled` / pad_fill variant).
//
// What bounds it on an H100: memory. A merge reads and writes every lane
// once (the bitonic network on the TPU makes ~1.5 log2(n_tiles) + 2 passes
// because its grid cannot search); the co-rank searches add O(log n)
// dependent loads per block, hidden by the other blocks in flight.
// Design: merge path. Each block owns 1024 consecutive output rows, finds
// the co-rank split of its first and last output diagonal by binary search
// on the multi-lane unsigned key (two threads in different warps), stages
// only the key lanes of its input ranges in shared memory, lets each
// thread co-rank and merge four outputs sequentially, records each
// output's source row, and finally copies every lane with coalesced
// stores. The merge is stable (A before B on equal keys), so it equals a
// stable lexsort of the concatenation bit for bit. Any lengths work: no
// power-of-two or tile-multiple layout exists to get wrong at 1120 tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // output rows per block

struct Fill {
  uint32_t v[MHM2_MAX_LANES];
};

template <int KW>
__device__ __forceinline__ bool lt_global(const CLanes& x, int64_t i, const CLanes& y, int64_t j) {
#pragma unroll
  for (int l = 0; l < KW; ++l) {
    uint32_t a = x.p[l][i], b = y.p[l][j];
    if (a != b) return a < b;
  }
  return false;
}

template <int KW>
__device__ __forceinline__ bool lt_shared(const uint32_t* s, int x, int y) {
#pragma unroll
  for (int l = 0; l < KW; ++l) {
    uint32_t a = s[l * kTile + x], b = s[l * kTile + y];
    if (a != b) return a < b;
  }
  return false;
}

// number of A rows among the first d merged rows (stable: A first on ties):
// the smallest i with B[d-i-1] < A[i]
template <int KW>
__device__ __forceinline__ int64_t corank(int64_t d, const CLanes& A, int64_t na, const CLanes& B, int64_t nb) {
  int64_t lo = d - nb > 0 ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (lt_global<KW>(B, d - mid - 1, A, mid)) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

template <int KW>
__global__ void merge_kernel(CLanes A, int64_t na, CLanes B, int64_t nb, Lanes out, int n_lanes,
                             int64_t n_out, Fill fill) {
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;                            // KW * kTile keys
  int32_t* ssrc = (int32_t*)(smem + KW * kTile);    // kTile source rows
  __shared__ int64_t s_a0, s_a1;
  const int64_t total = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t d1 = d0 + kTile < n_out ? d0 + kTile : n_out;
  const int64_t m0 = d0 < total ? d0 : total;
  const int64_t m1 = d1 < total ? d1 : total;
  if (threadIdx.x == 0) s_a0 = corank<KW>(m0, A, na, B, nb);
  if (threadIdx.x == 32) s_a1 = corank<KW>(m1, A, na, B, nb);
  __syncthreads();
  const int64_t a0 = s_a0, b0 = m0 - s_a0;
  const int la = (int)(s_a1 - s_a0);
  const int lb = (int)((m1 - s_a1) - b0);
  const int cnt = la + lb;
  for (int u = threadIdx.x; u < cnt; u += kThreads) {
#pragma unroll
    for (int l = 0; l < KW; ++l)
      skey[l * kTile + u] = u < la ? A.p[l][a0 + u] : B.p[l][b0 + (u - la)];
  }
  __syncthreads();
  // B row j of the block lives at shared index la + j
  int dt = threadIdx.x * kItems;
  if (dt > cnt) dt = cnt;
  int lo = dt - lb > 0 ? dt - lb : 0;
  int hi = dt < la ? dt : la;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (lt_shared<KW>(skey, la + (dt - mid - 1), mid)) hi = mid;
    else lo = mid + 1;
  }
  int i = lo, j = dt - lo;
  for (int q = 0; q < kItems && dt + q < cnt; ++q) {
    bool take_a = (j >= lb) || (i < la && !lt_shared<KW>(skey, la + j, i));
    if (take_a) ssrc[dt + q] = i++;
    else ssrc[dt + q] = -(++j);  // -(j+1) for B row j
  }
  __syncthreads();
  const int n_here = (int)(d1 - d0);
  for (int u = threadIdx.x; u < n_here; u += kThreads) {
    const int64_t o = d0 + u;
    // lane loops run to the static maximum so the pointer structs stay in
    // the parameter bank (a runtime index would copy them to local memory)
    if (u < cnt) {
      const int s = ssrc[u];
#pragma unroll
      for (int l = 0; l < MHM2_MAX_LANES; ++l)
        if (l < n_lanes) out.p[l][o] = s >= 0 ? A.p[l][a0 + s] : B.p[l][b0 + (-s - 1)];
    } else {
#pragma unroll
      for (int l = 0; l < MHM2_MAX_LANES; ++l)
        if (l < n_lanes) out.p[l][o] = fill.v[l];
    }
  }
}

template <int KW>
void launch(int64_t blocks, cudaStream_t s, const CLanes& A, int64_t na, const CLanes& B,
            int64_t nb, const Lanes& o, int n_lanes, int64_t n_out, const Fill& f) {
  size_t sm = (size_t)(KW + 1) * kTile * sizeof(uint32_t);
  merge_kernel<KW><<<(unsigned)blocks, kThreads, sm, s>>>(A, na, B, nb, o, n_lanes, n_out, f);
}

}  // namespace

// a, b: n_lanes lane pointers of na / nb rows, sorted on their first kw
// lanes; out: n_lanes lanes of n_out >= na + nb rows; fill: n_lanes pad
// values (keys are padded with all-ones regardless).
extern "C" int mhm2_merge(const void* const* a, int64_t na, const void* const* b, int64_t nb,
                          void* const* out, int n_lanes, int kw, int64_t n_out,
                          const uint32_t* fill, void* stream) {
  MHM2_REQUIRE(n_lanes >= kw && kw >= 1 && kw <= 8 && n_lanes <= MHM2_MAX_LANES);
  MHM2_REQUIRE(na >= 0 && nb >= 0 && n_out >= na + nb && na + nb < (1ll << 31));
  if (n_out == 0) return (int)cudaGetLastError();
  CLanes A = make_clanes(a, n_lanes), Bl = make_clanes(b, n_lanes);
  Lanes o = make_lanes(out, n_lanes);
  Fill f = {};
  for (int l = 0; l < n_lanes; ++l) f.v[l] = l < kw ? 0xFFFFFFFFu : fill[l];
  int64_t blocks = (n_out + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kw) {
    case 1: launch<1>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 2: launch<2>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 3: launch<3>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 4: launch<4>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 5: launch<5>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 6: launch<6>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 7: launch<7>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    case 8: launch<8>(blocks, s, A, na, Bl, nb, o, n_lanes, n_out, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
