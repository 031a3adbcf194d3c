// scan: segmented group sums over lexsorted rows.
//
// Replaces mhm2_proxy_tpu/ops/pallas_scan.py:245 `group_sums_scan_packed`
// (kernel body `_packed_scan_kernel`, :163) and :277 `group_sums_scan_lanes`
// (`_scan_kernel`, :79, over `seg_group_sums`, :105). Two entry points:
//   lanes:  n_pay <= 9 int32 payload lanes and a group-start flag per row ->
//           each lane's inclusive group sum up to the row, clamped;
//   packed: weff sorted packed record lanes (the 7-bit read payload in the
//           last lane's free low bits, all-ones sentinels) -> the count and
//           ext one-hot group sums, clamped, as the five lanes of
//           ops/count.py::_pack_sums. Group starts and one-hots come from
//           the key bits, as in the TPU kernel.
// Both are valid at group-last rows, which is where callers read them.
//
// What bounds it on an H100: memory. The lanes variant reads 9 lanes and
// the flags twice (aggregate and apply) and writes 9 lanes, ~110 bytes a
// row; the packed one reads weff lanes twice (plus the neighbour row, from
// L1) and writes 5, ~(8 weff + 20) bytes a row.
// Design: the TPU carries each tile's open group sums to the next grid step
// in SMEM; Hopper blocks run in no order, so both variants use segscan.cuh's
// three launches (block aggregates, one carry block, apply) with the
// saturating segmented operator, which equals the reference's clamp of the
// exact sums. The packed variant masks the payload bits with a plain AND:
// the TPU kernel's subtraction form dodges a Mosaic miscompile only.
#include "segscan.cuh"

namespace {

// n_pay payload lanes (int32, >= 0) plus one start flag (bool bytes) per row
struct LaneRows {
  CLanes pay;
  int n_pay;
  const uint8_t* start;

  __device__ __forceinline__ Seg row(int64_t r) const {
    Seg e;
    e.f = start[r] != 0;
    // static lane bound: the pointer struct stays in the parameter bank
#pragma unroll
    for (int c = 0; c < kSegValues; ++c) e.v[c] = c < n_pay ? (int)pay.p[c][r] : 0;
    return e;
  }
};

__device__ __forceinline__ uint32_t clamp_to(int v, int clamp) {
  return (uint32_t)(v < clamp ? v : clamp);
}

__global__ void scan_lanes_apply(LaneRows rows, int64_t N, int clamp, const int* carry, Lanes out) {
  const int64_t base = (int64_t)blockIdx.x * kSegTile + threadIdx.x * kSegItems;
  Seg inc[kSegItems];
  seg_block_rows(rows, N, carry, base, inc);
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    const int64_t r = base + q;
    if (r >= N) break;
#pragma unroll
    for (int c = 0; c < kSegValues; ++c)
      if (c < rows.n_pay) out.p[c][r] = clamp_to(inc[q].v[c], clamp);
  }
}

template <int WEFF>
__global__ void scan_packed_apply(KeyRows<WEFF> rows, int64_t N, int clamp, const int* carry,
                                  Lanes out) {
  const int64_t base = (int64_t)blockIdx.x * kSegTile + threadIdx.x * kSegItems;
  Seg inc[kSegItems];
  seg_block_rows(rows, N, carry, base, inc);
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    const int64_t r = base + q;
    if (r >= N) break;
    uint32_t s[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) s[c] = clamp_to(inc[q].v[c], clamp);
    out.p[0][r] = s[0];
    out.p[1][r] = s[1] | (s[2] << 16);
    out.p[2][r] = s[3] | (s[4] << 16);
    out.p[3][r] = s[5] | (s[6] << 16);
    out.p[4][r] = s[7] | (s[8] << 16);
  }
}

template <class Rows>
void aggregate_and_carry(const Rows& rows, int64_t N, int64_t T, int* agg_f, int* agg_v,
                         int* carry, cudaStream_t s) {
  seg_aggregate<Rows><<<(unsigned)T, kSegThreads, 0, s>>>(rows, N, agg_f, agg_v);
  seg_carry<<<1, kSegCarryThreads, 0, s>>>(agg_f, agg_v, T, carry);
}

template <int WEFF>
void launch_packed(const CLanes& in, int64_t N, uint32_t keymask, int clamp, const Lanes& o,
                   int* af, int* av, int* cy, cudaStream_t s) {
  const int64_t T = (N + kSegTile - 1) / kSegTile;
  KeyRows<WEFF> rows{in, keymask, 0};
  aggregate_and_carry(rows, N, T, af, av, cy, s);
  scan_packed_apply<WEFF><<<(unsigned)T, kSegThreads, 0, s>>>(rows, N, clamp, cy, o);
}

}  // namespace

// pay: n_pay (<= 9) int32 lanes of N rows, start: (N,) bool; outs: n_pay
// int32 lanes; scratch: agg_f (T,), agg_v and carry (T * 9,) i32 with
// T = ceil(N / 1024). 0 <= clamp.
extern "C" int mhm2_scan_lanes(const void* const* pay, int n_pay, const void* start, int64_t N,
                               int clamp, void* const* outs, void* agg_f, void* agg_v,
                               void* carry, void* stream) {
  MHM2_REQUIRE(n_pay >= 1 && n_pay <= kSegValues && clamp >= 0 && N >= 0 && N < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  const int64_t T = (N + kSegTile - 1) / kSegTile;
  cudaStream_t s = (cudaStream_t)stream;
  LaneRows rows{make_clanes(pay, n_pay), n_pay, (const uint8_t*)start};
  aggregate_and_carry(rows, N, T, (int*)agg_f, (int*)agg_v, (int*)carry, s);
  scan_lanes_apply<<<(unsigned)T, kSegThreads, 0, s>>>(rows, N, clamp, (const int*)carry,
                                                       make_lanes(outs, n_pay));
  return (int)cudaGetLastError();
}

// lanes: weff sorted packed lanes of N rows; keymask: the key bits of the
// last lane; outs: the 5 _pack_sums lanes of N rows; scratch as above.
// 0 <= clamp <= 0xFFFF (sums are packed in 16-bit fields).
extern "C" int mhm2_scan_packed(const void* const* lanes, int weff, int64_t N, uint32_t keymask,
                                int clamp, void* const* outs, void* agg_f, void* agg_v,
                                void* carry, void* stream) {
  MHM2_REQUIRE(weff >= 1 && weff <= 7 && clamp >= 0 && clamp <= 0xFFFF);
  MHM2_REQUIRE(N >= 0 && N < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  CLanes in = make_clanes(lanes, weff);
  Lanes o = make_lanes(outs, 5);
  cudaStream_t s = (cudaStream_t)stream;
  int* af = (int*)agg_f;
  int* av = (int*)agg_v;
  int* cy = (int*)carry;
  switch (weff) {
    case 1: launch_packed<1>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 2: launch_packed<2>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 3: launch_packed<3>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 4: launch_packed<4>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 5: launch_packed<5>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 6: launch_packed<6>(in, N, keymask, clamp, o, af, av, cy, s); break;
    case 7: launch_packed<7>(in, N, keymask, clamp, o, af, av, cy, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
