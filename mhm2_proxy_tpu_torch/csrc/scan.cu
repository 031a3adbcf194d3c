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
// Design: one launch with a decoupled look-back (seglookback.cuh, shared
// with finalize.cu): a 256-thread block takes a 2048-row tile by atomic
// ticket, loads its rows once into registers, 8 consecutive rows a thread,
// and scans them after its carry arrives from the predecessors' status
// words. The rows' sums then come from the rows still in registers, and
// are stored once. Where the clamp is <= 0xFFFF (every caller:
// MAX_KMER_COUNT) the nine sums are 16-bit saturating halves of five
// words, so each scan step moves six words, not ten; a larger clamp takes
// the 32-bit form. Lane counts are template parameters (a runtime lane
// index would put the lane pointers in local memory). The packed form
// masks the payload bits with a plain AND: the TPU kernel's subtraction
// form dodges a Mosaic miscompile only.
#include "seglookback.cuh"

namespace {

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
__global__ void __launch_bounds__(kSegThreads)
    scan_lanes_kernel(const __grid_constant__ LanesArgs a) {
  __shared__ TileShared<NW> sh;
  __shared__ int64_t s_tile;
  const int64_t t = take_tile(a.lb.ticket, a.lb.T, &s_tile);
  const int64_t row0 = t * kSegTile + (int64_t)threadIdx.x * kSegItems;
  uint32_t fl = 0;
  if (a.start_aligned && row0 + kSegItems <= a.N) {
    const uint2 b = __ldcs((const uint2*)(a.start + row0));
#pragma unroll
    for (int q = 0; q < kSegItems; ++q)
      fl |= (((q < 4 ? b.x : b.y) >> (8 * (q & 3))) & 0xFFu) ? 1u << q : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) fl |= (row0 + q < a.N && a.start[row0 + q]) ? 1u << q : 0u;
  }
  uint32_t v[kSegItems][NW];
#pragma unroll
  for (int q = 0; q < kSegItems; ++q)
#pragma unroll
    for (int c = 0; c < NW; ++c) v[q][c] = 0;
#pragma unroll
  for (int c = 0; c < NPAY; ++c) {
    uint32_t x[kSegItems];
    load_rows(a.pay.p[c], row0, a.N, (a.aligned >> c) & 1u, x);
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) {
      if (NW == 5)
        v[q][c >> 1] |= (x[q] < kHalfMax ? x[q] : kHalfMax) << (16 * (c & 1));
      else
        v[q][c] = x[q];
    }
  }
  tile_scan<NW>(a.lb, t, fl, v, sh);
#pragma unroll
  for (int c = 0; c < NPAY; ++c) {
    uint32_t y[kSegItems];
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) {
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
__global__ void __launch_bounds__(kSegThreads)
    scan_packed_kernel(const __grid_constant__ PackedArgs a) {
  __shared__ TileShared<5> sh;
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_key[kSegThreads][WEFF];  // each thread's last key
  const int64_t t = take_tile(a.lb.ticket, a.lb.T, &s_tile);
  const int tid = threadIdx.x;
  const int64_t row0 = t * kSegTile + (int64_t)tid * kSegItems;
  uint32_t k[kSegItems][WEFF];
#pragma unroll
  for (int l = 0; l < WEFF; ++l) {
    uint32_t x[kSegItems];
    load_rows(a.in.p[l], row0, a.N, (a.aligned >> l) & 1u, x);
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) k[q][l] = x[q];
  }
  uint32_t last_raw[kSegItems];  // the key bits and the read payload
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    last_raw[q] = k[q][WEFF - 1];
    k[q][WEFF - 1] &= a.keymask;
  }
#pragma unroll
  for (int l = 0; l < WEFF; ++l) s_key[tid][l] = k[kSegItems - 1][l];
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
  uint32_t v[kSegItems][5];
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
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
    uint32_t y[kSegItems];
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) y[q] = __vminu2(v[q][c], a.clamp2);
    store_rows(a.out.p[c], row0, a.N, (a.aligned >> (16 + c)) & 1u, y);
  }
}

unsigned aligned_mask(const void* const* in, int n_in, void* const* out, int n_out) {
  unsigned m = 0;
  for (int i = 0; i < n_in; ++i) m |= aligned16(in[i]) ? 1u << i : 0u;
  for (int i = 0; i < n_out; ++i) m |= aligned16(out[i]) ? 1u << (16 + i) : 0u;
  return m;
}

template <int NW, int NPAY>
void launch_lanes(const LanesArgs& a, cudaStream_t s) {
  scan_lanes_kernel<NPAY, NW><<<(unsigned)a.lb.T, kSegThreads, 0, s>>>(a);
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

}  // namespace

// pay: n_pay (<= 9) int32 lanes of N rows, values >= 0; start: (N,) bool;
// outs: n_pay int32 lanes; status: >= T u64 words, zero or of earlier
// generations; vals: T * 18 u32; ticket: one int32, 0 between calls; gen in
// [1, 2^31), one more than the last call's (T = ceil(N / 2048)).
// 0 <= clamp; clamp <= 0xFFFF takes the 16-bit form.
extern "C" int mhm2_scan_lanes(const void* const* pay, int n_pay, const void* start, int64_t N,
                               int clamp, void* const* outs, void* status, int64_t status_words,
                               void* vals, void* ticket, int64_t gen, void* stream) {
  MHM2_REQUIRE(n_pay >= 1 && n_pay <= kSegMaxWords && clamp >= 0 && N >= 0 && N < (1ll << 31));
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
    case 1: scan_packed_kernel<1><<<T, kSegThreads, 0, s>>>(a); break;
    case 2: scan_packed_kernel<2><<<T, kSegThreads, 0, s>>>(a); break;
    case 3: scan_packed_kernel<3><<<T, kSegThreads, 0, s>>>(a); break;
    case 4: scan_packed_kernel<4><<<T, kSegThreads, 0, s>>>(a); break;
    case 5: scan_packed_kernel<5><<<T, kSegThreads, 0, s>>>(a); break;
    case 6: scan_packed_kernel<6><<<T, kSegThreads, 0, s>>>(a); break;
    case 7: scan_packed_kernel<7><<<T, kSegThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
