// finalize: segmented group sums + extension calls + purge over a merged,
// sorted packed run.
//
// Replaces mhm2_proxy_tpu/ops/pallas_finalize.py:246 `scan_purge_compact`
// (kernel body `_kernel`, :123). Input: weff u32 lanes lexsorted, the 7-bit
// read payload (valid | left<<1 | right<<4) in the last lane's free low
// bits, all-ones sentinel rows at the tail. For every row: the group's
// inclusive sums of (count, 4 left one-hots, 4 right one-hots) up to that
// row, exact in int32 and clamped at 65535 afterwards (equal to the
// reference's saturating sums, ops/count.py:203-216); at group-last rows
// the extension calls (kcount_cpu.cpp:173-182, ties T>G>C>A, integer
// dmin_dyn) and the keep rule. Output: the key lanes with the payload bits
// cleared, one packed (count | lcall<<16 | rcall<<24) lane (purge) or the
// five packed group-sum lanes of ops/count.py::_pack_sums (no purge), and a
// class flag per row (0 keep, 1 drop) for the compact kernel.
//
// What bounds it on an H100: memory (~(2 weff + n_out + 1) * 4 bytes per
// row); the 9-value scan is a few dozen integer ops per row.
// Design: the TPU kernel carries the group sums and the previous key from
// one grid step to the next in SMEM over a grid that runs in order, and
// peeks at the next tile's first key. Hopper blocks run in no order, so the
// scan is split in three launches: (1) each 1024-row block reduces its rows
// to one segmented aggregate (any group start?, sums since the block's last
// start); (2) one block scans the aggregates into a carry-in per block;
// (3) each block rescans its rows from its carry-in and evaluates calls and
// purge elementwise. Group starts and ends compare each row with its
// neighbours in device memory directly: a tile edge is no special case.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr int kMaxCount = 0xFFFF;
constexpr int kExtF = 4;
constexpr int kExtX = 5;

struct Seg {
  int f;      // a group starts inside this range
  int v[9];   // sums since the last start (or over the whole range)
};

__device__ __forceinline__ Seg seg_zero() {
  Seg s;
  s.f = 0;
#pragma unroll
  for (int c = 0; c < 9; ++c) s.v[c] = 0;
  return s;
}

// a precedes b
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  Seg r;
  r.f = a.f | b.f;
#pragma unroll
  for (int c = 0; c < 9; ++c) r.v[c] = b.f ? b.v[c] : a.v[c] + b.v[c];
  return r;
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int off) {
  Seg r;
  r.f = __shfl_up_sync(0xffffffffu, x.f, off);
#pragma unroll
  for (int c = 0; c < 9; ++c) r.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], off);
  return r;
}

// Exclusive block scan (blockDim a multiple of 32): returns carry combined
// with the aggregates of all lower threads; *total = carry + everything.
__device__ Seg block_exclusive(const Seg& x, const Seg& carry, Seg* swarp, Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  Seg inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg o = shfl_up(inc, off);
    if (lane >= off) inc = combine(o, inc);
  }
  if (lane == 31) swarp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg wi = lane < nwarps ? swarp[lane] : seg_zero();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Seg o = shfl_up(wi, off);
      if (lane >= off) wi = combine(o, wi);
    }
    Seg prev = shfl_up(wi, 1);
    Seg ex = lane == 0 ? carry : combine(carry, prev);
    if (lane < nwarps) swarp[lane] = ex;
    if (lane == nwarps - 1) *total = combine(carry, wi);
  }
  __syncthreads();
  Seg lane_prev = shfl_up(inc, 1);
  Seg res = lane == 0 ? swarp[warp] : combine(swarp[warp], lane_prev);
  __syncthreads();
  return res;
}

template <int WEFF>
__device__ __forceinline__ void load_key(const CLanes& in, int64_t r, uint32_t keymask,
                                         uint32_t (&key)[WEFF]) {
#pragma unroll
  for (int l = 0; l < WEFF - 1; ++l) key[l] = in.p[l][r];
  key[WEFF - 1] = in.p[WEFF - 1][r] & keymask;
}

template <int WEFF>
__device__ __forceinline__ bool key_eq(const uint32_t (&a)[WEFF], const CLanes& in, int64_t r,
                                       uint32_t keymask) {
  uint32_t b[WEFF];
  load_key<WEFF>(in, r, keymask, b);
  bool eq = true;
#pragma unroll
  for (int l = 0; l < WEFF; ++l) eq = eq && (a[l] == b[l]);
  return eq;
}

template <int WEFF>
__device__ __forceinline__ bool is_sentinel(const uint32_t (&key)[WEFF], uint32_t keymask) {
  bool s = key[WEFF - 1] == keymask;
#pragma unroll
  for (int l = 0; l < WEFF - 1; ++l) s = s && (key[l] == 0xFFFFFFFFu);
  return s;
}

// the row's own (is_start, count + ext one-hots)
template <int WEFF>
__device__ __forceinline__ Seg row_seg(const CLanes& in, int64_t r, uint32_t keymask) {
  uint32_t key[WEFF];
  load_key<WEFF>(in, r, keymask, key);
  Seg e;
  e.f = (r == 0) || !key_eq<WEFF>(key, in, r - 1, keymask);
  const int cin = is_sentinel<WEFF>(key, keymask) ? 0 : 1;
  const uint32_t slast = in.p[WEFF - 1][r];
  const uint32_t left = (slast >> 1) & 7u, right = (slast >> 4) & 7u;
  e.v[0] = cin;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e.v[1 + j] = (left == (uint32_t)j) ? cin : 0;
    e.v[5 + j] = (right == (uint32_t)j) ? cin : 0;
  }
  return e;
}

__device__ __forceinline__ uint32_t ext_call(const int* c4, int count, int dmin_thres) {
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
    int x = key[j] == top ? -1 : key[j];
    runner = x > runner ? x : runner;
  }
  const int top_code = top & 3, top_cnt = top >> 2;
  const int runner_cnt = runner >= 0 ? (runner >> 2) : -1;
  int dmin_dyn = (count + 9) / 10 - 1;
  dmin_dyn = dmin_dyn > dmin_thres ? dmin_dyn : dmin_thres;
  if (top_cnt < dmin_dyn) return kExtX;
  return runner_cnt >= dmin_dyn ? (uint32_t)kExtF : (uint32_t)top_code;
}

template <int WEFF>
__global__ void fin_aggregate(CLanes in, int64_t N, uint32_t keymask, int* agg_f, int* agg_v) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  Seg x = seg_zero();
  for (int q = 0; q < kItems; ++q) {
    if (base + q < N) x = combine(x, row_seg<WEFF>(in, base + q, keymask));
  }
  block_exclusive(x, seg_zero(), swarp, &stotal);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = stotal.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) agg_v[(int64_t)blockIdx.x * 9 + c] = stotal.v[c];
  }
}

__device__ __forceinline__ Seg load_agg(const int* agg_f, const int* agg_v, int64_t u) {
  Seg s;
  s.f = agg_f[u];
#pragma unroll
  for (int c = 0; c < 9; ++c) s.v[c] = agg_v[u * 9 + c];
  return s;
}

// one block: carry[u] = sums since the last group start before block u
__global__ void fin_carry(const int* agg_f, const int* agg_v, int64_t T, int* carry) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  const int64_t chunk = (T + blockDim.x - 1) / blockDim.x;
  int64_t u0 = (int64_t)threadIdx.x * chunk;
  int64_t u1 = u0 + chunk < T ? u0 + chunk : T;
  if (u0 > T) u0 = T;
  Seg x = seg_zero();
  for (int64_t u = u0; u < u1; ++u) x = combine(x, load_agg(agg_f, agg_v, u));
  Seg run = block_exclusive(x, seg_zero(), swarp, &stotal);
  for (int64_t u = u0; u < u1; ++u) {
#pragma unroll
    for (int c = 0; c < 9; ++c) carry[u * 9 + c] = run.v[c];
    run = combine(run, load_agg(agg_f, agg_v, u));
  }
}

template <int WEFF>
__global__ void fin_apply(CLanes in, int64_t N, uint32_t keymask, int dmin_thres, int purge,
                          const int* carry, Lanes out, int32_t* flags) {
  __shared__ Seg swarp[32];
  __shared__ Seg stotal;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kItems;
  Seg e[kItems];
  Seg x = seg_zero();
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    e[q] = base + q < N ? row_seg<WEFF>(in, base + q, keymask) : seg_zero();
    x = combine(x, e[q]);
  }
  Seg cin;
  cin.f = 0;
#pragma unroll
  for (int c = 0; c < 9; ++c) cin.v[c] = carry[(int64_t)blockIdx.x * 9 + c];
  Seg run = block_exclusive(x, cin, swarp, &stotal);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int64_t r = base + q;
    if (r >= N) break;
    run = combine(run, e[q]);
    int s[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) s[c] = run.v[c] < kMaxCount ? run.v[c] : kMaxCount;
    uint32_t key[WEFF];
    load_key<WEFF>(in, r, keymask, key);
    const bool sent = is_sentinel<WEFF>(key, keymask);
    const bool last = (r == N - 1) || !key_eq<WEFF>(key, in, r + 1, keymask);
#pragma unroll
    for (int l = 0; l < WEFF - 1; ++l) out.p[l][r] = key[l];
    out.p[WEFF - 1][r] = sent ? 0xFFFFFFFFu : key[WEFF - 1];
    bool keep;
    if (purge) {
      const uint32_t lcall = ext_call(s + 1, s[0], dmin_thres);
      const uint32_t rcall = ext_call(s + 5, s[0], dmin_thres);
      keep = last && !sent && s[0] >= 2 && !(lcall == kExtX && rcall == kExtX);
      out.p[WEFF][r] = (uint32_t)s[0] | (lcall << 16) | (rcall << 24);
    } else {
      keep = last && !sent;
      out.p[WEFF][r] = (uint32_t)s[0];
      out.p[WEFF + 1][r] = (uint32_t)s[1] | ((uint32_t)s[2] << 16);
      out.p[WEFF + 2][r] = (uint32_t)s[3] | ((uint32_t)s[4] << 16);
      out.p[WEFF + 3][r] = (uint32_t)s[5] | ((uint32_t)s[6] << 16);
      out.p[WEFF + 4][r] = (uint32_t)s[7] | ((uint32_t)s[8] << 16);
    }
    flags[r] = keep ? 0 : 1;
  }
}

template <int WEFF>
void launch(int64_t T, cudaStream_t s, const CLanes& in, int64_t N, uint32_t keymask,
            int dmin_thres, int purge, const Lanes& o, int32_t* flags, int* agg_f, int* agg_v,
            int* carry) {
  fin_aggregate<WEFF><<<(unsigned)T, kThreads, 0, s>>>(in, N, keymask, agg_f, agg_v);
  fin_carry<<<1, kCarryThreads, 0, s>>>(agg_f, agg_v, T, carry);
  fin_apply<WEFF><<<(unsigned)T, kThreads, 0, s>>>(in, N, keymask, dmin_thres, purge, carry, o,
                                                   flags);
}

}  // namespace

// lanes: weff sorted packed lanes of N rows; outs: weff + 1 (purge) or
// weff + 5 lanes of N rows; flags (N,) i32; scratch: agg_f (T,), agg_v and
// carry (T * 9,) i32 with T = ceil(N / 1024).
extern "C" int mhm2_finalize(const void* const* lanes, int weff, int64_t N, uint32_t keymask,
                             int dmin_thres, int purge, void* const* outs, void* flags,
                             void* agg_f, void* agg_v, void* carry, void* stream) {
  const int n_out = purge ? weff + 1 : weff + 5;
  MHM2_REQUIRE(weff >= 1 && weff <= 7 && n_out <= MHM2_MAX_LANES && N >= 0 && N < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  CLanes in = make_clanes(lanes, weff);
  Lanes o = make_lanes(outs, n_out);
  const int64_t T = (N + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* fl = (int32_t*)flags;
  int* af = (int*)agg_f;
  int* av = (int*)agg_v;
  int* cy = (int*)carry;
  switch (weff) {
    case 1: launch<1>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 2: launch<2>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 3: launch<3>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 4: launch<4>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 5: launch<5>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 6: launch<6>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    case 7: launch<7>(T, s, in, N, keymask, dmin_thres, purge, o, fl, af, av, cy); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
