// finalize: segmented group sums + extension calls + purge over a merged,
// sorted raw run.
//
// Replaces mhm2_proxy_tpu/ops/pallas_finalize.py:246 `scan_purge_compact`
// (kernel body `_kernel`, :123). Input: weff u32 lanes lexsorted, either in
// the packed layout (the 7-bit read payload valid | left<<1 | right<<4 in
// the last lane's free low bits, all-ones sentinel rows at the tail) or, for
// k whose payload does not fit the key bits (k = 63, 77), weff key lanes
// plus one count | left<<16 | right<<24 lane, 0 on sentinel rows (the
// reference's `pay` variant, :164-176). For every row: the group's
// inclusive sums of (count, 4 left one-hots, 4 right one-hots) up to that
// row, clamped at 65535 (equal to the reference's saturating sums,
// ops/count.py:203-216); at group-last rows the extension calls
// (kcount_cpu.cpp:173-182, ties T>G>C>A, integer dmin_dyn) and the keep
// rule. Output: the key lanes (payload bits cleared in the packed layout),
// one packed (count | lcall<<16 | rcall<<24) lane (purge) or the five packed
// group-sum lanes of ops/count.py::_pack_sums (no purge), and a class flag
// per row (0 keep, 1 drop) for the compact kernel.
//
// What bounds it on an H100: memory (~(2 n_in + n_out + 1) * 4 bytes per
// row); the 9-value scan is a few dozen integer ops per row.
// Design: the TPU kernel carries the group sums and the previous key from
// one grid step to the next in SMEM over a grid that runs in order, and
// peeks at the next tile's first key. Hopper blocks run in no order, so the
// scan is the three launches of segscan.cuh (block aggregates, one carry
// block, apply); the apply block evaluates calls and purge elementwise.
// Group starts and ends compare each row with its neighbours in device
// memory directly: a tile edge is no special case.
#include "segscan.cuh"

namespace {

constexpr int kMaxCount = 0xFFFF;
constexpr int kExtF = 4;
constexpr int kExtX = 5;

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
__global__ void fin_apply(KeyRows<WEFF> rows, int64_t N, int dmin_thres, int purge,
                          const int* carry, Lanes out, int32_t* flags) {
  const int64_t base = (int64_t)blockIdx.x * kSegTile + threadIdx.x * kSegItems;
  Seg inc[kSegItems];
  seg_block_rows(rows, N, carry, base, inc);
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    const int64_t r = base + q;
    if (r >= N) break;
    int s[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) s[c] = inc[q].v[c] < kMaxCount ? inc[q].v[c] : kMaxCount;
    uint32_t key[WEFF];
    rows.key(r, key);
    uint32_t cnt, left, right;
    rows.payload(r, key, cnt, left, right);
    const bool sent = cnt == 0;
    const bool last = (r == N - 1) || !rows.same(key, r + 1);
#pragma unroll
    for (int l = 0; l < WEFF - 1; ++l) out.p[l][r] = key[l];
    out.p[WEFF - 1][r] = (sent && !rows.sep) ? 0xFFFFFFFFu : key[WEFF - 1];
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
void launch(int64_t T, cudaStream_t s, const CLanes& in, int64_t N, uint32_t keymask, int sep,
            int dmin_thres, int purge, const Lanes& o, int32_t* flags, int* agg_f, int* agg_v,
            int* carry) {
  KeyRows<WEFF> rows{in, keymask, sep};
  seg_aggregate<KeyRows<WEFF>><<<(unsigned)T, kSegThreads, 0, s>>>(rows, N, agg_f, agg_v);
  seg_carry<<<1, kSegCarryThreads, 0, s>>>(agg_f, agg_v, T, carry);
  fin_apply<WEFF><<<(unsigned)T, kSegThreads, 0, s>>>(rows, N, dmin_thres, purge, carry, o, flags);
}

}  // namespace

// lanes: weff sorted lanes of N rows (packed layout, sep = 0) or weff key
// lanes + the payload lane (sep = 1, keymask ignored); outs: weff + 1
// (purge) or weff + 5 lanes of N rows; flags (N,) i32; scratch: agg_f (T,),
// agg_v and carry (T * 9,) i32 with T = ceil(N / 1024).
extern "C" int mhm2_finalize(const void* const* lanes, int weff, int sep, int64_t N,
                             uint32_t keymask, int dmin_thres, int purge, void* const* outs,
                             void* flags, void* agg_f, void* agg_v, void* carry, void* stream) {
  const int n_out = purge ? weff + 1 : weff + 5;
  MHM2_REQUIRE(weff >= 1 && weff <= 7 && (sep == 0 || sep == 1));
  MHM2_REQUIRE(n_out <= MHM2_MAX_LANES && N >= 0 && N < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  CLanes in = make_clanes(lanes, weff + sep);
  Lanes o = make_lanes(outs, n_out);
  const int64_t T = (N + kSegTile - 1) / kSegTile;
  const uint32_t km = sep ? 0xFFFFFFFFu : keymask;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* fl = (int32_t*)flags;
  int* af = (int*)agg_f;
  int* av = (int*)agg_v;
  int* cy = (int*)carry;
  switch (weff) {
    case 1: launch<1>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 2: launch<2>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 3: launch<3>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 4: launch<4>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 5: launch<5>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 6: launch<6>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    case 7: launch<7>(T, s, in, N, km, sep, dmin_thres, purge, o, fl, af, av, cy); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
