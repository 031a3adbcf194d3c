// ssw: batched Smith-Waterman forward scoring with affine gaps: each pair's
// best local-alignment score and the cell where it ends.
//
// Replaces mhm2_proxy_tpu/ops/pallas_ssw.py:108 `pallas_sw_align_ends`
// (kernel body `_sw_kernel` :37), which computes the same function as the
// reference's XLA column loop (mhm2_proxy_tpu/ops/ssw.py:84-132):
//   E[i,j] = max(H[i,j-1] - go, E[i,j-1] - ge)
//   Hn[i,j] = max(H[i-1,j-1] + s(q_i, r_j), E[i,j], 0)
//   f_0 = NEG, f_i = max(Hn[i-1,j] - go, f_{i-1} - ge)     (the lazy F)
//   H[i,j] = max(Hn[i,j], f_i)
// where s is match / -mismatch, and -ambiguity when either code is >= 4.
// The lazy F is the reference's max-decay scan down the column written as
// its sequential recurrence; it is that scan for every (go, ge), including
// go < ge, where it differs from the textbook F over H.
//
// Ties: the best is kept with a strict `>` while the cells are visited in
// column-major order (j outer, i inner, both ascending), so the first
// column that reaches the maximum wins, then the smallest row in it: the
// reference's order (score descending, ref position ascending, query
// position ascending). best <= 0 reports (0, -1, -1).
//
// Early stop: a pair walks only its own r_len columns and q_len rows. The
// reference masks every cell beyond them to H = 0, and a 0 never updates a
// best that starts at 0 under `>`; no valid cell reads a masked one (the
// diagonal, E and F of row i come from rows <= i of valid columns). So the
// results are the same, and a pair costs its own q_len x r_len cells.
//
// What bounds it on an H100: the DP state. Each cell reads and writes its
// H and E (16 bytes of the (Lq, B) int32 scratch) and issues about 22
// integer instructions (the substitution's compares and selects, the
// max-plus of E, H and F, the best-cell compare and selects, index and loop
// arithmetic). The scratch of a 65,536-pair block at 100-bp reads is
// ~52 MB, about the size of the 50 MB L2, so the H/E traffic is served
// partly by HBM. The function itself needs 12 operations a cell when
// sm_90's DPX add-max forms (__viaddmax_s32, __viaddmax_s32_relu,
// __vibmax_s32) count as one each: that, over 132 SMs x 64 int32 lanes, is
// its floor, and this kernel stays well above it.
// Design: the TPU kernel puts 128 pairs on the lanes and query rows on the
// sublanes, and resolves the in-column F with log2(Lq) shifted max steps
// because a vector unit cannot walk a column. A Hopper thread can: one pair
// per thread walks its columns and rows in order, keeping the diagonal and
// F in registers, with H and E in (Lq, B) scratch so the 32 pairs of a warp
// load and store one row's 128 contiguous bytes; the query and ref arrive
// transposed to (L, B) for the same reason. No batch padding to 128 is
// needed, and no shape limit: the reference sends Lq > 1024 or Lr > 4096 to
// XLA, this kernel takes every shape. Faster designs (a warp per pair with
// shuffles for F, the query in shared memory, H and E in 16 bits) are
// later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNeg = -1000000;

__global__ void __launch_bounds__(kThreads)
    ssw_kernel(const uint8_t* __restrict__ qT, const int32_t* __restrict__ q_len,
               const uint8_t* __restrict__ rT, const int32_t* __restrict__ r_len, int64_t B,
               int Lq, int Lr, int match, int mismatch, int go, int ge, int amb,
               int32_t* __restrict__ H, int32_t* __restrict__ E, int32_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int ql = min(max(q_len[b], 0), Lq);
  const int rl = min(max(r_len[b], 0), Lr);
  for (int64_t i = 0, o = b; i < ql; ++i, o += B) {
    H[o] = 0;
    E[o] = kNeg;
  }
  int best = 0, bi = -1, bj = -1;
  for (int j = 0; j < rl; ++j) {
    const int r = rT[(int64_t)j * B + b];
    const bool r_amb = r >= 4;
    int diag = 0;  // H[i-1, j-1]; 0 above row 0
    int f = kNeg;  // f_i
    int64_t o = b;
    for (int i = 0; i < ql; ++i, o += B) {
      const int q = qT[o];
      const int hp = H[o];
      const int ep = E[o];
      const int s = (q >= 4 || r_amb) ? -amb : (q == r ? match : -mismatch);
      const int e = max(hp - go, ep - ge);
      const int hnof = max(max(diag + s, e), 0);
      const int h = max(hnof, f);
      H[o] = h;
      E[o] = e;
      if (h > best) {
        best = h;
        bi = i;
        bj = j;
      }
      f = max(hnof - go, f - ge);
      diag = hp;
    }
  }
  if (best <= 0) {
    best = 0;
    bi = -1;
    bj = -1;
  }
  out[b] = best;
  out[B + b] = bi;
  out[2 * B + b] = bj;
}

}  // namespace

// qT: (Lq, B) u8 query codes; q_len: B i32; rT: (Lr, B) u8 ref codes;
// r_len: B i32; H, E: (Lq, B) i32 scratch (any contents); out: (3, B) i32
// rows score, q_end, r_end.
extern "C" int mhm2_ssw(const void* qT, const void* q_len, const void* rT, const void* r_len,
                        int64_t B, int Lq, int Lr, int match, int mismatch, int gap_open,
                        int gap_extend, int ambiguity, void* H, void* E, void* out,
                        void* stream) {
  MHM2_REQUIRE(B >= 0 && Lq >= 0 && Lr >= 0);
  if (B == 0) return (int)cudaGetLastError();
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  MHM2_REQUIRE(blocks < (1ll << 31));
  ssw_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qT, (const int32_t*)q_len, (const uint8_t*)rT, (const int32_t*)r_len, B,
      Lq, Lr, match, mismatch, gap_open, gap_extend, ambiguity, (int32_t*)H, (int32_t*)E,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
