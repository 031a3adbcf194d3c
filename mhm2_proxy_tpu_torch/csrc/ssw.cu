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
// What bounds it on an H100: integer operations. The function needs about
// 7.5 a DP cell when sm_90's DPX forms (add-max, add-max floored at 0, 3-way
// max) and a byte permute count as one each (the design below); its bytes
// (the codes once, three ints a pair) are negligible. So the DP state must
// stay out of memory and every cell must cost few instructions.
// Design: one pair per thread (a warp runs 32 pairs with no shuffles), the
// DP walked in strips of R ref columns. Inside a strip the thread goes row
// by row, and each row's R cells run unrolled with everything in registers:
// per column the H of the row above and the F carry, per strip the columns'
// substitution selectors. A cell costs about 8 instructions:
//   s    one prmt: the row's four substitution bytes (built once a row from
//        the query code) and a fifth for ambiguity, picked by the column's
//        selector and sign-extended (scores that fit a signed byte; other
//        scorings take a compare-and-select form, 4 instructions);
//   E    ep - ge, then __viaddmax_s32;
//   Hn   __viaddmax_s32_relu (diag + s, E, 0);
//   H, F the F carry is kept as g_i = f_i + i * ge, so H = max(g + (-i ge),
//        Hn) and g' = max(Hn + ((i+1) ge - go), g) are one __viaddmax_s32
//        each, with the two row constants updated once a row;
//   best key = H * R + (R - 1 - t) (one IMAD), folded into the row's
//        maximum with __vimax3_s32.
// Only the strip's right edge crosses to the next strip: each row's H and E
// of the strip's last column, 8 bytes a row, written and read back by the
// same thread in an (Lq, B) int2 buffer (coalesced: a warp's 32 pairs touch
// 256 contiguous bytes), so no synchronisation is needed and a pair moves
// 16 x Lq bytes a strip instead of 16 bytes a cell. A single strip (Lr <= R)
// needs no buffer. Inputs are read as they are, (B, L) row-major: the ref
// once, R codes a strip, and the query once a strip, four codes a load where
// the rows are 4-byte aligned. Strips run along the ref because the
// post-asm shapes have Lr > Lq (windows are reads plus margins), which makes
// the edge the shorter side; the edge traffic itself, Lq x Lr / R, is the
// same along either axis.
// Ties: strips change the visit order (row-major inside a strip), so the
// best is kept by an explicit order, not by visit order: a row's key
// H * R + (R - 1 - t) is larger for a larger score, then a smaller column;
// rows replace the strip's best only on a strictly larger key (the smaller
// row wins a tie); strips run left to right and replace the pair's best only
// on a strictly larger score (the smaller column wins). That is the
// reference's (score descending, ref position ascending, query position
// ascending). Columns past the pair's r_len in its last strip get a key
// addend of INT_MIN, so they never win; best <= 0 reports (0, -1, -1).
// Keys need H * R < 2^31: mhm2_ssw refuses scorings whose best possible
// score, match x min(Lq, Lr), reaches 2^31 / R (2^26 at R = 32).
// Early stop: a pair walks only its own q_len rows and r_len columns (its
// last strip padded to R). The reference masks every cell beyond them to
// H = 0, which never updates a best that starts at 0, and no valid cell
// reads a masked one, so the results are the same. No shape limit: the
// reference sends Lq > 1024 or Lr > 4096 to XLA, this kernel takes every
// shape.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kNeg = -1000000;
// R, the strip width: 32 columns take 166 registers (no spill) and ran
// faster on the post-asm shape (65,536 pairs, Lq 100, Lr 164; H100) than 16
// columns, or 32 capped at 128 registers
constexpr int kStrip = 32;

bool fits_s8(int v) { return v >= -128 && v <= 127; }

// a byte of {b, a} picked and sign-extended to 32 bits by each selector nibble
__device__ __forceinline__ int prmt_s8(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return (int)d;
}

// codes j0 .. j0 + R - 1 of one row, 4 a load where the row is 4-byte aligned
// and the strip is whole; code 4 past the row's n valid codes
template <int R>
__device__ __forceinline__ void load_strip(const uint8_t* row, int j0, int n, bool aligned4,
                                           int (&c)[R]) {
  if (aligned4 && n >= R) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + j0);
#pragma unroll
    for (int w = 0; w < R / 4; ++w) {
      const uint32_t v = __ldg(p + w);
#pragma unroll
      for (int u = 0; u < 4; ++u) c[4 * w + u] = (v >> (8 * u)) & 0xFF;
    }
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) c[t] = t < n ? row[j0 + t] : 4;
  }
}

template <int R, bool kByteScores>
__global__ void __launch_bounds__(kThreads)
    ssw_kernel(const uint8_t* __restrict__ query, const int32_t* __restrict__ q_len,
               const uint8_t* __restrict__ ref, const int32_t* __restrict__ r_len, int64_t B,
               int Lq, int Lr, int match, int mismatch, int go, int ge, int amb, bool q4, bool r4,
               int2* __restrict__ edge, int32_t* __restrict__ out) {
  static_assert(R % 4 == 0 && (R & (R - 1)) == 0, "R: a power of 2, at least 4");
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int ql = min(max(q_len[b], 0), Lq);
  const int rl = min(max(r_len[b], 0), Lr);
  const uint8_t* qrow = query + b * Lq;
  const uint32_t* qrow4 = reinterpret_cast<const uint32_t*>(qrow);
  const uint8_t* rrow = ref + b * Lr;
  int2* ed = edge + b;  // row i of the strip edge at ed[i * B]
  // the row's substitution bytes: -mismatch in every byte, match at the
  // query's own code; -ambiguity in every byte for an ambiguous query code
  const uint32_t xw = 0x01010101u * (uint32_t)(uint8_t)(-mismatch);
  const uint32_t aw = 0x01010101u * (uint32_t)(uint8_t)(-amb);
  const uint32_t mb = (uint32_t)(uint8_t)match;
  int best = 0, bi = -1, bj = -1;
  for (int j0 = 0; j0 < rl; j0 += R) {
    const int nv = rl - j0;  // the strip's valid columns (all of them if >= R)
    const bool first = j0 == 0, more = nv > R;
    int sel[R], add[R], hup[R], g[R];
    load_strip<R>(rrow, j0, nv, r4, sel);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int c = sel[t];
      if (kByteScores) {
        const int x = c < 4 ? c : 4;  // byte 4: the ambiguity score
        sel[t] = (x * 0x1111) | 0x8880;
      } else {
        sel[t] = c < 4 ? c : -1;
      }
      add[t] = t < nv ? R - 1 - t : INT_MIN;
      hup[t] = 0;
      g[t] = kNeg;
    }
    int hl_prev = 0;           // H[i-1, j0-1]
    int c1 = ge - go, dn = 0;  // (i+1) ge - go and -i ge
    int sk = -1, si = -1;      // the strip's best key and its row
    int2 en = make_int2(0, kNeg);
    if (!first && ql > 0) en = ed[0];
    uint32_t qw = 0, qn = (q4 && ql > 0) ? __ldg(qrow4) : 0u;
    for (int i = 0; i < ql; ++i) {
      const int2 ev = en;
      if (!first && i + 1 < ql) en = ed[(int64_t)(i + 1) * B];
      int qc;
      if (q4) {
        if ((i & 3) == 0) {
          qw = qn;
          if (i + 4 < ql) qn = __ldg(qrow4 + (i >> 2) + 1);
        }
        qc = (qw >> (8 * (i & 3))) & 0xFF;
      } else {
        qc = qrow[i];
      }
      int diag = hl_prev;
      int hleft = ev.x, eleft = ev.y;
      hl_prev = hleft;
      uint32_t pq = aw;
      int qq = -2, sm = -amb, sx = -amb;
      if (kByteScores) {
        if (qc < 4) pq = (xw & ~(0xFFu << (8 * qc))) | (mb << (8 * qc));
      } else if (qc < 4) {
        qq = qc;
        sm = match;
        sx = -mismatch;
      }
      int rk = INT_MIN, k0 = INT_MIN;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int s = kByteScores ? prmt_s8(pq, aw, (uint32_t)sel[t])
                                  : (sel[t] < 0 ? -amb : (sel[t] == qq ? sm : sx));
        const int e = __viaddmax_s32(hleft, -go, eleft - ge);
        const int hn = __viaddmax_s32_relu(diag, s, e);
        const int h = __viaddmax_s32(g[t], dn, hn);
        g[t] = __viaddmax_s32(hn, c1, g[t]);
        diag = hup[t];
        hup[t] = h;
        hleft = h;
        eleft = e;
        const int key = h * R + add[t];
        if (t & 1) {
          rk = __vimax3_s32(rk, k0, key);
        } else {
          k0 = key;
        }
      }
      if (more) ed[(int64_t)i * B] = make_int2(hleft, eleft);
      if (rk > sk) {
        sk = rk;
        si = i;
      }
      c1 += ge;
      dn -= ge;
    }
    if (sk >= 0 && sk / R > best) {
      best = sk / R;
      bi = si;
      bj = j0 + R - 1 - (sk % R);
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

// query: (B, Lq) u8 codes; q_len: B i32; ref: (B, Lr) u8 codes; r_len: B
// i32; edge: (Lq, B) int2 scratch (any contents; unused, and may be null,
// when Lr <= kStrip); out: (3, B) i32 rows score, q_end, r_end. Returns
// cudaErrorInvalidValue for a scoring whose best score could overflow the
// best-cell key. The substitution is one byte permute when match, -mismatch
// and -ambiguity fit a signed byte, else a compare-and-select.
extern "C" int mhm2_ssw(const void* query, const void* q_len, const void* ref, const void* r_len,
                        int64_t B, int Lq, int Lr, int match, int mismatch, int gap_open,
                        int gap_extend, int ambiguity, void* edge, void* out, void* stream) {
  MHM2_REQUIRE(B >= 0 && Lq >= 0 && Lr >= 0);
  MHM2_REQUIRE(Lr <= kStrip || Lq == 0 || edge != nullptr);
  MHM2_REQUIRE((int64_t)(match > 0 ? match : 0) * (Lq < Lr ? Lq : Lr) < INT_MAX / kStrip);
  if (B == 0) return (int)cudaGetLastError();
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  MHM2_REQUIRE(blocks < (1ll << 31));
  const uint8_t* q = (const uint8_t*)query;
  const uint8_t* r = (const uint8_t*)ref;
  const bool q4 = Lq % 4 == 0 && (uintptr_t)q % 4 == 0;
  const bool r4 = Lr % 4 == 0 && (uintptr_t)r % 4 == 0;
  const bool byte_scores = fits_s8(match) && fits_s8(-mismatch) && fits_s8(-ambiguity);
  const auto kernel = byte_scores ? ssw_kernel<kStrip, true> : ssw_kernel<kStrip, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q, (const int32_t*)q_len, r, (const int32_t*)r_len, B, Lq, Lr, match, mismatch, gap_open,
      gap_extend, ambiguity, q4, r4, (int2*)edge, (int32_t*)out);
  return (int)cudaGetLastError();
}
