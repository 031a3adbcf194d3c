// extract: fused k-mer record extraction.
//
// Replaces mhm2_proxy_tpu/ops/pallas_extract.py:179 `_extract` (kernel body
// `_make_kernel`, :58; entry points extract_packed_lanes :170 and
// extract_record_lanes :158). For each (read, position): the canonical
// k-mer as W big-endian u32 words, the left/right extension bases from Q20
// ACGT bases (swapped and complemented when the reverse complement is the
// canonical form), and validity (positions 1..len-k-1). Invalid rows get the
// all-ones key sentinel. Two output layouts:
//   packed: ceil(2k/32) lanes, payload (1 | left<<1 | right<<4) in the free
//           low bits of the last non-zero key lane;
//   record: W key lanes + one (1 | left<<16 | right<<24) lane (0 if invalid).
//
// What bounds it on an H100: memory. Each position reads ~2 bytes of codes
// and quality (the k-base window is re-read by neighbouring threads but is
// served by L1) and writes 4 bytes per output lane: 8-12 bytes written per
// position against 2 read, so the kernel is write-bandwidth bound.
// Design: one thread per (read, position), neighbouring threads on
// neighbouring positions of one read, so every lane store is coalesced.
// The forward and reverse-complement words are packed directly from the
// window in registers (the TPU kernel's shifted-OR packer and funnel-shift
// revcomp exist to stay in VMEM vectors; here each thread simply reads its
// k bytes), with the word count W a template parameter so the words stay
// in registers. No shared memory, no length limit: the contig windows
// (L = 2048) use the same kernel as the reads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kExtNone = 5;

__device__ __forceinline__ uint32_t pack_code(uint32_t c) { return c >= 4 ? 2u : c; }

__device__ __forceinline__ uint32_t ext_code(const uint8_t* c, const uint8_t* q, int j) {
  uint32_t a = c[j];
  return (q[j] != 0 && a < 4) ? a : kExtNone;
}

__device__ __forceinline__ uint32_t comp_ext(uint32_t e) { return e < 4 ? 3u - e : e; }

template <int W>
__global__ void extract_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qual,
                               const int32_t* __restrict__ lens, int64_t B, int L, int P, int k,
                               int packed, Lanes out) {
  int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * P) return;
  int64_t b = gid / P;
  int i = (int)(gid - b * P);
  const uint8_t* c = codes + b * L;
  const uint8_t* q = qual + b * L;
  int len = lens[b];
  int weff = (2 * k + 31) / 32;
  bool valid = (i >= 1) && (i <= len - k - 1);
  if (!valid) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (packed ? (w < weff) : true) out.p[w][gid] = 0xFFFFFFFFu;
    }
    if (!packed) out.p[W][gid] = 0u;
    return;
  }
  uint32_t fwd[W], rc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t f = 0, r = 0;
#pragma unroll
    for (int fld = 0; fld < 16; ++fld) {
      int j = 16 * w + fld;
      uint32_t cf = 0, cr = 0;
      if (j < k) {
        cf = pack_code(c[i + j]);
        cr = 3u - pack_code(c[i + k - 1 - j]);
      }
      f = (f << 2) | cf;
      r = (r << 2) | cr;
    }
    fwd[w] = f;
    rc[w] = r;
  }
  // canonical = lexicographic min; strict rc < fwd marks a reverse complement
  bool was_rc = false;
  bool decided = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (!decided && rc[w] != fwd[w]) {
      was_rc = rc[w] < fwd[w];
      decided = true;
    }
  }
  uint32_t left = ext_code(c, q, i - 1);
  uint32_t right = ext_code(c, q, i + k);
  uint32_t lc = was_rc ? comp_ext(right) : left;
  uint32_t rcx = was_rc ? comp_ext(left) : right;
  if (packed) {
    uint32_t pay7 = 1u | (lc << 1) | (rcx << 4);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t cw = was_rc ? rc[w] : fwd[w];
      if (w < weff - 1) out.p[w][gid] = cw;
      else if (w == weff - 1) out.p[w][gid] = cw | pay7;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out.p[w][gid] = was_rc ? rc[w] : fwd[w];
    out.p[W][gid] = 1u | (lc << 16) | (rcx << 24);
  }
}

}  // namespace

// codes (B, L) u8, qual (B, L) u8 (0/1), lens (B,) i32; outs: n_out lanes of
// B*(L-k+1) u32 each (packed: ceil(2k/32) lanes; record: W + 1 lanes).
extern "C" int mhm2_extract(const void* codes, const void* qual, const void* lens, int64_t B,
                            int L, int k, int packed, void* const* outs, int n_out,
                            void* stream) {
  int W = 2 * ((k + 31) / 32);
  int weff = (2 * k + 31) / 32;
  MHM2_REQUIRE(k >= 1 && L >= k && W <= 8);
  MHM2_REQUIRE(n_out == (packed ? weff : W + 1));
  int P = L - k + 1;
  int64_t n = B * (int64_t)P;
  if (n == 0) return (int)cudaGetLastError();
  Lanes o = make_lanes(outs, n_out);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  MHM2_REQUIRE(blocks < (1ll << 31));
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  const uint8_t* q = (const uint8_t*)qual;
  const int32_t* ln = (const int32_t*)lens;
  switch (W) {
    case 2: extract_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(c, q, ln, B, L, P, k, packed, o); break;
    case 4: extract_kernel<4><<<(unsigned)blocks, kThreads, 0, s>>>(c, q, ln, B, L, P, k, packed, o); break;
    case 6: extract_kernel<6><<<(unsigned)blocks, kThreads, 0, s>>>(c, q, ln, B, L, P, k, packed, o); break;
    case 8: extract_kernel<8><<<(unsigned)blocks, kThreads, 0, s>>>(c, q, ln, B, L, P, k, packed, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
