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
// What bounds it on an H100: memory, by a wide margin over the function's
// own operations. A position reads ~2 bytes (its base and quality byte) and
// writes 4 bytes per output lane, 8-36 bytes a position, so the floor is its
// stores. To get near it, a position must cost few instructions and no
// uncoalesced loads: packing a k-mer base by base (2k byte loads and 16 W
// shift-or steps a strand) made the old kernel 12x its bound.
// Design: a block takes a tile of whole reads (2048 bytes of bases: 16 reads
// at L = 128, one contig window at L = 2048). It loads their codes and
// quality with 16-byte loads into shared memory, one byte a base (the
// packing code, N as G, and the extension code), then packs each read once
// into two 2-bit streams of u32 words, 16 bases a word: the forward bases,
// and their reverse complement (pack2bit.cuh, shared with minimizer.cu).
// A position's W forward words are then W + 1 adjacent stream words joined
// by __funnelshift_l and cut by the end masks; its reverse-complement
// words come the same way from
// the reverse stream at L - i - k. That is O(W) operations and 2 (W + 1)
// shared loads a position, all broadcast within the 16 neighbouring
// positions that share a word. The canonical compare and the extension
// picks (from the tile's bytes) follow, and the lane stores are coalesced:
// neighbouring threads hold neighbouring positions, and a tile's positions
// are one contiguous range of rows. W and the layout are template
// parameters, so the words stay in registers. No length limit below the
// 227 KB of shared memory a block can have (reads of ~150,000 bases).
#include "common.cuh"
#include "pack2bit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kExtNone = 5;
constexpr int kTileBases = 2048;  // bases a block loads: max(1, 2048 / L) reads
constexpr int kMaxSmem = 227 * 1024;

// four bases at once: bits 0-1 of each byte the packing code (>= 4 packs as
// G), bits 2-4 the extension code (the base if it is ACGT and of good
// quality, else 5)
__device__ __forceinline__ uint32_t base_bytes(uint32_t c, uint32_t q) {
  const uint32_t ge4 = __vcmpgeu4(c, 0x04040404u);
  const uint32_t good = __vcmpne4(q, 0u) & ~ge4;
  const uint32_t ext = (c & good) | (0x05050505u & ~good);
  return code_bytes(c) | (ext << 2);
}

__device__ __forceinline__ uint32_t comp_ext(uint32_t e) { return e < 4 ? 3u - e : e; }

struct Tile {
  int LS, NF, NS;  // a read's bytes (16-aligned), its stream words, with W + 1 zero words
  __host__ __device__ Tile(int L, int W) : LS((L + 15) & ~15), NF(LS / 16), NS(LS / 16 + W + 1) {}
  __host__ __device__ int64_t smem(int RB) const {
    return (int64_t)RB * LS + 2ll * RB * NS * 4 + 4ll * RB;
  }
};

template <int W, int kLanes>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ qual,
                   const int32_t* __restrict__ lens, int64_t B, int L, int k, int RB, bool vec,
                   Lanes out) {
  constexpr bool kPacked = kLanes <= W;  // packed: ceil(2k/32) lanes; record: W + 1
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile tl(L, W);
  const int P = L - k + 1;
  uint8_t* sb = smem;                                     // RB x LS base bytes
  uint32_t* fw = reinterpret_cast<uint32_t*>(smem + (int64_t)RB * tl.LS);  // RB x NS
  uint32_t* rv = fw + RB * tl.NS;                         // RB x NS
  int* slen = reinterpret_cast<int*>(rv + RB * tl.NS);    // RB
  const int64_t b0 = (int64_t)blockIdx.x * RB;
  const int nr = (int)min((int64_t)RB, B - b0);

  // 1. the tile's bases, a byte each
  if (vec) {  // L % 16 == 0 and 16-byte aligned inputs: rows are whole uint4s
    const uint4* c4 = reinterpret_cast<const uint4*>(codes + b0 * L);
    const uint4* q4 = reinterpret_cast<const uint4*>(qual + b0 * L);
    uint4* s4 = reinterpret_cast<uint4*>(sb);
    for (int u = threadIdx.x; u < nr * L / 16; u += kThreads) {
      const uint4 c = __ldg(c4 + u), q = __ldg(q4 + u);
      s4[u] = make_uint4(base_bytes(c.x, q.x), base_bytes(c.y, q.y), base_bytes(c.z, q.z),
                         base_bytes(c.w, q.w));
    }
  } else {
    const uint8_t* c = codes + b0 * L;
    const uint8_t* q = qual + b0 * L;
    for (int p = threadIdx.x; p < nr * L; p += kThreads) {
      const int r = p / L;
      sb[r * tl.LS + p - r * L] = (uint8_t)base_bytes(c[p], q[p]);
    }
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) slen[r] = lens[b0 + r];
  __syncthreads();

  // 2. each read's forward and reverse-complement 2-bit streams, ending in
  // W + 1 zero words (pack2bit.cuh)
  build_streams<kThreads>(sb, nr, L, tl.LS, tl.NF, tl.NS, fw, rv);
  __syncthreads();

  // 3. one position a thread, neighbouring threads on neighbouring rows
  uint32_t mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int nb = min(max(k - 16 * w, 0), 16);
    mask[w] = nb ? ~0u << (32 - 2 * nb) : 0u;
  }
  const int jr0 = 16 * tl.NF - k;  // reverse-stream base of position 0's reverse complement
  int r = threadIdx.x / P, i = threadIdx.x - r * P;
  for (int t = threadIdx.x; t < nr * P; t += kThreads) {
    const int64_t gid = b0 * P + t;
    const int len = slen[r];
    if (i >= 1 && i <= len - k - 1) {
      const uint32_t* f = fw + r * tl.NS + (i >> 4);
      const int j = jr0 - i;
      const uint32_t* g = rv + r * tl.NS + (j >> 4);
      const uint32_t sf = 2 * (i & 15), sg = 2 * (j & 15);
      uint32_t fwd[W], rc[W];
      uint32_t fh = f[0], gh = g[0];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (16 * w < k) {
          const uint32_t fl = f[w + 1], gl = g[w + 1];
          fwd[w] = __funnelshift_l(fl, fh, sf) & mask[w];
          rc[w] = __funnelshift_l(gl, gh, sg) & mask[w];
          fh = fl;
          gh = gl;
        } else {
          fwd[w] = 0;
          rc[w] = 0;
        }
      }
      // canonical = lexicographic min; strict rc < fwd marks a reverse complement
      bool was_rc = false, decided = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (!decided && rc[w] != fwd[w]) {
          was_rc = rc[w] < fwd[w];
          decided = true;
        }
      }
      const uint8_t* row = sb + r * tl.LS;
      const uint32_t left = row[i - 1] >> 2;
      const uint32_t right = i + k < L ? row[i + k] >> 2 : kExtNone;
      const uint32_t lc = was_rc ? comp_ext(right) : left;
      const uint32_t rx = was_rc ? comp_ext(left) : right;
      if (kPacked) {
        const uint32_t pay7 = 1u | (lc << 1) | (rx << 4);
#pragma unroll
        for (int w = 0; w < kLanes; ++w) {
          const uint32_t cw = was_rc ? rc[w] : fwd[w];
          out.p[w][gid] = w == kLanes - 1 ? cw | pay7 : cw;
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) out.p[w][gid] = was_rc ? rc[w] : fwd[w];
        out.p[W][gid] = 1u | (lc << 16) | (rx << 24);
      }
    } else {
#pragma unroll
      for (int w = 0; w < kLanes; ++w) out.p[w][gid] = kPacked || w < W ? 0xFFFFFFFFu : 0u;
    }
    i += kThreads;
    while (i >= P) {
      i -= P;
      ++r;
    }
  }
}

template <int W, int kLanes>
int launch(const uint8_t* c, const uint8_t* q, const int32_t* ln, int64_t B, int L, int k,
           Lanes o, cudaStream_t s) {
  const int RB = max(1, kTileBases / L);
  const int64_t smem = Tile(L, W).smem(RB);
  MHM2_REQUIRE(smem <= kMaxSmem);
  const int64_t blocks = (B + RB - 1) / RB;
  MHM2_REQUIRE(blocks < (1ll << 31));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        extract_kernel<W, kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = L % 16 == 0 && (uintptr_t)c % 16 == 0 && (uintptr_t)q % 16 == 0;
  extract_kernel<W, kLanes><<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(c, q, ln, B, L, k,
                                                                            RB, vec, o);
  return (int)cudaGetLastError();
}

}  // namespace

// codes (B, L) u8, qual (B, L) u8 (0/1), lens (B,) i32; outs: n_out lanes of
// B*(L-k+1) u32 each (packed: ceil(2k/32) lanes; record: W + 1 lanes).
extern "C" int mhm2_extract(const void* codes, const void* qual, const void* lens, int64_t B,
                            int L, int k, int packed, void* const* outs, int n_out,
                            void* stream) {
  const int W = 2 * ((k + 31) / 32);
  const int weff = (2 * k + 31) / 32;
  MHM2_REQUIRE(k >= 1 && L >= k && W <= 8);
  MHM2_REQUIRE(n_out == (packed ? weff : W + 1));
  if (B * (int64_t)(L - k + 1) == 0) return (int)cudaGetLastError();
  const Lanes o = make_lanes(outs, n_out);
  const uint8_t* c = (const uint8_t*)codes;
  const uint8_t* q = (const uint8_t*)qual;
  const int32_t* ln = (const int32_t*)lens;
  cudaStream_t s = (cudaStream_t)stream;
  // the lane count (packed: ceil(2k/32) <= W; record: W + 1) is a template
  // parameter, so every store's lane is fixed
  switch (n_out) {
    case 1: return launch<2, 1>(c, q, ln, B, L, k, o, s);
    case 2: return launch<2, 2>(c, q, ln, B, L, k, o, s);
    case 3: return W == 2 ? launch<2, 3>(c, q, ln, B, L, k, o, s) : launch<4, 3>(c, q, ln, B, L, k, o, s);
    case 4: return launch<4, 4>(c, q, ln, B, L, k, o, s);
    case 5: return W == 4 ? launch<4, 5>(c, q, ln, B, L, k, o, s) : launch<6, 5>(c, q, ln, B, L, k, o, s);
    case 6: return launch<6, 6>(c, q, ln, B, L, k, o, s);
    case 7: return W == 6 ? launch<6, 7>(c, q, ln, B, L, k, o, s) : launch<8, 7>(c, q, ln, B, L, k, o, s);
    case 8: return launch<8, 8>(c, q, ln, B, L, k, o, s);
    case 9: return launch<8, 9>(c, q, ln, B, L, k, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
