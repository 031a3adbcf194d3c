// minimizer: the target shard of every k-mer position of a block.
//
// Replaces mhm2_proxy_tpu/ops/pallas_minimizer.py:179
// `pallas_minimizer_targets` (kernel body `_make_kernel`, :116). For each
// (read, position p < P = L-k+1): the minimizer of the k-mer at p, which is
// the greatest least-complement m-mer among its w = k-m+1 candidates (the
// m-mer at i packs bases i..i+m-1 into the top 2m bits of a u64, N as G;
// least = min(m-mer, its reverse complement); reference kmer.cpp:344-403),
// then the reference's quick_hash (hash_funcs.c:332-342), then the hash %
// n_shards (kmer_dht.cpp:193-196), as int32.
//
// What bounds it on an H100: operations. It reads B*L code bytes and writes
// 4*B*P bytes, but a position needs its candidate's two strands, a window
// maximum, a 64-bit hash and a remainder, ~70 int32 operations (u64
// operations count two), against ~5 bytes moved.
// Design, so that a position's cost does not depend on k:
// - A block takes a tile of whole reads, as extract.cu does (2048 bases:
//   16 reads at L = 128, one contig window at L = 2048; a longer read takes
//   a block of its own, up to what shared memory holds). Its threads cover
//   the tile's flattened (read, candidate) and then (read, position)
//   ranges, so no thread idles at large k, and a tile's outputs are one
//   contiguous range of rows: the stores are coalesced.
// - Each read is packed once into forward and reverse-complement 2-bit
//   streams in shared memory (pack2bit.cuh, shared with extract.cu). The
//   candidate at base i is a funnel shift of three forward words at i,
//   masked to 2m bits (m <= 28); its reverse complement comes the same way
//   from the reverse stream at 16 NF - i - m, with no bit reversal. No
//   candidate of a valid position reads past base L - 1.
// - The window maximum is van Herk/Gil-Werman's: the candidates of a read
//   are cut into segments of w, and a position's maximum is
//   max(suffix max at p, prefix max at p + w - 1), each within its
//   segment. The prefix and suffix maxima are two segmented max-scans over
//   the tile's candidates (8 consecutive candidates a thread in
//   registers, then warp shuffles and the warps' totals), the segment flag
//   in bit 0 of the least value (its low 8 bits are always 0); the two run
//   side by side, with one barrier between their warp halves and their
//   finishes. Both go to shared memory, one pad slot every 8 so that a
//   warp's stores fall on distinct bank pairs. The scans cost the same per
//   candidate at any w.
// - quick_hash is native u64 arithmetic. The remainder folds the hash's
//   u32 halves as the TPU kernel does, ((hi % S)(2^32 % S) + lo % S) % S,
//   exact while S^2 < 2^32, and takes each u32 remainder by Lemire's
//   direct computation with a 64-bit reciprocal the host computes once a
//   call: no 64-bit division or remainder runs on the card.
#include "common.cuh"
#include "pack2bit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // consecutive candidates a thread scans
constexpr int kChunk = kThreads * kItems;  // candidates a block scans at once
constexpr int kWarps = kThreads / 32;
constexpr int kTileBases = 2048;           // bases a block loads: max(1, 2048 / L) reads
constexpr int kMaxSmem = 227 * 1024;
// three blocks an SM (at most 85 registers a thread, none spilled): the
// kernel is a chain of short dependent steps between barriers, and the
// other blocks' warps are what hides them
constexpr int kBlocksPerSM = 3;

typedef unsigned long long u64;

// a candidate's slot in the shared maxima: one pad slot every 8, so that
// the 8-candidate runs of a warp's 32 threads fall on distinct bank pairs
__device__ __forceinline__ int slot(int q) { return q + (q >> 3); }

// the shared layout of a block of RB reads of L bases
struct Tile {
  int LS, NF, NS, C;  // a read's bytes (16-aligned), data words, stream words, candidates
  __host__ __device__ Tile(int L, int m)
      : LS((L + 15) & ~15), NF(LS / 16), NS(LS / 16 + 2), C(L - m + 1) {}
  __host__ __device__ int slots(int RB) const { return RB * C + ((RB * C) >> 3) + 1; }
  // the warps' totals, prefix and suffix maxima, bytes, the two streams
  __host__ __device__ int64_t smem(int RB) const {
    return 16ll * kWarps + 16ll * slots(RB) + (int64_t)RB * LS + 8ll * RB * NS;
  }
};

__device__ __forceinline__ u64 quick_hash(u64 v) {
  v = v * 3935559000370003845ull + 2691343689449507681ull;
  v ^= v >> 21;
  v ^= v << 37;
  v ^= v >> 4;
  v *= 4768777513237032717ull;
  v ^= v << 20;
  v ^= v >> 41;
  v ^= v << 5;
  return v;
}

// a % d for a u32 a and 1 <= d < 2^32, from M = floor((2^64 - 1) / d) + 1
// mod 2^64: the high 64 bits of (M a mod 2^64) d (Lemire, Kaser and Kurz,
// "Faster remainder by direct computation", 2019), exact for every a
__device__ __forceinline__ uint32_t fastmod(uint32_t a, u64 M, uint32_t d) {
  return (uint32_t)__umul64hi(M * a, (u64)d);
}

// one element of a segmented max: a least value, bit 0 set where a segment
// starts (in scan order); a precedes b
__device__ __forceinline__ u64 seg_max(u64 a, u64 b) {
  if (b & 1ull) return b;
  const u64 av = a & ~1ull;
  return (av > b ? av : b) | (a & 1ull);
}

struct Cands {
  const uint32_t* fw;
  const uint32_t* rv;
  int NS, C, w, Qc;  // stream words a read, candidates a read, window, the tile's candidates
  int jr0;           // reverse-stream base of candidate 0's reverse complement
  u64 mask;          // the top 2m bits
};

// a thread's kItems candidates from q0 on (flattened (read, candidate)
// index of the tile): least values, and bit i of sf / ef set where
// candidate q0 + i starts / ends a segment (past the tile: 0, both set)
__device__ __forceinline__ void candidates(const Cands& cd, int q0, u64 (&v)[kItems],
                                           uint32_t& sf, uint32_t& ef) {
  int r = q0 / cd.C, c = q0 - r * cd.C, cs = c % cd.w;
  sf = 0;
  ef = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (q0 + i < cd.Qc) {
      const uint32_t* f = cd.fw + r * cd.NS + (c >> 4);
      const int j = cd.jr0 - c;
      const uint32_t* g = cd.rv + r * cd.NS + (j >> 4);
      const uint32_t s = 2 * (c & 15), sg = 2 * (j & 15);
      const uint32_t f1 = f[1], g1 = g[1];
      const u64 fwd = (((u64)__funnelshift_l(f1, f[0], s) << 32) | __funnelshift_l(f[2], f1, s))
                      & cd.mask;
      const u64 rc = (((u64)__funnelshift_l(g1, g[0], sg) << 32) | __funnelshift_l(g[2], g1, sg))
                     & cd.mask;
      v[i] = fwd < rc ? fwd : rc;
      sf |= (cs == 0 ? 1u : 0u) << i;
      ef |= (cs == cd.w - 1 || c == cd.C - 1 ? 1u : 0u) << i;
    } else {
      v[i] = 0;
      sf |= 1u << i;
      ef |= 1u << i;
    }
    if (++cs == cd.w) cs = 0;
    if (++c == cd.C) {
      c = 0;
      cs = 0;
      ++r;
    }
  }
}

struct Part {
  u64 inc, adj;  // the warp's inclusive prefix at this lane, and its neighbour's
};

// the warp half of a forward segmented max over a thread's items
__device__ __forceinline__ Part warp_forward(const u64 (&v)[kItems], uint32_t sf, int lane) {
  u64 inc = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) inc = seg_max(inc, v[i] | ((sf >> i) & 1u));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = seg_max(o, inc);
  }
  return {inc, __shfl_up_sync(0xffffffffu, inc, 1)};
}

__device__ __forceinline__ Part warp_backward(const u64 (&v)[kItems], uint32_t ef, int lane) {
  u64 inc = 0;
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i) inc = seg_max(inc, v[i] | ((ef >> i) & 1u));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 o = __shfl_down_sync(0xffffffffu, inc, off);
    if (lane + off < 32) inc = seg_max(o, inc);
  }
  return {inc, __shfl_down_sync(0xffffffffu, inc, 1)};
}

// after the warps' totals are in s_warp: the items' maxima to pre, after
// `carry`; returns the running maximum at the chunk's end
__device__ __forceinline__ u64 finish_forward(const u64 (&v)[kItems], uint32_t sf, Part p,
                                              u64 carry, const u64* s_warp, u64* pre, int q0,
                                              int Qc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 run = carry, tot = carry;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const u64 x = s_warp[w];
    if (w < warp) run = seg_max(run, x);
    tot = seg_max(tot, x);
  }
  if (lane > 0) run = seg_max(run, p.adj);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = seg_max(run, v[i] | ((sf >> i) & 1u));
    if (q0 + i < Qc) pre[slot(q0 + i)] = run & ~1ull;
  }
  return tot;
}

__device__ __forceinline__ u64 finish_backward(const u64 (&v)[kItems], uint32_t ef, Part p,
                                               u64 carry, const u64* s_warp, u64* suf, int q0,
                                               int Qc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 run = carry, tot = carry;
#pragma unroll
  for (int w = kWarps - 1; w >= 0; --w) {
    const u64 x = s_warp[w];
    if (w > warp) run = seg_max(run, x);
    tot = seg_max(tot, x);
  }
  if (lane < 31) run = seg_max(run, p.adj);
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i) {
    run = seg_max(run, v[i] | ((ef >> i) & 1u));
    if (q0 + i < Qc) suf[slot(q0 + i)] = run & ~1ull;
  }
  return tot;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    minimizer_kernel(const uint8_t* __restrict__ codes, int64_t B, int L, int k, int m, int RB,
                     bool vec, uint32_t S, u64 recip, uint32_t two32, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile tl(L, m);
  const int P = L - k + 1, w = k - m + 1, n_slots = tl.slots(RB);
  u64* s_fwd = reinterpret_cast<u64*>(smem);  // the warps' totals, each direction
  u64* s_bwd = s_fwd + kWarps;
  u64* pre = s_bwd + kWarps;
  u64* suf = pre + n_slots;
  uint8_t* sb = reinterpret_cast<uint8_t*>(suf + n_slots);  // RB x LS packing codes
  uint32_t* fw = reinterpret_cast<uint32_t*>(sb + RB * tl.LS);
  uint32_t* rv = fw + RB * tl.NS;
  const int64_t b0 = (int64_t)blockIdx.x * RB;
  const int nr = (int)min((int64_t)RB, B - b0);

  // 1. the tile's packing codes, a byte a base, then the two streams
  if (vec) {  // L % 16 == 0 and 16-byte aligned codes: rows are whole uint4s
    const uint4* c4 = reinterpret_cast<const uint4*>(codes + b0 * L);
    uint4* s4 = reinterpret_cast<uint4*>(sb);
    for (int u = threadIdx.x; u < nr * L / 16; u += kThreads) {
      const uint4 c = __ldg(c4 + u);
      s4[u] = make_uint4(code_bytes(c.x), code_bytes(c.y), code_bytes(c.z), code_bytes(c.w));
    }
  } else {
    const uint8_t* c = codes + b0 * L;
    for (int p = threadIdx.x; p < nr * L; p += kThreads) {
      const int r = p / L;
      sb[r * tl.LS + p - r * L] = (uint8_t)code_bytes(c[p]);
    }
  }
  __syncthreads();
  build_streams<kThreads>(sb, nr, L, tl.LS, tl.NF, tl.NS, fw, rv);
  __syncthreads();

  // 2. the prefix and suffix maxima of every candidate: one chunk (every
  // read up to the tile) scans both ways at once, with one barrier between
  // the warps' halves and the finishes; longer reads scan chunk by chunk,
  // forward and then backward, with carries
  const Cands cd{fw, rv, tl.NS, tl.C, w, nr * tl.C, 16 * tl.NF - m, ~0ull << (64 - 2 * m)};
  const int n_ch = (cd.Qc + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 v[kItems];
  uint32_t sf, ef;
  if (n_ch == 1) {
    const int q0 = threadIdx.x * kItems;
    candidates(cd, q0, v, sf, ef);
    const Part f = warp_forward(v, sf, lane), g = warp_backward(v, ef, lane);
    if (lane == 31) s_fwd[warp] = f.inc;
    if (lane == 0) s_bwd[warp] = g.inc;
    __syncthreads();
    finish_forward(v, sf, f, 0, s_fwd, pre, q0, cd.Qc);
    finish_backward(v, ef, g, 0, s_bwd, suf, q0, cd.Qc);
  } else {
    u64 carry = 0;
    for (int ch = 0; ch < n_ch; ++ch) {
      const int q0 = ch * kChunk + threadIdx.x * kItems;
      candidates(cd, q0, v, sf, ef);
      const Part f = warp_forward(v, sf, lane);
      if (lane == 31) s_fwd[warp] = f.inc;
      __syncthreads();
      carry = finish_forward(v, sf, f, carry, s_fwd, pre, q0, cd.Qc);
      __syncthreads();  // s_fwd is reused
    }
    carry = 0;
    for (int ch = n_ch - 1; ch >= 0; --ch) {
      const int q0 = ch * kChunk + threadIdx.x * kItems;
      candidates(cd, q0, v, sf, ef);
      const Part g = warp_backward(v, ef, lane);
      if (lane == 0) s_bwd[warp] = g.inc;
      __syncthreads();
      carry = finish_backward(v, ef, g, carry, s_bwd, suf, q0, cd.Qc);
      __syncthreads();
    }
  }
  __syncthreads();

  // 3. one position a thread, neighbouring threads on neighbouring rows
  int r = threadIdx.x / P, i = threadIdx.x - r * P;
  for (int t = threadIdx.x; t < nr * P; t += kThreads) {
    const int q = r * tl.C + i;
    const u64 a = suf[slot(q)], b = pre[slot(q + w - 1)];
    const u64 h = quick_hash(a > b ? a : b);
    const uint32_t part =
        fastmod((uint32_t)(h >> 32), recip, S) * two32 + fastmod((uint32_t)h, recip, S);
    out[b0 * P + t] = (int32_t)fastmod(part, recip, S);
    i += kThreads;
    while (i >= P) {
      i -= P;
      ++r;
    }
  }
}

}  // namespace

// codes (B, L) u8 -> out (B, L-k+1) i32 target shards; recip =
// floor((2^64 - 1) / n_shards) + 1 mod 2^64 and two32 = 2^32 % n_shards,
// from the host (n_shards^2 < 2^32).
extern "C" int mhm2_minimizer(const void* codes, int64_t B, int L, int k, int m,
                              uint32_t n_shards, unsigned long long recip, uint32_t two32,
                              void* out, void* stream) {
  MHM2_REQUIRE(m >= 1 && m <= 28 && m <= k && L >= k);
  MHM2_REQUIRE(n_shards >= 1 && n_shards < 65536 && two32 < n_shards);
  if (B == 0) return (int)cudaGetLastError();
  const int RB = max(1, kTileBases / L);
  const int64_t smem = Tile(L, m).smem(RB);
  MHM2_REQUIRE(smem <= kMaxSmem);
  const int64_t blocks = (B + RB - 1) / RB;
  MHM2_REQUIRE(blocks < (1ll << 31));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minimizer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = L % 16 == 0 && (uintptr_t)codes % 16 == 0;
  minimizer_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, B, L, k, m, RB, vec, n_shards, recip, two32, (int32_t*)out);
  return (int)cudaGetLastError();
}
