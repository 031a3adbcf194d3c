// 2-bit base streams in shared memory (extract.cu, minimizer.cu).
//
// A read of L bases is packed once into two streams of u32 words, 16 bases
// a word, first base highest: the forward bases, and their reverse
// complement (each forward word complemented and its fields reversed, the
// words in reverse order). Forward word m holds bases 16m..16m+15; reverse
// word NF-1-m is its complement with the fields reversed, so the reverse
// stream holds the read's reverse complement from its base 16 NF - L on
// (NF = ceil(L / 16)): the reverse complement of forward bases i..i+n-1 is
// reverse bases 16 NF - i - n onward. Both streams end in zero words, so a
// funnel shift of adjacent words at any base of the read stays inside
// them; bases past L pack as A and are cut by the caller's masks.
#pragma once

#include <stdint.h>

// the packing codes of four code bytes (0-3 ACGT, >= 4 N): N packs as G
__device__ __forceinline__ uint32_t code_bytes(uint32_t c) {
  const uint32_t ge4 = __vcmpgeu4(c, 0x04040404u);
  return (c & ~ge4) | (0x02020202u & ge4);
}

// the packing codes of four bytes (first base in the low byte) as 8 bits,
// first base highest: one multiply places the four 2-bit fields in the top
// byte without carries
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x03030303u) * 0x40100401u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return (pack4(v.x) << 24) | (pack4(v.y) << 16) | (pack4(v.z) << 8) | pack4(v.w);
}

// the 16 2-bit fields of x in reverse order
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Every thread of the block: the forward (fw) and reverse (rv) streams of
// nr reads of L bases, NS words a read (NF data words, then zero words),
// from the reads' bytes in shared memory, LS bytes a read (16-byte rows:
// the low two bits of each byte are its packing code).
template <int kThreads>
__device__ __forceinline__ void build_streams(const uint8_t* sb, int nr, int L, int LS, int NF,
                                              int NS, uint32_t* fw, uint32_t* rv) {
  for (int u = threadIdx.x; u < nr * NS; u += kThreads) {
    const int r = u / NS, m = u - r * NS;
    uint32_t* f = fw + r * NS;
    uint32_t* g = rv + r * NS;
    if (m < NF) {
      uint32_t w = pack16(reinterpret_cast<const uint4*>(sb + r * LS)[m]);
      const int nb = L - 16 * m;  // bases of the read in this word
      if (nb < 16) w &= ~0u << (32 - 2 * nb);
      f[m] = w;
      g[NF - 1 - m] = rev2(~w);
    } else {
      f[m] = 0;
      g[m] = 0;
    }
  }
}
