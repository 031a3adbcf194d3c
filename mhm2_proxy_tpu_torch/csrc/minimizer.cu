// minimizer: the target shard of every k-mer position of a block.
//
// Replaces mhm2_proxy_tpu/ops/pallas_minimizer.py:179
// `pallas_minimizer_targets` (kernel body `_make_kernel`, :116). For each
// (read, position p < P = L-k+1): the minimizer of the k-mer at p, which is
// the greatest least-complement m-mer among its k-m+1 candidates (the m-mer
// at i packs bases i..i+m-1 into the top 2m bits of a u64, N as G; least =
// min(m-mer, its reverse complement); reference kmer.cpp:344-403), then the
// reference's quick_hash (hash_funcs.c:332-342), then the hash % n_shards
// (kmer_dht.cpp:193-196), as int32.
//
// What bounds it on an H100: operations. It reads B*L code bytes and writes
// 4*B*P bytes, but every position needs a candidate's reverse complement,
// the window max and a 64-bit hash and remainder, ~100 int32 operations
// (u64 operations count two), against ~5 bytes moved.
// Design: the TPU kernel carries every u64 as a (hi, lo) u32 pair because
// its vector unit has no 64-bit integers, and multiplies from 16-bit limbs;
// here `unsigned long long` is native, so the hash and the remainder are
// plain C. One block per (read, tile of kTile positions): the tile's bases
// (kTile + k - 1, past L read as A) are staged in shared memory, each thread
// packs candidates and their least complements into shared memory, then
// each thread takes its position's max over k-m+1 candidates (7 at k = 21,
// 73 at k = 99) and hashes it. A simple design first: the candidate packing
// re-reads m bases per candidate and the window max is a linear scan.
#include "common.cuh"

namespace {

constexpr int kTile = 128;   // positions (and threads) per block
constexpr int kMaxK = 160;   // longest k the shared buffers hold

__device__ __forceinline__ unsigned long long rev2bits64(unsigned long long v) {
  v = ((v & 0x3333333333333333ull) << 2) | ((v >> 2) & 0x3333333333333333ull);
  v = ((v & 0x0F0F0F0F0F0F0F0Full) << 4) | ((v >> 4) & 0x0F0F0F0F0F0F0F0Full);
  v = ((v & 0x00FF00FF00FF00FFull) << 8) | ((v >> 8) & 0x00FF00FF00FF00FFull);
  v = ((v & 0x0000FFFF0000FFFFull) << 16) | ((v >> 16) & 0x0000FFFF0000FFFFull);
  return (v << 32) | (v >> 32);
}

__device__ __forceinline__ unsigned long long quick_hash(unsigned long long v) {
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

__global__ void minimizer_kernel(const uint8_t* __restrict__ codes, int L, int P, int k, int m,
                                 int n_tiles, uint32_t n_shards, int32_t* __restrict__ out) {
  __shared__ uint8_t s_codes[kTile + kMaxK];
  __shared__ unsigned long long s_least[kTile + kMaxK];
  const int64_t b = blockIdx.x / n_tiles;
  const int p0 = (int)(blockIdx.x - b * n_tiles) * kTile;
  const uint8_t* row = codes + b * L;
  const int n_cand = k - m + 1;
  for (int j = threadIdx.x; j < kTile + k - 1; j += blockDim.x) {
    const int g = p0 + j;
    const uint32_t c = g < L ? row[g] : 0u;
    s_codes[j] = (uint8_t)(c >= 4 ? 2u : c);
  }
  __syncthreads();
  const int shift = 2 * (32 - m);
  for (int j = threadIdx.x; j < kTile + n_cand - 1; j += blockDim.x) {
    unsigned long long v = 0;
    for (int t = 0; t < m; ++t) v = (v << 2) | s_codes[j + t];
    v <<= shift;
    const unsigned long long r = rev2bits64(~v) << shift;
    s_least[j] = v < r ? v : r;
  }
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (p >= P) return;
  unsigned long long mz = 0;
  for (int t = 0; t < n_cand; ++t) {
    const unsigned long long x = s_least[threadIdx.x + t];
    mz = x > mz ? x : mz;
  }
  out[b * P + p] = (int32_t)(quick_hash(mz) % n_shards);
}

}  // namespace

// codes (B, L) u8 -> out (B, L-k+1) i32 target shards.
extern "C" int mhm2_minimizer(const void* codes, int64_t B, int L, int k, int m,
                              uint32_t n_shards, void* out, void* stream) {
  MHM2_REQUIRE(k >= 1 && k <= kMaxK && m >= 1 && m <= 28 && m <= k && L >= k);
  MHM2_REQUIRE(n_shards >= 1);
  const int P = L - k + 1;
  if (B == 0) return (int)cudaGetLastError();
  const int64_t n_tiles = (P + kTile - 1) / kTile;
  const int64_t blocks = B * n_tiles;
  MHM2_REQUIRE(blocks < (1ll << 31));
  minimizer_kernel<<<(unsigned)blocks, kTile, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, L, P, k, m, (int)n_tiles, n_shards, (int32_t*)out);
  return (int)cudaGetLastError();
}
