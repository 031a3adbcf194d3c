// compact: stable multi-class compaction of u32 lanes, one launch a call.
//
// Replaces mhm2_proxy_tpu/ops/pallas_compact.py:115 `ragged_append`
// (kernel body `_append_kernel`, :66) together with the tile-local
// lax.sort that its wrapper `compact_classes` (:165) runs first. Rows carry
// a class: an int32 flag in [0, n_classes) (other values: no class), or a
// u8 / bool keep mask (nonzero: class 0, zero: class 1). For each emitted
// class the class's rows land in a dense prefix of its outputs in their
// original order; with fill_tails the rows past the class count get a fill
// value per output lane, so every output row is written.
//
// What bounds it on an H100: memory. The function reads the flags once and
// the input lanes once, and writes the output lanes once.
// Design (one pass, decoupled look-back): each 256-thread block takes a
// 4096-row tile in ticket order (an atomic counter: Hopper starts blocks in
// no order, and a look-back needs earlier tiles to be live). It loads its
// flags with 16-byte loads (each thread owns 16 consecutive rows), counts
// each class in a 16-bit field of one u64, and block-scans that u64, which
// gives every row its rank within its class in the tile. It publishes each
// class's tile count in a status word (generation | flag | value; the
// generation makes the words of earlier calls stale, so no memset runs
// between calls), and warp c looks back over the predecessors' words for
// class c until it meets an inclusive prefix. The tile's rows are then
// partitioned by class in shared memory (u16 source rows), and every
// emitted class writes its rows to [offset, offset + count) of each output
// lane in one coalesced sweep, each thread keeping four gathered loads in
// flight before their stores: an output group of g <= 16 lanes that is one
// row-major (N, g) tensor is written with each thread on a fixed column and
// consecutive threads on consecutive addresses. Input
// lanes are a pointer plus an element stride, so the columns of a
// row-major words tensor are read in place. The tile's rows of other
// classes are the class's tail: they fill [N - q - r, N - q), counted from
// the end of the output (q = non-class rows of earlier tiles), as a two-way
// partition does, so no tile waits for the total. The last tile writes the
// class totals to a device tensor.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // rows a thread classifies
constexpr int kTile = kThreads * kItems;  // 4096 rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 4;
constexpr int kMaxEmit = 4;
constexpr int kMaxOut = 16;  // output lanes of one emitted class
constexpr int kNoClass = 0xF;
constexpr int kBatch = 4;  // gathered loads a thread keeps in flight

struct CompactDesc {
  const uint32_t* in[MHM2_MAX_LANES];
  int64_t in_stride[MHM2_MAX_LANES];
  uint32_t* out[kMaxEmit][kMaxOut];
  int64_t out_stride[kMaxEmit][kMaxOut];
  int src[kMaxEmit][kMaxOut];      // input lane of each output lane; -1: the constant 0
  uint32_t fill[kMaxEmit][kMaxOut];
  int gw[kMaxEmit][kMaxOut];       // the group's width where a group starts, else 0
  int n_out[kMaxEmit];
  int cls[kMaxEmit];
  int n_emit;
  int n_classes;
  int flag_bytes;                  // 4: int32 classes, 1: u8 keep mask
  int fill_tails;
  const void* flags;
  int64_t N;
  int64_t T;                       // tiles
  int32_t* counts;                 // (n_emit,) class totals
  unsigned long long* status;      // (T, n_classes) look-back words
  int* ticket;
  unsigned long long gen;          // this call's generation, in [1, 2^31)
};

// the class code (0-3, or kNoClass) of each of a thread's 16 rows, 4 bits each
__device__ __forceinline__ unsigned long long load_codes(const CompactDesc& d, int64_t row0) {
  unsigned long long codes = 0;
  if (d.flag_bytes == 4) {
    const int32_t* f = (const int32_t*)d.flags + row0;
    int v[kItems];
    if (row0 + kItems <= d.N) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        int4 x = __ldcs((const int4*)f + q);
        v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kItems; ++q) v[q] = row0 + q < d.N ? f[q] : -1;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      unsigned c = (unsigned)v[q] < (unsigned)d.n_classes ? (unsigned)v[q] : kNoClass;
      codes |= (unsigned long long)c << (4 * q);
    }
  } else {
    const uint8_t* f = (const uint8_t*)d.flags + row0;
    uint32_t w[4];
    if (row0 + kItems <= d.N) {
      uint4 x = __ldcs((const uint4*)f);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
      for (int q = 0; q < kItems; ++q)
        if (row0 + q < d.N) w[q / 4] |= (uint32_t)f[q] << (8 * (q % 4));
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const unsigned byte = (w[q / 4] >> (8 * (q % 4))) & 0xFFu;
      unsigned c = row0 + q < d.N ? (byte ? 0u : 1u) : kNoClass;
      codes |= (unsigned long long)c << (4 * q);
    }
  }
  return codes;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(const __grid_constant__ CompactDesc d) {
  __shared__ uint16_t s_src[kTile];  // the tile's rows, partitioned by class
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ int64_t s_excl[kMaxClasses];
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = take_tile(d.ticket, d.T, &s_tile);
  const int64_t base = t * kTile;
  const int rows = (int)(d.N - base < kTile ? d.N - base : kTile);

  // classify, and count each class in a 16-bit field
  const unsigned long long codes = load_codes(d, base + (int64_t)tid * kItems);
  unsigned long long cnt = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const unsigned c = (codes >> (4 * q)) & 0xF;
    cnt += c < kMaxClasses ? 1ull << (16 * c) : 0ull;
  }
  // block scan of the packed counts (fields stay below 2^16: 4096 rows)
  unsigned long long x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  unsigned long long wpre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned long long v = s_warp[w];
    wpre += w < warp ? v : 0ull;
    tot += v;
  }
  const unsigned long long run0 = wpre + x - cnt;  // this thread's exclusive ranks

  // warp c publishes the tile's count of class c, looks back, and
  // publishes the inclusive prefix (one thread stores both, in order)
  if (warp < d.n_classes) {
    const int64_t c_cnt = (int64_t)((tot >> (16 * warp)) & 0xFFFF);
    unsigned long long* own = d.status + t * d.n_classes + warp;
    if (lane == 0) st_relaxed(own, count_status(d.gen, t == 0 ? kPrefix : kAggregate, c_cnt));
    const int64_t excl = t == 0 ? 0 : count_look_back(d.status + warp, d.n_classes, t, d.gen);
    if (lane == 0) {
      s_excl[warp] = excl;
      if (t > 0) st_relaxed(own, count_status(d.gen, kPrefix, excl + c_cnt));
    }
  }

  // partition the tile by class: class c's rows start at the sum of the
  // counts of the classes below it
  const unsigned long long offs = (tot << 16) + (tot << 32) + (tot << 48);
  unsigned long long run = run0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const unsigned c = (codes >> (4 * q)) & 0xF;
    if (c < kMaxClasses) {
      const int pos = (int)(((offs + run) >> (16 * c)) & 0xFFFF);
      s_src[pos] = (uint16_t)(tid * kItems + q);
      run += 1ull << (16 * c);
    }
  }
  __syncthreads();

  if (t == d.T - 1 && tid < d.n_emit) {
    const int c = d.cls[tid];
    d.counts[tid] = (int32_t)(s_excl[c] + (int64_t)((tot >> (16 * c)) & 0xFFFF));
  }
  for (int e = 0; e < d.n_emit; ++e) {
    const int c = d.cls[e];
    const int c_cnt = (int)((tot >> (16 * c)) & 0xFFFF);
    const int p0 = (int)((offs >> (16 * c)) & 0xFFFF);
    const int64_t off = s_excl[c];
    const int rest = rows - c_cnt;
    const int64_t tail0 = d.N - (base - off) - rest;
    for (int l0 = 0; l0 < d.n_out[e]; ++l0) {
      const int g = d.gw[e][l0];
      const int step = g ? kThreads / g : 0;  // rows a sweep; thread tid < step * g takes part
      if (tid >= step * g) continue;
      const int l = l0 + tid % g;  // this thread's column
      uint32_t* o = d.out[e][l];
      const int64_t os = d.out_stride[e][l];
      const int s = d.src[e][l];
      if (s >= 0) {  // kBatch gathered loads in flight a thread before their stores
        const uint32_t* ip = d.in[s];
        const int64_t is = d.in_stride[s];
        for (int i0 = tid / g; i0 < c_cnt; i0 += step * kBatch) {
          uint32_t v[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int i = i0 + k * step;
            if (i < c_cnt) v[k] = ip[(base + s_src[p0 + i]) * is];
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int i = i0 + k * step;
            if (i < c_cnt) o[(off + i) * os] = v[k];
          }
        }
      } else {
        for (int i = tid / g; i < c_cnt; i += step) o[(off + i) * os] = 0u;
      }
      if (d.fill_tails) {
        const uint32_t f = d.fill[e][l];
        for (int i = tid / g; i < rest; i += step) o[(tail0 + i) * os] = f;
      }
    }
  }
}

}  // namespace

// in / in_stride: n_in input lanes of N rows (pointer, element stride);
// flags: (N,) int32 classes (flag_bytes 4) or u8 keep mask (flag_bytes 1,
// n_classes 2); cls: the n_emit emitted classes; per emitted class e,
// n_out[e] output lanes at [e * 16 + l] of out / out_stride / src / fill /
// gw (gw: the width of the row-major group that starts at lane l, 0
// inside a group); counts: (n_emit,) int32; status: >= T *
// n_classes u64 words, zero or of earlier generations; ticket: one int32,
// 0 between calls; gen in [1, 2^31), one more than the last call's.
extern "C" int mhm2_compact(const void* const* in, const int64_t* in_stride, int n_in,
                            const void* flags, int flag_bytes, int64_t N, int n_classes,
                            int n_emit, const int* cls, const int* n_out, void* const* out,
                            const int64_t* out_stride, const int* src, const uint32_t* fill,
                            const int* gw, int fill_tails, void* counts, void* status,
                            int64_t status_words, void* ticket, int64_t gen, void* stream) {
  MHM2_REQUIRE(n_in >= 0 && n_in <= MHM2_MAX_LANES && N >= 0 && N < (1ll << 31));
  MHM2_REQUIRE(n_classes >= 1 && n_classes <= kMaxClasses && n_emit >= 1 && n_emit <= kMaxEmit);
  MHM2_REQUIRE(flag_bytes == 4 || (flag_bytes == 1 && n_classes == 2));
  MHM2_REQUIRE(gen >= 1 && gen < (1ll << 31));
  if (N == 0) return (int)cudaGetLastError();
  CompactDesc d = {};
  for (int i = 0; i < n_in; ++i) {
    d.in[i] = (const uint32_t*)in[i];
    d.in_stride[i] = in_stride[i];
  }
  for (int e = 0; e < n_emit; ++e) {
    MHM2_REQUIRE(cls[e] >= 0 && cls[e] < n_classes && n_out[e] >= 0 && n_out[e] <= kMaxOut);
    d.cls[e] = cls[e];
    d.n_out[e] = n_out[e];
    int covered = 0;  // lanes of the groups started so far
    for (int l = 0; l < n_out[e]; ++l) {
      const int k = e * kMaxOut + l;
      MHM2_REQUIRE(src[k] >= -1 && src[k] < n_in && gw[k] >= 0 && gw[k] <= kMaxOut);
      MHM2_REQUIRE((gw[k] > 0) == (l == covered));
      covered += gw[k];
      d.out[e][l] = (uint32_t*)out[k];
      d.out_stride[e][l] = out_stride[k];
      d.src[e][l] = src[k];
      d.fill[e][l] = fill[k];
      d.gw[e][l] = gw[k];
    }
    MHM2_REQUIRE(covered == n_out[e]);
  }
  d.n_emit = n_emit;
  d.n_classes = n_classes;
  d.flag_bytes = flag_bytes;
  d.fill_tails = fill_tails;
  d.flags = flags;
  d.N = N;
  d.T = (N + kTile - 1) / kTile;
  MHM2_REQUIRE(status_words >= d.T * n_classes);
  d.counts = (int32_t*)counts;
  d.status = (unsigned long long*)status;
  d.ticket = (int*)ticket;
  d.gen = (unsigned long long)gen;
  compact_kernel<<<(unsigned)d.T, kThreads, 0, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}
