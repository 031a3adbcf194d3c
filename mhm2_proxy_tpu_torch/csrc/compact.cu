// compact: stable multi-class compaction of u32 lanes.
//
// Replaces mhm2_proxy_tpu/ops/pallas_compact.py:115 `ragged_append`
// (kernel body `_append_kernel`, :66) together with the tile-local
// lax.sort that its wrapper `compact_classes` (:165) runs first. Rows carry
// an int32 class flag in [0, n_classes); for each emitted class the class's
// rows land in a dense prefix in their original order (the caller masks
// everything past the class count).
//
// What bounds it on an H100: memory; one read of the flags for the count,
// then one read of the flags and of the lanes of the kept rows and one
// write of them per emitted class.
// Design: the TPU needs a tile sort plus an append because it cannot
// scatter; Hopper can. (1) mhm2_compact_count: each 1024-row block counts
// its rows per class with warp ballots. (2) The caller takes an exclusive
// cumsum of the block counts (plain torch, as the reference's per-tile
// cumsum is plain jnp). (3) mhm2_compact_scatter: each block walks its rows
// as four 256-row slices in order; a warp ballot plus a shared-memory scan
// of the warp totals gives every kept row its rank, and the row's lanes are
// stored at block offset + rank. Consecutive kept rows go to consecutive
// addresses, so loads and stores coalesce.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 4;
constexpr int kTile = kThreads * kSlices;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 4;

__global__ void compact_count(const int32_t* __restrict__ flags, int64_t N, int n_classes,
                              int32_t* counts) {
  __shared__ int s_cnt[kMaxClasses];
  if (threadIdx.x < kMaxClasses) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int q = 0; q < kSlices; ++q) {
    const int64_t r = base + q * kThreads + threadIdx.x;
    const int c = r < N ? flags[r] : -1;
    for (int cls = 0; cls < n_classes; ++cls) {
      unsigned m = __ballot_sync(0xffffffffu, c == cls);
      if (lane == 0 && m) atomicAdd(&s_cnt[cls], __popc(m));
    }
  }
  __syncthreads();
  if (threadIdx.x < n_classes)
    counts[(int64_t)threadIdx.x * gridDim.x + blockIdx.x] = s_cnt[threadIdx.x];
}

__global__ void compact_scatter(CLanes in, Lanes out, int n_lanes, const int32_t* __restrict__ flags,
                                int64_t N, int cls, const int64_t* offsets) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int64_t run = offsets[(int64_t)cls * gridDim.x + blockIdx.x];
  for (int q = 0; q < kSlices; ++q) {
    const int64_t r = base + q * kThreads + threadIdx.x;
    const bool m = r < N && flags[r] == cls;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (m) {
      const int64_t dst = run + before + __popc(bal & ((1u << lane) - 1u));
      // static lane bound: the pointer structs stay in the parameter bank
#pragma unroll
      for (int l = 0; l < MHM2_MAX_LANES; ++l)
        if (l < n_lanes) out.p[l][dst] = in.p[l][r];
    }
    run += total;
    __syncthreads();
  }
}

}  // namespace

// flags (N,) i32 in [0, n_classes); counts (n_classes, T) i32 with
// T = ceil(N / 1024): rows of each class per block (class-major, so the
// caller's cumsum runs along the innermost dimension).
extern "C" int mhm2_compact_count(const void* flags, int64_t N, int n_classes, void* counts,
                                  void* stream) {
  MHM2_REQUIRE(n_classes >= 1 && n_classes <= kMaxClasses && N >= 0);
  if (N == 0) return (int)cudaGetLastError();
  const int64_t T = (N + kTile - 1) / kTile;
  MHM2_REQUIRE(T < (1ll << 31));
  compact_count<<<(unsigned)T, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)flags, N, n_classes, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// lanes_in / lanes_out: n_lanes lanes of N rows; offsets (n_classes, T)
// i64: exclusive cumsum of the block counts per class. Rows of class cls
// are written to lanes_out at offsets[cls, t] + rank within block t.
extern "C" int mhm2_compact_scatter(const void* const* lanes_in, void* const* lanes_out,
                                    int n_lanes, const void* flags, int64_t N, int cls,
                                    int n_classes, const void* offsets, void* stream) {
  MHM2_REQUIRE(n_lanes >= 1 && n_lanes <= MHM2_MAX_LANES);
  MHM2_REQUIRE(cls >= 0 && cls < n_classes && n_classes <= kMaxClasses && N >= 0);
  if (N == 0) return (int)cudaGetLastError();
  const int64_t T = (N + kTile - 1) / kTile;
  compact_scatter<<<(unsigned)T, kThreads, 0, (cudaStream_t)stream>>>(
      make_clanes(lanes_in, n_lanes), make_lanes(lanes_out, n_lanes), n_lanes,
      (const int32_t*)flags, N, cls, (const int64_t*)offsets);
  return (int)cudaGetLastError();
}
