// The decoupled look-back's shared pieces (compact.cu, finalize.cu, and
// scan.cu through seglookback.cuh): tiles taken by atomic ticket, status
// words tagged with the call's generation, the poll that waits for a
// predecessor's word, and the look-back over tiles' row counts.
//
// Hopper starts a grid's blocks in no order, so a tile may only wait on
// tiles whose blocks already run: each block takes its tile from an atomic
// ticket, and the last taker resets the ticket to 0 for the next call. A
// status word holds the call's generation above its state bits, so the
// words of earlier calls read as unpublished and no memset runs between
// calls. Where a tile's values do not fit its status word, the tile stores
// them first and the word after with release order, and readers poll it
// with acquire order.
#pragma once

#include <stdint.h>

// a status word's state: the tile's aggregate, or its inclusive prefix (0:
// not yet published)
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

static __device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

static __device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Every thread of the block: the block's tile among T, in the order blocks
// take the ticket (thread 0 takes it; `slot` is a __shared__ word).
static __device__ __forceinline__ int64_t take_tile(int* ticket, int64_t T, int64_t* slot) {
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    if (t == T - 1) atomicExch(ticket, 0);  // every ticket is out: reset for the next call
    *slot = t;
  }
  __syncthreads();
  return *slot;
}

// The status word at p once it holds generation `gen` (the bits from
// gen_shift up) and a state (the two bits at state_shift); Acquire: each
// read has acquire order, so the values stored before the word are seen.
template <bool Acquire>
static __device__ __forceinline__ unsigned long long wait_status(const unsigned long long* p,
                                                                 unsigned long long gen,
                                                                 int gen_shift, int state_shift) {
  for (;;) {
    const unsigned long long s = Acquire ? ld_acquire(p) : ld_relaxed(p);
    if ((s >> gen_shift) == gen && ((s >> state_shift) & 3ull) != 0) return s;
    __nanosleep(20);
  }
}

// A count's status word: generation << 33 | state << 31 | value (< 2^31).
static __device__ __forceinline__ unsigned long long count_status(unsigned long long gen,
                                                                  unsigned long long state,
                                                                  int64_t v) {
  return (gen << 33) | (state << 31) | (unsigned long long)v;
}

// Warp-wide: the sum of the counts of the tiles before t, whose status
// words lie at status[i * stride], looking back 32 predecessors at a time
// until an inclusive prefix.
static __device__ int64_t count_look_back(const unsigned long long* status, int64_t stride,
                                          int64_t t, unsigned long long gen) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t p = t - 1;; p -= 32) {
    const int64_t idx = p - lane;
    unsigned long long s = 0;
    if (idx >= 0) s = wait_status<false>(status + idx * stride, gen, 33, 31);
    const bool is_prefix = idx < 0 || ((s >> 31) & 3ull) == kPrefix;
    const unsigned pm = __ballot_sync(0xffffffffu, is_prefix);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    int64_t v = (lane <= stop && idx >= 0) ? (int64_t)(s & 0x7FFFFFFFull) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (pm) return excl;
  }
}
