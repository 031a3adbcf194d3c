// The decoupled look-back's shared pieces (compact.cu, scan.cu): tiles
// taken by atomic ticket, status words tagged with the call's generation,
// and the poll that waits for a predecessor's word.
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
