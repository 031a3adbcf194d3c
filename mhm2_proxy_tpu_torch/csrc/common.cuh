// Shared definitions for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py): device pointers and the CUDA stream arrive as void*, the
// kernel launches on that stream without synchronising, and the entry
// returns cudaGetLastError() so a refused launch raises in the wrapper.
// Rows are u32 lanes (torch.int32 storage with the reference's bit
// patterns); a "lanes" argument is a host array of per-lane pointers,
// copied into a by-value struct so the kernel gets them as parameters.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MHM2_MAX_LANES 16

struct Lanes {
  uint32_t* p[MHM2_MAX_LANES];
};

struct CLanes {
  const uint32_t* p[MHM2_MAX_LANES];
};

static inline Lanes make_lanes(void* const* ptrs, int n) {
  Lanes l = {};
  for (int i = 0; i < n && i < MHM2_MAX_LANES; ++i) l.p[i] = (uint32_t*)ptrs[i];
  return l;
}

static inline CLanes make_clanes(const void* const* ptrs, int n) {
  CLanes l = {};
  for (int i = 0; i < n && i < MHM2_MAX_LANES; ++i) l.p[i] = (const uint32_t*)ptrs[i];
  return l;
}

// cudaErrorInvalidValue for arguments the kernels do not take
#define MHM2_REQUIRE(cond) \
  do {                     \
    if (!(cond)) return (int)cudaErrorInvalidValue; \
  } while (0)
