// The flags of a decoupled look-back, shared by rglru.cu and wkv6.cu.
//
// A chunked scan publishes, per chunk, first its aggregate and then its
// inclusive state, each followed by a flag (0: nothing yet, AGG, INCL) that
// a later chunk reads before it reads the values. Flags are written with a
// volatile store after the values and a __threadfence, read with a volatile
// load; the values after them must be read through L2 (__ldcg), not the
// incoherent L1. Blocks take their chunks from a counter (the int just past
// the flags) in launch order, so every chunk a block waits for belongs to a
// block that started earlier and the wait ends; a wait that does not end
// within kMaxSpins sleeps (about 4 s) traps instead of hanging the card.
// Each call's flags and counter are zeroed by a kernel of its own library
// that calls clear_flags, so a profile that sums a library's kernels by
// name counts the clearing too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int AGG = 1, INCL = 2;
constexpr unsigned kMaxSpins = 1u << 26;

__device__ __forceinline__ int ld_flag(const int* p) {
  return *reinterpret_cast<volatile const int*>(p);
}
__device__ __forceinline__ void set_flag(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}
// f, or once it is 0 (nothing published yet) the flag at p when it is set
__device__ __forceinline__ int wait_flag(const int* p, int f) {
  for (unsigned spins = 0; f == 0; ++spins) {
    if (spins == kMaxSpins) __trap();  // never: a lost chunk
    __nanosleep(64);
    f = ld_flag(p);
  }
  return f;
}
// Zeroes flag[0 .. n]: n flags and the counter after them.
__device__ __forceinline__ void clear_flags(int* __restrict__ flag,
                                            int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i <= n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    flag[i] = 0;
}
// Blocks of `threads` for clear_flags over n + 1 ints, at most 1024.
inline unsigned clear_blocks(int64_t n, int threads) {
  const int64_t b = (n + threads) / threads;
  return static_cast<unsigned>(b < 1024 ? b : 1024);
}
