// Shared pieces of the string kernels (levenshtein.cu, jaro_winkler.cu).
//
// Every kernel takes one pair per thread. A launch's variant is the number
// of 32-bit words W that one pair's per-position sets need, W = ceil(L/32)
// for the column width L, compiled with W fixed (Levenshtein: 1, 2, 4, 8;
// Jaro-Winkler: 1), or 0 for the generic form of each kernel, whose W is
// read at run time and whose per-pair words live in scratch that the caller
// allocates as (2W, n) uint32 (word k of pair p at k * n + p, so a warp's
// accesses to one word are contiguous).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), so a refused launch is reported to the caller.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splink {

constexpr int kThreads = 256;

inline unsigned grid_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace splink
