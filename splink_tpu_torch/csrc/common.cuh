// Shared pieces of the string kernels (levenshtein.cu, jaro_winkler.cu).
//
// A launch's variant is the number of 32-bit words W that one pair's
// per-position sets need, W = ceil(L/32) for the column width L, compiled
// with W fixed (Levenshtein: 1, 2, 4, 8; Jaro-Winkler: 1, 2), or 0 for the
// generic form of each kernel, whose W is read at run time and whose
// per-pair words live in scratch that the caller allocates as (2W, n)
// uint32 (word k of pair p at k * n + p, so a warp's accesses to one word
// are contiguous).
//
// The fixed-W forms share one block structure, built from the helpers
// below: a block stages its rows of s1 and of s2 in shared memory with
// coalesced 16-byte cp.async copies (stage_tile, or stage_rows for a
// gathered subset), orders its pairs by one length with a counting sort
// (exclusive_scan_bins), and each thread holds one side of its pair in
// registers (Pattern), compared with a broadcast character four bytes at
// a time (eq4).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), so a refused launch is reported to the caller.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splink {

constexpr int kThreads = 256;

// Pairs per thread in the staged kernels: a block stages kRows *
// blockDim.x rows at once, so it pays its load latency and its barriers
// once for more work.
constexpr int kRows = 2;

constexpr int kSlack = 16;  // load_word may read 3 bytes past a tile

inline unsigned grid_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// Threads of a staged block: as many as keep each staged tile near 16 KB,
// so that several blocks share an SM at every width (a multiple of 32).
inline int threads_for(int rowbytes) {
  if (rowbytes <= 32) return kThreads;
  if (rowbytes <= 64) return 128;
  if (rowbytes <= 128) return 64;
  return 32;
}

// One 16-byte asynchronous copy global -> shared (Ampere and later).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One 4- or 8-byte asynchronous copy global -> shared (through L1).
template <int Bytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(Bytes));
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `bytes` contiguous bytes from global memory into shared memory with
// the whole block: 16-byte cp.async where the source is 16-byte aligned
// (dst always is), single bytes otherwise and for the ragged tail. The
// caller waits (cp_async_wait_all) and synchronises the block.
__device__ __forceinline__ void stage_tile(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int n16 = bytes >> 4;
    for (int k = threadIdx.x; k < n16; k += blockDim.x) cp_async16(dst + 16 * k, src + 16 * k);
    done = n16 << 4;
  }
  for (int k = done + threadIdx.x; k < bytes; k += blockDim.x) dst[k] = src[k];
}

// Gather rows rowid[0 .. count) of `src` (rows of `rowbytes`) into
// consecutive rows of shared memory at `dst` with the whole block, in the
// widest cp.async unit (16, 8 or 4 bytes) that divides the row and the
// source's alignment, single bytes if none does. The caller waits and
// synchronises as for stage_tile.
__device__ __forceinline__ void stage_rows(unsigned char* dst, const unsigned char* src,
                                           const int* rowid, int count, int rowbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int unit = (rowbytes % 16 == 0 && (a & 15u) == 0)  ? 16
                   : (rowbytes % 8 == 0 && (a & 7u) == 0)  ? 8
                   : (rowbytes % 4 == 0 && (a & 3u) == 0)  ? 4
                                                           : 1;
  const int per_row = rowbytes / unit;
  for (int k = threadIdx.x; k < count * per_row; k += blockDim.x) {
    const int slot = k / per_row;
    const int at = (k - slot * per_row) * unit;
    unsigned char* d = dst + slot * rowbytes + at;
    const unsigned char* g = src + static_cast<int64_t>(rowid[slot]) * rowbytes + at;
    switch (unit) {
      case 16: cp_async16(d, g); break;
      case 8: cp_async_small<8>(d, g); break;
      case 4: cp_async_small<4>(d, g); break;
      default: *d = *g;
    }
  }
}

// Exclusive prefix sum, in place, of the `bins` counters at `hist` (the
// counting sort's histogram), by the block's first warp. Every thread
// calls it between two __syncthreads().
__device__ __forceinline__ void exclusive_scan_bins(int* hist, int bins) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int per = (bins + 31) / 32;  // buckets per lane
    const int lo = tid * per;
    const int hi = min(lo + per, bins);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += hist[k];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (tid >= d) incl += v;
    }
    int base = incl - sum;
    for (int k = lo; k < hi; ++k) {
      const int c = hist[k];
      hist[k] = base;
      base += c;
    }
  }
}

// The four bytes at smem + off as one little-endian word, for any `off`:
// one aligned load where off is a multiple of 4, else two and a funnel
// shift (reads at most 3 bytes past off + 4; callers leave that slack).
__device__ __forceinline__ uint32_t load_word(const unsigned char* smem, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + (off & ~3));
  if ((off & 3) == 0) return w[0];
  return __funnelshift_r(w[0], w[1], 8 * (off & 3));
}

// Match flags of the four bytes of `packed` against the character whose
// byte is broadcast in `bc`: bit k set iff byte k equals it.
__device__ __forceinline__ uint32_t eq4(uint32_t packed, uint32_t bc) {
  const uint32_t y = packed ^ bc;
  // bit 7 of each byte of t is set iff that byte of y is not zero (no
  // carry crosses a byte: 0x7F + 0x7F < 0x100)
  const uint32_t t = ((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y;
  const uint32_t z = ~t & 0x80808080u;
  // bits 7, 15, 23, 31 -> 28, 29, 30, 31; the multiplier's other products
  // land on distinct bits below 28 or past 31, so nothing carries
  return (z * 0x00204081u) >> 28;
}

// One string of a pair held in registers: uint8 packs four characters to a
// register (8 per word), 32-bit codepoints take one register each (32 per
// word). eq<NG>(w, x) is the match mask of word w against the character x
// (broadcast to four bytes for uint8), over its first NG groups of four
// positions; at(p) the character at position p. Positions past the
// string's own length hold whatever the tile holds there; callers mask
// them off.
template <typename T, int W>
struct Pattern;

template <int W>
struct Pattern<uint8_t, W> {
  uint32_t pk[8 * W];
  // the row starts `off` bytes into the 16-byte aligned `tile`; `span`
  // bounds the characters worth loading
  __device__ __forceinline__ void load(const unsigned char* tile, int off, int span) {
#pragma unroll
    for (int k = 0; k < 8 * W; ++k) pk[k] = 4 * k < span ? load_word(tile, off + 4 * k) : 0u;
  }
  template <int NG>
  __device__ __forceinline__ uint32_t eq(int w, uint32_t bc) const {
    uint32_t m = 0u;
#pragma unroll
    for (int k = 0; k < NG; ++k) m |= eq4(pk[8 * w + k], bc) << (4 * k);
    return m;
  }
  // the character at position p, for p fixed at compile time
  __device__ __forceinline__ uint32_t at(int p) const {
    return (pk[p >> 2] >> (8 * (p & 3))) & 0xFFu;
  }
};

template <int W>
struct Pattern<uint32_t, W> {
  uint32_t ch[32 * W];
  __device__ __forceinline__ void load(const unsigned char* tile, int off, int span) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(tile + off);
#pragma unroll
    for (int k = 0; k < 32 * W; ++k) ch[k] = k < span ? r[k] : 0u;
  }
  template <int NG>
  __device__ __forceinline__ uint32_t eq(int w, uint32_t c) const {
    uint32_t m = 0u;
#pragma unroll
    for (int k = 0; k < 4 * NG; ++k) m |= static_cast<uint32_t>(ch[32 * w + k] == c) << k;
    return m;
  }
  __device__ __forceinline__ uint32_t at(int p) const { return ch[p]; }
};

}  // namespace splink
