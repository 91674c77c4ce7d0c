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
// a time (eq4). The lane-group forms (variant -G, G lanes of a warp a
// pair, widths up to 1024) stage and order the same way with one prologue
// (stage_group_block on a StagedLayout), find their pair with GroupLane
// and are launched by launch_group in blocks sized by group_threads, each
// lane holding 32 positions of one side.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), so a refused launch is reported to the caller.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splink {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;  // every lane of a warp
constexpr int kMaxSmem = 227 * 1024;     // a block's shared memory, with the opt-in
constexpr int kGroupTiles = 32 * 1024;   // the lane-group forms' staged rows, a block

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

// Threads of a lane-group block (`groups` pairs a warp, one row of each
// side a pair staged): 256, halved (down to one warp) while the staged
// rows pass kGroupTiles.
inline int group_threads(int rowbytes, int groups) {
  int threads = kThreads;
  while (threads > 32 && 2 * (threads / 32) * groups * rowbytes > kGroupTiles) threads >>= 1;
  return threads;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// Shared memory of a staged block of `rows` pairs (Jaro-Winkler's forms,
// Levenshtein's lane-group form): the two tiles (each with slack, 16-byte
// aligned); per slot (a pair, or a survivor of a masked launch, in row
// order) both lengths, its row in the block and its place in the order;
// the counting sort's histogram over one length 0..width; per 32 rows the
// survivor count, then their total (masked launches only).
struct StagedLayout {
  int tile, len1, len2, rowid, order, hist, counts, bytes;
  __host__ __device__ StagedLayout(int rows, int rowbytes, int width) {
    tile = (rows * rowbytes + kSlack + 15) & ~15;
    len1 = 2 * tile;
    len2 = len1 + 4 * rows;
    rowid = len2 + 4 * rows;
    order = rowid + 4 * rows;
    hist = order + 4 * rows;
    counts = hist + 4 * (width + 1);
    bytes = counts + 4 * ((rows + 31) / 32 + 1);
  }
};

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

// The lane-group forms' prologue, run by the whole block on its
// StagedLayout: stages slots 0 .. count) (rows rowid[slot] of g1 and g2
// where a masked launch compacted them, else rows 0 .. count)) into the
// two tiles, keeps both lengths of each slot in len1 / len2 as given, and
// orders the slots by the shorter length clamped to [0, width] with the
// counting sort, so that the groups of a warp take about as many steps.
// count <= blockDim.x, so a thread sorts at most one slot. Returns with
// the tiles landed and the block synchronised.
__device__ __forceinline__ void stage_group_block(unsigned char* smem, const StagedLayout& lay,
                                                  const unsigned char* g1,
                                                  const unsigned char* g2, const int32_t* l1p,
                                                  const int32_t* l2p, int64_t first,
                                                  const int* rowid, int count, int rowbytes,
                                                  int width) {
  int* len1 = reinterpret_cast<int*>(smem + lay.len1);
  int* len2 = reinterpret_cast<int*>(smem + lay.len2);
  int* order = reinterpret_cast<int*>(smem + lay.order);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  const int tid = threadIdx.x;
  for (int k = tid; k <= width; k += blockDim.x) hist[k] = 0;
  if (rowid != nullptr) {
    stage_rows(smem, g1, rowid, count, rowbytes);
    stage_rows(smem + lay.tile, g2, rowid, count, rowbytes);
  } else {
    stage_tile(smem, g1, count * rowbytes);
    stage_tile(smem + lay.tile, g2, count * rowbytes);
  }
  __syncthreads();  // the histogram is zeroed
  int key = 0;
  int rank = 0;
  if (tid < count) {
    const int64_t row = first + (rowid != nullptr ? rowid[tid] : tid);
    const int a = l1p[row];
    const int b = l2p[row];
    len1[tid] = a;
    len2[tid] = b;
    key = min(max(min(a, b), 0), width);
    rank = atomicAdd(&hist[key], 1);
  }
  __syncthreads();
  exclusive_scan_bins(hist, width + 1);
  __syncthreads();
  if (tid < count) order[hist[key] + rank] = tid;
  cp_async_wait_all();
  __syncthreads();
}

// A lane of a lane-group block, `lanes` lanes a pair: its group (the gw-th
// of its warp, lanes gbase .. gbase + lanes - 1), its place l in the group
// and the slot of the group's pair, the block's (warp * floor(32 / lanes) +
// gw)-th shortest; -1 for the lanes past the warp's last whole group and
// for groups past the block's `count` slots.
struct GroupLane {
  int gbase, l, slot;
  __device__ __forceinline__ GroupLane(int lanes, const int* order, int count) {
    const int lane = threadIdx.x & 31;
    const int groups = 32 / lanes;
    const int gw = lane / lanes;
    const int k = static_cast<int>(threadIdx.x >> 5) * groups + gw;
    gbase = gw * lanes;
    l = lane - gbase;
    slot = gw < groups && k < count ? order[k] : -1;
  }
};

// Pairs of a lane-group block of blockDim.x threads.
__device__ __forceinline__ int group_block_pairs(int lanes) {
  return static_cast<int>(blockDim.x >> 5) * (32 / lanes);
}

// Launches a lane-group kernel over n pairs in blocks of group_threads,
// with its StagedLayout's shared memory; `args` are the kernel's own.
template <typename K, typename... Args>
int launch_group(K kernel, int64_t n, int rowbytes, int width, int lanes, cudaStream_t stream,
                 Args... args) {
  const int groups = 32 / lanes;
  const int threads = group_threads(rowbytes, groups);
  const int per_block = threads / 32 * groups;
  const int smem = StagedLayout(per_block, rowbytes, width).bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = allow_smem(kernel, smem)) return e;
  kernel<<<grid_for(n, per_block), threads, smem, stream>>>(args...);
  return 0;
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
