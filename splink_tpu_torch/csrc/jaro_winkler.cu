// Batched Jaro-Winkler for Hopper (sm_90a), one pair per thread.
//
// Replaces splink_tpu/ops/strings_pallas.py:jaro_winkler_pallas (body
// _jw_kernel). The TPU kernel lays pairs on the 128 vector lanes and counts
// prefixes with triangular matmuls on the MXU. Neither trick applies here:
// a thread holds a whole pair and runs the bit-parallel scalar algorithm of
// splink_tpu/ops/strings.py:jaro_winkler_bitmask_single on it.
//
// What bounds it on this card: a pair is 2L bytes of characters, 8 bytes of
// lengths and 4 bytes out, against, per character of the shorter string,
// one match mask over the longer string (ceil(L / 4) SWAR compares for
// uint8) and a handful of word operations, so at the widths of real
// columns HBM bounds it if the work stays in registers and no lane of a
// warp idles. The fixed-width kernel (W = 1 for width <= 32, W = 2 for
// width <= 64, whose sets are 64-bit words) shares the block structure of
// levenshtein.cu (common.cuh):
//
//   * the block's rows (two pairs per thread) of s1 and of s2 are staged
//     into shared memory with coalesced 16-byte cp.async copies;
//   * the block orders its pairs by the shorter length, the greedy pass's
//     step count (a counting sort in shared memory), before handing them to
//     threads, so the 32 pairs of a warp take about as many steps (a warp
//     runs as long as its longest pair; ordering by the longer length, which
//     evens out the compares per step instead, ran clearly slower, PERF.md);
//   * each thread holds the longer string in registers (8W words of four
//     characters for uint8, one register a position for 32-bit
//     codepoints); every loop over them is unrolled, so no array is
//     indexed at run time;
//   * greedy step for character i of the shorter string: match = the SWAR
//     compare of a[i] against the packed longer string, elig = match &
//     window(i) & ~used, first = elig & -elig claims the lowest free
//     in-window position. The window mask is built with 64-bit shifts, so
//     a window reaching bit 32 and a window of 0 are exact (for W = 2 the
//     band is shifted by i - window either way, so nothing leaves 64 bits);
//   * the transpositions walk the two matched sets with __ffs, reading the
//     characters from the staged tiles; the common prefix is a word-wise
//     compare of the two rows and __ffs of the first difference.
//
// Masked launch: with a (B,) bool mask, the result is where(mask, jw, 0).
// Each block reads its slice of the mask with coalesced loads, writes the
// zeros of its masked-out rows, and compacts the indices of its survivors
// in shared memory (__ballot_sync / __popc, in row order). A block without
// survivors returns; the others stage only their survivors' rows and run
// the body above on them. The two-phase gamma path launches this once per
// batch over the whole batch, so no host wait, gather or scatter is needed
// around it.
//
// Columns wider than 64 take the generic form: the sets used (of b) and
// matched (of a) are W = ceil(width / 32) words each in the caller's
// scratch, characters are read from global memory, and a masked-out pair
// writes 0 and returns. Both forms find the same lowest free in-window
// match and walk the matched positions of both sides in order, so they
// agree bit for bit.
//
// Numerics: Jaro-Winkler must be bit-identical to the reference's f32
// expression, so every float operation is an explicit round-to-nearest
// intrinsic in the reference's order, and the library is built with
// -fmad=false as well so nothing contracts into an FMA.
//
// Build (nvcc, plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -std=c++17
//        -shared -Xcompiler -fPIC -o libsplink_jaro_winkler.so jaro_winkler.cu

#include "common.cuh"

namespace splink {
namespace {

// (m/l1 + m/l2 + (m - t)/m) / 3, then jaro + ell*scale*(1 - jaro), in the
// reference's order of operations
__device__ __forceinline__ float jw_value(int m, int mismatched, int ell, int l1, int l2,
                                          int lb, float prefix_scale,
                                          float boost_threshold) {
  float jaro = 0.0f;
  if (m > 0) {
    const float mf = static_cast<float>(m);
    const float t = static_cast<float>(mismatched / 2);  // integer halving
    const float s = __fadd_rn(__fadd_rn(__fdiv_rn(mf, static_cast<float>(l1)),
                                        __fdiv_rn(mf, static_cast<float>(l2))),
                              __fdiv_rn(__fsub_rn(mf, t), mf));
    jaro = __fdiv_rn(s, 3.0f);
  }
  const float scale = fminf(prefix_scale,
                            __fdiv_rn(1.0f, fmaxf(static_cast<float>(lb), 1.0f)));
  const float boosted = __fadd_rn(
      jaro, __fmul_rn(__fmul_rn(static_cast<float>(ell), scale), __fsub_rn(1.0f, jaro)));
  return jaro < boost_threshold ? jaro : boosted;
}

// A pair's set of positions: one 32-bit word for W = 1, 64 bits for W = 2.
template <int W>
struct Bits;
template <>
struct Bits<1> {
  using type = uint32_t;
};
template <>
struct Bits<2> {
  using type = uint64_t;
};

__device__ __forceinline__ int lowest_bit(uint32_t x) { return __ffs(x) - 1; }
__device__ __forceinline__ int lowest_bit(uint64_t x) {
  return __ffsll(static_cast<long long>(x)) - 1;
}
__device__ __forceinline__ int bit_count(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int bit_count(uint64_t x) { return __popcll(x); }

// Jaro-Winkler of one staged pair, width <= 32 W, with the jar
// (commons-text) semantics of splink_tpu/ops/strings.py:
// jaro_winkler_bitmask_single. The pair's rows start `off` bytes into the
// tiles t1 (s1) and t2 (s2); `ta` is the shorter side's tile, `pat` the
// longer side in registers, compared over all groups of four positions of
// its words but the last and the first NG of the last (the warp's longest
// reaches no further). la <= lb are the lengths clamped to [0, width];
// l1, l2 the pair's own.
template <typename T, int W, int NG>
__device__ __forceinline__ float jw_pair(const Pattern<T, W>& pat, const unsigned char* ta,
                                         const unsigned char* tb, const unsigned char* t1,
                                         const unsigned char* t2, int off, int la, int lb,
                                         int l1, int l2, float prefix_scale,
                                         float boost_threshold) {
  using Set = typename Bits<W>::type;
  const int window = max(lb / 2 - 1, 0);
  const Set in_b = static_cast<Set>(lb >= 64 ? ~0ull : (1ull << lb) - 1ull);  // positions < lb
  // 2 * window + 1 bits (at most 63), placed at [i - window, i + window]:
  // for W = 1 shifted left by i and right by window (at most bit 46, so 64
  // bits never overflow); for W = 2 shifted by i - window one way or the
  // other
  const uint64_t band = (1ull << (2 * window + 1)) - 1ull;

  // greedy pass: a[i] claims the lowest unused in-window j with b[j] == a[i]
  Set used = 0u;     // matched positions of b
  Set matched = 0u;  // matched positions of a
  auto step = [&](int i, uint32_t x) {
    Set win;
    Set match;
    if constexpr (W == 1) {
      win = static_cast<Set>((band << i) >> window) & in_b;
      match = pat.template eq<NG>(0, x);
    } else {
      win = static_cast<Set>(i >= window ? band << (i - window) : band >> (window - i)) & in_b;
      match = static_cast<Set>(pat.template eq<8>(0, x)) |
              (static_cast<Set>(pat.template eq<NG>(1, x)) << 32);
    }
    const Set elig = match & win & ~used;
    const Set first = elig & (Set(0) - elig);
    used |= first;
    matched |= static_cast<Set>(first != 0u) << i;
  };
  if constexpr (sizeof(T) == 1) {
    for (int i = 0; i < la; i += 4) {
      const uint32_t four = load_word(ta, off + i);
#pragma unroll
      for (int k = 0; k < 4; ++k)  // byte k of `four` broadcast to all four bytes
        if (i + k < la) step(i + k, __byte_perm(four, 0u, 0x1111u * k));
    }
  } else {
    const uint32_t* tx = reinterpret_cast<const uint32_t*>(ta + off);
    for (int i = 0; i < la; ++i) step(i, tx[i]);
  }
  const int m = bit_count(matched);

  // transpositions: the k-th matched char of a against the k-th of b
  const T* a = reinterpret_cast<const T*>(ta + off);
  const T* b = reinterpret_cast<const T*>(tb + off);
  int mismatched = 0;
  Set ra = matched;
  Set rb = used;
  while (ra) {
    mismatched += a[lowest_bit(ra)] != b[lowest_bit(rb)];
    ra &= ra - 1u;
    rb &= rb - 1u;
  }

  // common-prefix run of s1 and s2, uncapped, at most la: the first
  // differing position, a word at a time
  int ell = la;
  if constexpr (sizeof(T) == 1) {
    for (int k = 0; k < la; k += 4) {
      const uint32_t x = load_word(t1, off + k) ^ load_word(t2, off + k);
      if (x) {
        ell = min(la, k + ((__ffs(x) - 1) >> 3));
        break;
      }
    }
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(t1 + off);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(t2 + off);
    for (int k = 0; k < la; ++k) {
      if (p[k] != q[k]) {
        ell = k;
        break;
      }
    }
  }

  return jw_value(m, mismatched, ell, l1, l2, lb, prefix_scale, boost_threshold);
}

// Shared memory of a block: the two tiles (each with slack, 16-byte
// aligned); per slot (a survivor, in row order) both lengths, its row in
// the block and its place in the order; the counting sort's histogram over
// the shorter length 0..width; per 32 rows the survivor count, then their
// total.
struct Layout {
  int tile, len1, len2, rowid, order, hist, counts, bytes;
  __host__ __device__ Layout(int threads, int rowbytes, int width) {
    const int rows = kRows * threads;
    tile = (rows * rowbytes + kSlack + 15) & ~15;
    len1 = 2 * tile;
    len2 = len1 + 4 * rows;
    rowid = len2 + 4 * rows;
    order = rowid + 4 * rows;
    hist = order + 4 * rows;
    counts = hist + 4 * (width + 1);
    bytes = counts + 4 * (rows / 32 + 1);
  }
};

// Width <= 32 W (W = 1, 2). `mask` is null for the dense launch.
template <typename T, int W>
__global__ void jaro_winkler_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                                    const int32_t* __restrict__ l1p,
                                    const int32_t* __restrict__ l2p,
                                    const bool* __restrict__ mask, int64_t n, int width,
                                    float prefix_scale, float boost_threshold,
                                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowbytes = width * static_cast<int>(sizeof(T));
  const Layout lay(blockDim.x, rowbytes, width);
  unsigned char* t1 = smem;
  unsigned char* t2 = smem + lay.tile;
  int* len1 = reinterpret_cast<int*>(smem + lay.len1);
  int* len2 = reinterpret_cast<int*>(smem + lay.len2);
  int* rowid = reinterpret_cast<int*>(smem + lay.rowid);
  int* order = reinterpret_cast<int*>(smem + lay.order);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  int* counts = reinterpret_cast<int*>(smem + lay.counts);
  const int tid = threadIdx.x;
  const int per_block = kRows * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int rows = n - first < per_block ? static_cast<int>(n - first) : per_block;
  const unsigned char* g1 = reinterpret_cast<const unsigned char*>(s1) + first * rowbytes;
  const unsigned char* g2 = reinterpret_cast<const unsigned char*>(s2) + first * rowbytes;
  for (int k = tid; k <= width; k += blockDim.x) hist[k] = 0;

  // the block's slots: its survivors in row order (every row when dense)
  int count = rows;
  if (mask != nullptr) {
    const int lane = tid & 31;
    const int chunks = per_block >> 5;
    bool keep[kRows];
    uint32_t ballot[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r * blockDim.x + tid;
      keep[r] = row < rows && mask[first + row];
      if (row < rows && !keep[r]) out[first + row] = 0.0f;
      ballot[r] = __ballot_sync(0xFFFFFFFFu, keep[r]);
      if (lane == 0) counts[row >> 5] = __popc(ballot[r]);
    }
    __syncthreads();
    if (tid < 32) {  // exclusive scan of the per-32-row counts; the total last
      const int c = tid < chunks ? counts[tid] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (tid >= d) incl += v;
      }
      if (tid < chunks) counts[tid] = incl - c;
      if (tid == 31) counts[chunks] = incl;
    }
    __syncthreads();
    count = counts[chunks];
    if (count == 0) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r * blockDim.x + tid;
      if (keep[r]) rowid[counts[row >> 5] + __popc(ballot[r] & ((1u << lane) - 1u))] = row;
    }
    __syncthreads();
    stage_rows(t1, g1, rowid, count, rowbytes);
    stage_rows(t2, g2, rowid, count, rowbytes);
  } else {
    stage_tile(t1, g1, rows * rowbytes);
    stage_tile(t2, g2, rows * rowbytes);
    __syncthreads();  // the histogram is zeroed
  }

  // each slot's lengths (while the tiles are copied); the shorter length
  // orders the slots
  int key[kRows];
  int rank[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int slot = r * blockDim.x + tid;
    key[r] = 0;
    rank[r] = 0;
    if (slot < count) {
      const int64_t row = first + (mask != nullptr ? rowid[slot] : slot);
      const int a = l1p[row];
      const int b = l2p[row];
      len1[slot] = a;
      len2[slot] = b;
      key[r] = min(max(min(a, b), 0), width);
      rank[r] = atomicAdd(&hist[key[r]], 1);
    }
  }
  __syncthreads();
  exclusive_scan_bins(hist, width + 1);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int slot = r * blockDim.x + tid;
    if (slot < count) order[hist[key[r]] + rank[r]] = slot;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int r = 0; r < kRows; ++r) {
    if (r * static_cast<int>(blockDim.x) >= count) break;  // uniform across the block
    // this thread's pair: the (r * blockDim.x + tid)-th by shorter length
    const int k = r * blockDim.x + tid;
    const int slot = k < count ? order[k] : -1;
    const int l1 = slot >= 0 ? len1[slot] : 0;
    const int l2 = slot >= 0 ? len2[slot] : 0;
    // the shorter string is iterated over the longer (jar matches());
    // lengths never exceed the width the encoder pads to, the clamp only
    // keeps a malformed input inside the row
    const bool swap = l1 > l2;
    const int la = min(max(swap ? l2 : l1, 0), width);
    const int lb = min(max(swap ? l1 : l2, 0), width);
    const int span =
        static_cast<int>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(lb)));
    const int off = max(slot, 0) * rowbytes;
    const unsigned char* ta = swap ? t2 : t1;
    const unsigned char* tb = swap ? t1 : t2;
    Pattern<T, W> pat;
    pat.load(tb, off, span);
    float v;
#define SPLINK_JW_PAIR(NG) \
  jw_pair<T, W, NG>(pat, ta, tb, t1, t2, off, la, lb, l1, l2, prefix_scale, boost_threshold)
    // the groups of four of the last word that the warp's longest reaches
    switch (max(span - 32 * (W - 1) + 3, 0) >> 2) {
      case 0:
      case 1: v = SPLINK_JW_PAIR(1); break;
      case 2: v = SPLINK_JW_PAIR(2); break;
      case 3: v = SPLINK_JW_PAIR(3); break;
      case 4: v = SPLINK_JW_PAIR(4); break;
      case 5: v = SPLINK_JW_PAIR(5); break;
      case 6: v = SPLINK_JW_PAIR(6); break;
      case 7: v = SPLINK_JW_PAIR(7); break;
      default: v = SPLINK_JW_PAIR(8);
    }
#undef SPLINK_JW_PAIR
    if (slot >= 0) out[first + (mask != nullptr ? rowid[slot] : slot)] = v;
  }
}

// The same function for any width: the characters are read in place from
// global memory and the sets used (of b) and matched (of a) are W =
// ceil(width / 32) words each in the caller's scratch, 2 * W * n uint32,
// word k of pair p's used set at k * n + p and of its matched set at
// (W + k) * n + p, so a warp's accesses to one word are contiguous.
template <typename T>
__global__ void jaro_winkler_wide_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                                         const int32_t* __restrict__ l1p,
                                         const int32_t* __restrict__ l2p,
                                         const bool* __restrict__ mask, int64_t n,
                                         int width, uint32_t* __restrict__ scratch,
                                         float prefix_scale, float boost_threshold,
                                         float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  if (mask != nullptr && !mask[p]) {
    out[p] = 0.0f;
    return;
  }
  const int l1 = l1p[p];
  const int l2 = l2p[p];
  const bool swap = l1 > l2;
  const int la = min(swap ? l2 : l1, width);
  const int lb = min(swap ? l1 : l2, width);
  const T* a = swap ? s2 + p * width : s1 + p * width;
  const T* b = swap ? s1 + p * width : s2 + p * width;
  const int window = max(lb / 2 - 1, 0);
  const int words = (width + 31) >> 5;
  uint32_t* used = scratch + p;
  uint32_t* matched = scratch + static_cast<int64_t>(words) * n + p;
  for (int k = 0; k < words; ++k) used[k * n] = matched[k * n] = 0u;

  // greedy pass: a[i] claims the lowest unused in-window j with b[j] == a[i]
  int m = 0;
  for (int i = 0; i < la; ++i) {
    const int lo = max(i - window, 0);
    const int hi = min(i + window + 1, lb);
    const T ai = a[i];
    for (int j = lo; j < hi; ++j) {
      const uint32_t bit = 1u << (j & 31);
      if (b[j] == ai && !(used[(j >> 5) * n] & bit)) {
        used[(j >> 5) * n] |= bit;
        matched[(i >> 5) * n] |= 1u << (i & 31);
        ++m;
        break;
      }
    }
  }

  // transpositions: the k-th matched char of a against the k-th of b,
  // walking both sets word by word in order
  int mismatched = 0;
  int ka = 0;
  int kb = 0;
  uint32_t ra = matched[0];
  uint32_t rb = used[0];
  for (int r = 0; r < m; ++r) {
    while (ra == 0u) ra = matched[++ka * n];
    while (rb == 0u) rb = used[++kb * n];
    mismatched += a[32 * ka + __ffs(ra) - 1] != b[32 * kb + __ffs(rb) - 1];
    ra &= ra - 1u;
    rb &= rb - 1u;
  }

  int ell = 0;
  while (ell < la && a[ell] == b[ell]) ++ell;

  out[p] = jw_value(m, mismatched, ell, l1, l2, lb, prefix_scale, boost_threshold);
}

template <typename T, int W>
int launch_words(const T* a, const T* b, const int32_t* la, const int32_t* lb, const bool* mk,
                 int64_t n, int width, float prefix_scale, float boost_threshold, float* o,
                 cudaStream_t stream) {
  const int rowbytes = width * static_cast<int>(sizeof(T));
  const int threads = threads_for(rowbytes);
  const int smem = Layout(threads, rowbytes, width).bytes;
  auto kernel = jaro_winkler_kernel<T, W>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid_for(n, kRows * threads), threads, smem, stream>>>(
      a, b, la, lb, mk, n, width, prefix_scale, boost_threshold, o);
  return 0;
}

template <typename T>
int launch(const void* s1, const void* s2, const void* l1, const void* l2, const void* mask,
           int64_t n, int width, int words, void* scratch, float prefix_scale,
           float boost_threshold, void* out, cudaStream_t stream) {
  const T* a = static_cast<const T*>(s1);
  const T* b = static_cast<const T*>(s2);
  const int32_t* la = static_cast<const int32_t*>(l1);
  const int32_t* lb = static_cast<const int32_t*>(l2);
  const bool* mk = static_cast<const bool*>(mask);
  float* o = static_cast<float*>(out);
  switch (words) {
    case 1:
      return launch_words<T, 1>(a, b, la, lb, mk, n, width, prefix_scale, boost_threshold, o,
                                stream);
    case 2:
      return launch_words<T, 2>(a, b, la, lb, mk, n, width, prefix_scale, boost_threshold, o,
                                stream);
    default:
      jaro_winkler_wide_kernel<T><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
          a, b, la, lb, mk, n, width, static_cast<uint32_t*>(scratch), prefix_scale,
          boost_threshold, o);
      return 0;
  }
}

}  // namespace
}  // namespace splink

extern "C" {

// s1, s2: (n, width) characters of `elem_bytes` bytes (1: uint8, 4: 32-bit
// codepoints); l1, l2: (n,) int32; mask: (n,) bool, or null for every
// pair; out: (n,) float32, 0 where the mask is false. `words` is the
// variant: 1 or 2 with 32 * words >= width, or 0 for the generic form,
// which needs `scratch` of 2 * ceil(width / 32) * n uint32.
int splink_jaro_winkler(const void* s1, const void* s2, const void* l1, const void* l2,
                        int64_t n, int width, int elem_bytes, int words, void* scratch,
                        float prefix_scale, float boost_threshold, const void* mask,
                        void* out, void* stream) {
  if (words < 0 || words > 2 || (words > 0 && 32 * words < width) || width < 1 ||
      (elem_bytes != 1 && elem_bytes != 4) || (words == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = elem_bytes == 1
                      ? splink::launch<uint8_t>(s1, s2, l1, l2, mask, n, width, words, scratch,
                                                prefix_scale, boost_threshold, out, st)
                      : splink::launch<uint32_t>(s1, s2, l1, l2, mask, n, width, words,
                                                 scratch, prefix_scale, boost_threshold, out,
                                                 st);
    if (e != 0) return e;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
