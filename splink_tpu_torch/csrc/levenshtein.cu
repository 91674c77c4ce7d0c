// Batched Levenshtein distance for Hopper (sm_90a), one pair per thread.
//
// Replaces splink_tpu/ops/strings_pallas.py:levenshtein_pallas (body
// _lev_kernel), which lays pairs on the TPU's vector lanes and runs the row
// DP with a prefix-min insertion chain. Here each thread runs the
// Myers/Hyyro bit-parallel DP on a pair: the longer string (the pattern)
// lies along the bits of W 32-bit words, the shorter (the text) is consumed
// one character per step, and each step advances the words in order,
// carrying the horizontal delta from word to word (Hyyro's blocked form).
// After the last step the distance is the text's length plus the vertical
// deltas of the pattern's rows, two popcounts a word. The result equals
// splink_tpu's row DP (ops/strings.py:levenshtein_single) on every input:
// distance is symmetric, so which side is the pattern does not change it.
//
// What bounds it on this card: a pair is 2L bytes of characters, 8 bytes of
// lengths and 4 bytes out, against about l_text * (ceil(l_pat / 4) SWAR
// compares + 15 * ceil(l_pat / 32) word operations) of integer work, so at
// the widths of real columns (L = 16..32) HBM bounds it if the integer work
// stays in registers and no lane of a warp idles. What the design does:
//
//   * the block's rows (two pairs per thread) of s1 and of s2 are two
//     contiguous tiles; both are staged into shared memory with coalesced
//     16-byte cp.async copies while the lengths go to registers;
//   * the block then orders its pairs by text length (a counting sort in
//     shared memory) and hands them to threads in that order, so the 32
//     pairs of a warp take about as many steps and compare about as many
//     characters as each other: a warp runs as long as its longest pair;
//   * each pair's pattern is held in registers: W is a template parameter
//     and every loop over words is unrolled, so no array is indexed at run
//     time (ptxas reports a 0-byte stack frame for the uint8 variants);
//   * for uint8 the match mask of a text character is built four pattern
//     characters at a time: XOR with the broadcast character, an exact
//     zero-byte test, and one multiply that gathers the four byte flags
//     into four adjacent bits. The 32-bit codepoint variant compares per
//     position, from registers (from the stack for W = 8). A one-word step
//     compares only the groups of four characters that the warp's longest
//     pattern reaches, a count fixed at compile time per warp, so no guard
//     runs per step.
//
// Within a block the loads and the DP do not overlap; PERF.md has what
// that costs against the bound.
//
// Columns wider than 256 take the generic variant: W at run time, the
// words of each pair in the caller's scratch, characters read from global
// memory, no staging or ordering. No width is refused.
//
// Build (nvcc, plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libsplink_levenshtein.so levenshtein.cu

#include "common.cuh"

namespace splink {
namespace {

// One word of the blocked Myers/Hyyro step (the form of Hyyro 2003 that
// edlib implements): advances the vertical deltas (pv, mv) of 32 pattern
// rows by one text column, given the match mask `eq` and the horizontal
// delta `hin` (-1, 0, +1) entering the word's top row. Returns the
// horizontal delta leaving its bottom row (bit 31), for the next word.
__device__ __forceinline__ int advance(uint32_t& pv, uint32_t& mv, uint32_t eq, int hin) {
  const uint32_t hneg = hin < 0 ? 1u : 0u;
  const uint32_t xv = eq | mv;
  eq |= hneg;
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint32_t ph = mv | ~(xh | pv);
  uint32_t mh = pv & xh;
  const int hout = static_cast<int>(ph >> 31) - static_cast<int>(mh >> 31);
  ph = (ph << 1) | (hin > 0 ? 1u : 0u);
  mh = (mh << 1) | hneg;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  return hout;
}

// Bits 0 .. (lp - 1) - 32w of word w: the pattern's rows in that word.
__device__ __forceinline__ uint32_t rows_of_word(int w, int lp) {
  const int k = lp - 32 * w;
  return k >= 32 ? 0xFFFFFFFFu : (k <= 0 ? 0u : (1u << k) - 1u);
}

// Distance of one pair: the text (lt characters at `off` in `text`)
// through the pattern (lp characters, in registers). Words up to the
// warp's longest pattern `span` are advanced (uniform across the warp);
// x is the text character, broadcast to four bytes for uint8.
template <typename T, int W, int NG>
__device__ __forceinline__ int distance(const Pattern<T, W>& pat, const unsigned char* text,
                                        int off, int lt, int lp, int span) {
  uint32_t pv[W];
  uint32_t mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = 0xFFFFFFFFu;  // D[j][0] = j: vertical deltas +1
    mv[w] = 0u;
  }
  auto step = [&](uint32_t x) {
    int h = 1;  // top row D[0][i] = i: the delta entering word 0 is +1
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (32 * w < span) h = advance(pv[w], mv[w], pat.template eq<NG>(w, x), h);
  };
  if constexpr (sizeof(T) == 1) {
    for (int i = 0; i < lt; i += 4) {
      const uint32_t four = load_word(text, off + i);
#pragma unroll
      for (int k = 0; k < 4; ++k)  // byte k of `four` broadcast to all four bytes
        if (i + k < lt) step(__byte_perm(four, 0u, 0x1111u * k));
    }
  } else {
    const uint32_t* tx = reinterpret_cast<const uint32_t*>(text + off);
    for (int i = 0; i < lt; ++i) step(tx[i]);
  }
  // D[lp][lt] = D[0][lt] + the vertical deltas of rows 1..lp
  int score = lt;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t rows = rows_of_word(w, lp);
    score += __popc(pv[w] & rows) - __popc(mv[w] & rows);
  }
  return score;
}

// Shared memory of a block: the two tiles (each with slack, 16-byte
// aligned), then per row its packed lengths and its place in the order,
// then the counting sort's histogram over text lengths 0..width.
struct Layout {
  int tile, info, order, hist, bytes;
  __host__ __device__ Layout(int threads, int rowbytes, int width) {
    tile = (kRows * threads * rowbytes + kSlack + 15) & ~15;
    info = 2 * tile;
    order = info + 4 * kRows * threads;
    hist = order + 4 * kRows * threads;
    bytes = hist + 4 * (width + 1);
  }
};

template <typename T, int W>
__global__ void levenshtein_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                                   const int32_t* __restrict__ l1p,
                                   const int32_t* __restrict__ l2p, int64_t n, int width,
                                   int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowbytes = width * static_cast<int>(sizeof(T));
  const Layout lay(blockDim.x, rowbytes, width);
  unsigned char* t1 = smem;
  unsigned char* t2 = smem + lay.tile;
  int* info = reinterpret_cast<int*>(smem + lay.info);
  int* order = reinterpret_cast<int*>(smem + lay.order);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  const int tid = threadIdx.x;
  const int per_block = kRows * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_block;
  const int rows = n - first < per_block ? static_cast<int>(n - first) : per_block;
  // the lengths go to registers while the tiles are copied
  int l1[kRows];
  int l2[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * blockDim.x + tid;
    l1[r] = row < rows ? min(l1p[first + row], width) : 0;
    l2[r] = row < rows ? min(l2p[first + row], width) : 0;
  }
  stage_tile(t1, reinterpret_cast<const unsigned char*>(s1) + first * rowbytes, rows * rowbytes);
  stage_tile(t2, reinterpret_cast<const unsigned char*>(s2) + first * rowbytes, rows * rowbytes);
  for (int k = tid; k <= width; k += blockDim.x) hist[k] = 0;
  __syncthreads();

  // each row's lengths; the longer string is the pattern, so the shorter
  // one (the text) sets the number of steps
  int lt[kRows];
  int rank[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * blockDim.x + tid;
    const bool swap = l1[r] > l2[r];
    lt[r] = swap ? l2[r] : l1[r];
    rank[r] = 0;
    if (row < rows) {
      info[row] = lt[r] | ((swap ? l1[r] : l2[r]) << 10) | (swap ? 1 << 20 : 0);
      rank[r] = atomicAdd(&hist[lt[r]], 1);
    }
  }
  __syncthreads();
  exclusive_scan_bins(hist, width + 1);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * blockDim.x + tid;
    if (row < rows) order[hist[lt[r]] + rank[r]] = row;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int r = 0; r < kRows; ++r) {
    // this thread's pair: the (r * blockDim.x + tid)-th shortest text
    const int slot = r * blockDim.x + tid;
    const int q = slot < rows ? order[slot] : -1;
    const int packed = q >= 0 ? info[q] : 0;
    const int ltq = packed & 0x3FF;
    const int lp = (packed >> 10) & 0x3FF;
    const bool swap = (packed >> 20) & 1;
    const int span =
        static_cast<int>(__reduce_max_sync(0xFFFFFFFFu, static_cast<unsigned>(lp)));
    const int off = max(q, 0) * rowbytes;
    Pattern<T, W> pat;
    pat.load(swap ? t1 : t2, off, span);
    const unsigned char* text = swap ? t2 : t1;

    // one word: compare only the groups of four that the warp's longest
    // pattern reaches; more words: every group of each word up to `span`
    int score;
    if constexpr (W == 1) {
      switch ((span + 3) >> 2) {
        case 0:
        case 1: score = distance<T, 1, 1>(pat, text, off, ltq, lp, span); break;
        case 2: score = distance<T, 1, 2>(pat, text, off, ltq, lp, span); break;
        case 3: score = distance<T, 1, 3>(pat, text, off, ltq, lp, span); break;
        case 4: score = distance<T, 1, 4>(pat, text, off, ltq, lp, span); break;
        case 5: score = distance<T, 1, 5>(pat, text, off, ltq, lp, span); break;
        case 6: score = distance<T, 1, 6>(pat, text, off, ltq, lp, span); break;
        case 7: score = distance<T, 1, 7>(pat, text, off, ltq, lp, span); break;
        default: score = distance<T, 1, 8>(pat, text, off, ltq, lp, span);
      }
    } else {
      score = distance<T, W, 8>(pat, text, off, ltq, lp, span);
    }
    if (q >= 0) out[first + q] = score;
  }
}

// Any width: W = ceil(width / 32) at run time, vertical deltas in scratch
// (pv words at k * n + p, mv words at (W + k) * n + p), characters read
// from global memory.
template <typename T>
__global__ void levenshtein_generic_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                                           const int32_t* __restrict__ l1p,
                                           const int32_t* __restrict__ l2p, int64_t n,
                                           int width, uint32_t* __restrict__ scratch,
                                           int32_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int l1 = min(l1p[p], width);
  const int l2 = min(l2p[p], width);
  const bool swap = l1 > l2;
  const int lt = swap ? l2 : l1;
  const int lp = swap ? l1 : l2;
  const T* text = (swap ? s2 : s1) + p * width;
  const T* pat = (swap ? s1 : s2) + p * width;
  const int words = (width + 31) >> 5;
  const int nw = (lp + 31) >> 5;
  uint32_t* pvs = scratch + p;
  uint32_t* mvs = scratch + static_cast<int64_t>(words) * n + p;
  for (int w = 0; w < nw; ++w) {
    pvs[w * n] = 0xFFFFFFFFu;
    mvs[w * n] = 0u;
  }
  for (int i = 0; i < lt; ++i) {
    const uint32_t c = static_cast<uint32_t>(text[i]);
    int h = 1;
    for (int w = 0; w < nw; ++w) {
      uint32_t eq = 0u;
      const int hi = min(32, lp - 32 * w);
      for (int k = 0; k < hi; ++k) eq |= static_cast<uint32_t>(pat[32 * w + k] == c) << k;
      uint32_t pv = pvs[w * n];
      uint32_t mv = mvs[w * n];
      h = advance(pv, mv, eq, h);
      pvs[w * n] = pv;
      mvs[w * n] = mv;
    }
  }
  int score = lt;
  for (int w = 0; w < nw; ++w) {
    const uint32_t rows = rows_of_word(w, lp);
    score += __popc(pvs[w * n] & rows) - __popc(mvs[w * n] & rows);
  }
  out[p] = score;
}

template <typename T, int W>
int launch_words(const void* s1, const void* s2, const void* l1, const void* l2, int64_t n,
                 int width, void* out, cudaStream_t stream) {
  const int rowbytes = width * static_cast<int>(sizeof(T));
  const int threads = threads_for(rowbytes);
  const int smem = Layout(threads, rowbytes, width).bytes;
  auto kernel = levenshtein_kernel<T, W>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid_for(n, kRows * threads), threads, smem, stream>>>(
      static_cast<const T*>(s1), static_cast<const T*>(s2), static_cast<const int32_t*>(l1),
      static_cast<const int32_t*>(l2), n, width, static_cast<int32_t*>(out));
  return 0;
}

// The compiled word-count variants; 0 is the generic one.
inline bool known_variant(int words) {
  return words == 0 || words == 1 || words == 2 || words == 4 || words == 8;
}

template <typename T>
int launch(const void* s1, const void* s2, const void* l1, const void* l2, int64_t n,
           int width, int words, void* scratch, void* out, cudaStream_t stream) {
  switch (words) {
    case 1: return launch_words<T, 1>(s1, s2, l1, l2, n, width, out, stream);
    case 2: return launch_words<T, 2>(s1, s2, l1, l2, n, width, out, stream);
    case 4: return launch_words<T, 4>(s1, s2, l1, l2, n, width, out, stream);
    case 8: return launch_words<T, 8>(s1, s2, l1, l2, n, width, out, stream);
    default:
      levenshtein_generic_kernel<T><<<grid_for(n, kThreads), kThreads, 0, stream>>>(
          static_cast<const T*>(s1), static_cast<const T*>(s2),
          static_cast<const int32_t*>(l1), static_cast<const int32_t*>(l2), n, width,
          static_cast<uint32_t*>(scratch), static_cast<int32_t*>(out));
      return 0;
  }
}

}  // namespace
}  // namespace splink

extern "C" {

// s1, s2: (n, width) characters of `elem_bytes` bytes (1: uint8, 4: 32-bit
// codepoints); l1, l2: (n,) int32; out: (n,) int32. `words` is the variant:
// 1, 2, 4 or 8 with 32 * words >= width, or 0 for the generic form, which
// needs `scratch` of 2 * ceil(width / 32) * n uint32.
int splink_levenshtein(const void* s1, const void* s2, const void* l1, const void* l2,
                       int64_t n, int width, int elem_bytes, int words, void* scratch,
                       void* out, void* stream) {
  if (!splink::known_variant(words) || (words > 0 && 32 * words < width) || width < 1 ||
      (elem_bytes != 1 && elem_bytes != 4) || (words == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = elem_bytes == 1
                      ? splink::launch<uint8_t>(s1, s2, l1, l2, n, width, words, scratch, out, st)
                      : splink::launch<uint32_t>(s1, s2, l1, l2, n, width, words, scratch, out, st);
    if (e != 0) return e;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
