// Batched Jaro-Winkler for Hopper (sm_90a), one pair per thread.
//
// Replaces splink_tpu/ops/strings_pallas.py:jaro_winkler_pallas (body
// _jw_kernel). The TPU kernel lays pairs on the 128 vector lanes and counts
// prefixes with triangular matmuls on the MXU. Neither trick applies here:
// a thread holds a whole pair and runs the bit-parallel scalar algorithm of
// splink_tpu/ops/strings.py:jaro_winkler_bitmask_single on it, with the
// per-position sets of one pair in W = ceil(L/32) 32-bit words.
//
// What bounds it on this card: each pair is about 2L + 8 bytes in and 4
// bytes out, against O(L^2) integer work (the eligibility scan), so it sits
// on the integer ALUs, not on HBM. This version keeps the strings in
// per-thread arrays (local memory, cached in L1) and reads them straight
// from global memory; its main-path launches are a few thousand two-phase
// survivors, so their time is launch and latency, not arithmetic.
//
// Variants: W = 1 (L <= 32) is the first port's kernel, unchanged: every
// set is one word. Every wider column takes the wide variant, which reads
// the characters from global memory and keeps its 2W set words in the
// caller's scratch; the greedy window may span word boundaries. Both find
// the same lowest free in-window match and walk the matched positions of
// both sides in order, so they agree bit for bit.
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

constexpr int kMaxWidth = 32;

template <typename T>
__device__ __forceinline__ void load_row(const T* src, int width, uint32_t* dst) {
#pragma unroll 4
  for (int k = 0; k < width; ++k) dst[k] = static_cast<uint32_t>(src[k]);
}

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

// Jaro-Winkler with the jar (commons-text) semantics of
// splink_tpu/ops/strings.py:jaro_winkler_bitmask_single, width <= 32.
template <typename T>
__global__ void jaro_winkler_kernel(const T* __restrict__ s1,
                                    const T* __restrict__ s2,
                                    const int32_t* __restrict__ l1p,
                                    const int32_t* __restrict__ l2p,
                                    int64_t n, int width, float prefix_scale,
                                    float boost_threshold,
                                    float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int l1 = l1p[p];
  const int l2 = l2p[p];
  // the shorter string is iterated over the longer (jar matches())
  const bool swap = l1 > l2;
  // lengths never exceed the width the encoder pads to; the clamp only
  // keeps a malformed input inside the row
  const int la = min(swap ? l2 : l1, width);
  const int lb = min(swap ? l1 : l2, width);
  uint32_t a[kMaxWidth];
  uint32_t b[kMaxWidth];
  load_row(swap ? s2 + p * width : s1 + p * width, width, a);
  load_row(swap ? s1 + p * width : s2 + p * width, width, b);
  const int window = max(lb / 2 - 1, 0);

  // greedy pass: a[i] claims the lowest unused in-window j with b[j] == a[i]
  uint32_t used = 0u;     // matched positions of b
  uint32_t matched = 0u;  // matched positions of a
  for (int i = 0; i < la; ++i) {
    const int lo = max(i - window, 0);
    const int hi = min(i + window + 1, lb);
    uint32_t elig = 0u;
    for (int j = lo; j < hi; ++j) elig |= static_cast<uint32_t>(b[j] == a[i]) << j;
    const uint32_t avail = elig & ~used;
    const uint32_t first = avail & (0u - avail);
    used |= first;
    matched |= static_cast<uint32_t>(first != 0u) << i;
  }
  const int m = __popc(matched);

  // transpositions: the k-th matched char of a against the k-th of b
  int mismatched = 0;
  uint32_t ra = matched;
  uint32_t rb = used;
  while (ra) {
    const int i = __ffs(ra) - 1;
    const int j = __ffs(rb) - 1;
    mismatched += a[i] != b[j];
    ra &= ra - 1u;
    rb &= rb - 1u;
  }

  // common-prefix run, uncapped (a/b is a swap of s1/s2 at equal positions)
  int ell = 0;
  while (ell < la && a[ell] == b[ell]) ++ell;

  out[p] = jw_value(m, mismatched, ell, l1, l2, lb, prefix_scale, boost_threshold);
}

// The same function for any width: the characters are read in place from
// global memory and the sets used (of b) and matched (of a) are W =
// ceil(width / 32) words each in the caller's scratch, 2 * W * n uint32,
// word k of pair p's used set at k * n + p and of its matched set at
// (W + k) * n + p, so a warp's accesses to one word are contiguous.
template <typename T>
__global__ void jaro_winkler_wide_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                                         const int32_t* __restrict__ l1p,
                                         const int32_t* __restrict__ l2p, int64_t n,
                                         int width, uint32_t* __restrict__ scratch,
                                         float prefix_scale, float boost_threshold,
                                         float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
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

template <typename T>
void launch(const void* s1, const void* s2, const void* l1, const void* l2, int64_t n,
            int width, int words, void* scratch, float prefix_scale, float boost_threshold,
            void* out, cudaStream_t stream) {
  const T* a = static_cast<const T*>(s1);
  const T* b = static_cast<const T*>(s2);
  const int32_t* la = static_cast<const int32_t*>(l1);
  const int32_t* lb = static_cast<const int32_t*>(l2);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  float* o = static_cast<float*>(out);
  const unsigned grid = grid_for(n, kThreads);
  if (words == 1)
    jaro_winkler_kernel<T><<<grid, kThreads, 0, stream>>>(a, b, la, lb, n, width,
                                                         prefix_scale, boost_threshold, o);
  else
    jaro_winkler_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
        a, b, la, lb, n, width, sc, prefix_scale, boost_threshold, o);
}

}  // namespace
}  // namespace splink

extern "C" {

// s1, s2: (n, width) characters of `elem_bytes` bytes (1: uint8, 4: 32-bit
// codepoints); l1, l2: (n,) int32; out: (n,) float32. `words` is the
// variant: 1 for width <= 32, or 0 for the wide form, which needs
// `scratch` of 2 * ceil(width / 32) * n uint32.
int splink_jaro_winkler(const void* s1, const void* s2, const void* l1, const void* l2,
                        int64_t n, int width, int elem_bytes, int words, void* scratch,
                        float prefix_scale, float boost_threshold, void* out, void* stream) {
  if ((words != 0 && words != 1) || (words == 1 && width > 32) || width < 1 ||
      (elem_bytes != 1 && elem_bytes != 4) || (words == 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (elem_bytes == 1)
      splink::launch<uint8_t>(s1, s2, l1, l2, n, width, words, scratch, prefix_scale,
                              boost_threshold, out, st);
    else
      splink::launch<uint32_t>(s1, s2, l1, l2, n, width, words, scratch, prefix_scale,
                               boost_threshold, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
