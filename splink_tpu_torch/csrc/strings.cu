// Batched string-similarity kernels for Hopper (sm_90a), one pair per thread.
//
// They replace splink_tpu/ops/strings_pallas.py's two TPU kernels:
//   * jaro_winkler_kernel  <- jaro_winkler_pallas (body _jw_kernel)
//   * levenshtein_kernel   <- levenshtein_pallas (body _lev_kernel)
// The TPU kernels lay pairs on the 128 vector lanes and count prefixes with
// triangular matmuls on the MXU. Neither trick applies here: a thread holds
// a whole pair (width <= 32, so every per-pair set is one 32-bit word) and
// runs the bit-parallel scalar algorithm on it.
//
// What bounds them on this card: each pair is about 2L + 8 bytes in and 4
// bytes out, against O(L^2) integer work (Jaro-Winkler's eligibility scan,
// Levenshtein's match-mask build), so both sit on the integer ALUs, not on
// HBM. This first version keeps the strings in per-thread arrays (local
// memory, cached in L1) and reads them straight from global memory; shared
// memory staging and register-resident strings are later work.
//
// Numerics: Jaro-Winkler must be bit-identical to the reference's f32
// expression, so every float operation is an explicit round-to-nearest
// intrinsic in the reference's order, and the library is built with
// -fmad=false as well so nothing contracts into an FMA.
//
// Build (nvcc, plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -o libsplink_strings.so strings.cu
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 32;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void load_row(const T* src, int width, uint32_t* dst) {
#pragma unroll 4
  for (int k = 0; k < width; ++k) dst[k] = static_cast<uint32_t>(src[k]);
}

// Jaro-Winkler with the jar (commons-text) semantics of
// splink_tpu/ops/strings.py:jaro_winkler_bitmask_single.
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

  // (m/l1 + m/l2 + (m - t)/m) / 3, then jaro + ell*scale*(1 - jaro), in the
  // reference's order of operations
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
  out[p] = jaro < boost_threshold ? jaro : boosted;
}

// Levenshtein distance by Myers/Hyyro bit-parallel dynamic programming on
// one 32-bit word: the pattern (s2, l2 <= 32) lies along the bit positions,
// the text (s1) is consumed one character per step, and `score` tracks the
// last row of the DP column. Equal to splink_tpu's row DP
// (ops/strings.py:levenshtein_single) on every input.
template <typename T>
__global__ void levenshtein_kernel(const T* __restrict__ s1,
                                   const T* __restrict__ s2,
                                   const int32_t* __restrict__ l1p,
                                   const int32_t* __restrict__ l2p,
                                   int64_t n, int width,
                                   int32_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int l1 = min(l1p[p], width);
  const int l2 = min(l2p[p], width);
  if (l1 == 0 || l2 == 0) {
    out[p] = l1 + l2;
    return;
  }
  uint32_t pat[kMaxWidth];
  load_row(s2 + p * width, width, pat);
  const T* text = s1 + p * width;
  const uint32_t last = 1u << (l2 - 1);
  uint32_t pv = 0xFFFFFFFFu;  // vertical deltas +1 (D[i][0] = i)
  uint32_t mv = 0u;
  int score = l2;
  for (int i = 0; i < l1; ++i) {
    const uint32_t c = static_cast<uint32_t>(text[i]);
    uint32_t eq = 0u;
    for (int j = 0; j < l2; ++j) eq |= static_cast<uint32_t>(pat[j] == c) << j;
    const uint32_t xv = eq | mv;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    uint32_t ph = mv | ~(xh | pv);
    uint32_t mh = pv & xh;
    if (ph & last) ++score;
    if (mh & last) --score;
    ph = (ph << 1) | 1u;  // top row D[0][j] = j: horizontal delta +1
    mh <<= 1;
    pv = mh | ~(xv | ph);
    mv = ph & xv;
  }
  out[p] = score;
}

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int splink_jaro_winkler_u8(const void* s1, const void* s2, const void* l1,
                           const void* l2, int64_t n, int width,
                           float prefix_scale, float boost_threshold, void* out,
                           void* stream) {
  if (n > 0)
    jaro_winkler_kernel<uint8_t><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)s1, (const uint8_t*)s2, (const int32_t*)l1,
        (const int32_t*)l2, n, width, prefix_scale, boost_threshold, (float*)out);
  return (int)cudaGetLastError();
}

int splink_jaro_winkler_u32(const void* s1, const void* s2, const void* l1,
                            const void* l2, int64_t n, int width,
                            float prefix_scale, float boost_threshold, void* out,
                            void* stream) {
  if (n > 0)
    jaro_winkler_kernel<uint32_t><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)s1, (const uint32_t*)s2, (const int32_t*)l1,
        (const int32_t*)l2, n, width, prefix_scale, boost_threshold, (float*)out);
  return (int)cudaGetLastError();
}

int splink_levenshtein_u8(const void* s1, const void* s2, const void* l1,
                          const void* l2, int64_t n, int width, void* out,
                          void* stream) {
  if (n > 0)
    levenshtein_kernel<uint8_t><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)s1, (const uint8_t*)s2, (const int32_t*)l1,
        (const int32_t*)l2, n, width, (int32_t*)out);
  return (int)cudaGetLastError();
}

int splink_levenshtein_u32(const void* s1, const void* s2, const void* l1,
                           const void* l2, int64_t n, int width, void* out,
                           void* stream) {
  if (n > 0)
    levenshtein_kernel<uint32_t><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)s1, (const uint32_t*)s2, (const int32_t*)l1,
        (const int32_t*)l2, n, width, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
