// Host-side native kernels for splink_tpu_torch.
//
// A copy of splink_tpu/native/src/host_kernels.cpp, code unchanged. The GPU
// does the per-pair math; these cover the irregular host work that Python
// loops handle too slowly at the 10M-100M row scale: fixed-width string
// encoding and blocked pair emission.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Built by g++ at first use (splink_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// encode_fixed_width: pack UTF-8 rows into a zero-padded (n, width) uint8
// matrix plus int32 lengths. Rows are given as one contiguous byte buffer
// with (n+1) int64 offsets (Arrow-style). Truncates at `width` bytes.
// Intended for ASCII columns (the common case); non-ASCII columns go through
// the Python codepoint path.
void encode_fixed_width(const uint8_t* data, const int64_t* offsets,
                        int64_t n_rows, int64_t width,
                        uint8_t* out_bytes, int32_t* out_lens) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t start = offsets[i];
    const int64_t len = std::min(offsets[i + 1] - start, width);
    uint8_t* dst = out_bytes + i * width;
    std::memcpy(dst, data + start, static_cast<size_t>(len));
    if (len < width) std::memset(dst + len, 0, static_cast<size_t>(width - len));
    out_lens[i] = static_cast<int32_t>(len);
  }
}

// ---------------------------------------------------------------------------
// Self-join pair emission over key groups.
//
// Input: rows sorted by key code; group_starts/group_sizes describe runs of
// equal codes (as produced by the Python grouping). Emits every unordered
// within-group position pair (p, q), p < q, as indices into `rows`.
//
// count_self_pairs returns the total so the caller can allocate exactly once;
// emit_self_pairs fills the preallocated buffers.
int64_t count_self_pairs(const int64_t* group_sizes, int64_t n_groups) {
  int64_t total = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t s = group_sizes[g];
    total += s * (s - 1) / 2;
  }
  return total;
}

void emit_self_pairs(const int64_t* rows, const int64_t* group_starts,
                     const int64_t* group_sizes, int64_t n_groups,
                     int64_t* out_i, int64_t* out_j) {
  int64_t k = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t start = group_starts[g];
    const int64_t s = group_sizes[g];
    for (int64_t p = 0; p < s; ++p) {
      const int64_t rp = rows[start + p];
      for (int64_t q = p + 1; q < s; ++q) {
        out_i[k] = rp;
        out_j[k] = rows[start + q];
        ++k;
      }
    }
  }
}

// int32 variant: at billions of candidate pairs the pair-index buffers are
// the dominant host allocation, and int32 row indices cover 2^31 rows.
void emit_self_pairs_i32(const int32_t* rows, const int64_t* group_starts,
                         const int64_t* group_sizes, int64_t n_groups,
                         int32_t* out_i, int32_t* out_j) {
  int64_t k = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t start = group_starts[g];
    const int64_t s = group_sizes[g];
    for (int64_t p = 0; p < s; ++p) {
      const int32_t rp = rows[start + p];
      for (int64_t q = p + 1; q < s; ++q) {
        out_i[k] = rp;
        out_j[k] = rows[start + q];
        ++k;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cross-join pair emission (link_only): for each key present on both sides,
// emit the full left-group x right-group product.
int64_t count_cross_pairs(const int64_t* l_sizes, const int64_t* r_sizes,
                          int64_t n_groups) {
  int64_t total = 0;
  for (int64_t g = 0; g < n_groups; ++g) total += l_sizes[g] * r_sizes[g];
  return total;
}

void emit_cross_pairs(const int64_t* l_rows, const int64_t* l_starts,
                      const int64_t* l_sizes, const int64_t* r_rows,
                      const int64_t* r_starts, const int64_t* r_sizes,
                      int64_t n_groups, int64_t* out_i, int64_t* out_j) {
  int64_t k = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t ls = l_starts[g], le = ls + l_sizes[g];
    const int64_t rs = r_starts[g], re = rs + r_sizes[g];
    for (int64_t a = ls; a < le; ++a) {
      const int64_t ra = l_rows[a];
      for (int64_t b = rs; b < re; ++b) {
        out_i[k] = ra;
        out_j[k] = r_rows[b];
        ++k;
      }
    }
  }
}

void emit_cross_pairs_i32(const int32_t* l_rows, const int64_t* l_starts,
                          const int64_t* l_sizes, const int32_t* r_rows,
                          const int64_t* r_starts, const int64_t* r_sizes,
                          int64_t n_groups, int32_t* out_i, int32_t* out_j) {
  int64_t k = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t ls = l_starts[g], le = ls + l_sizes[g];
    const int64_t rs = r_starts[g], re = rs + r_sizes[g];
    for (int64_t a = ls; a < le; ++a) {
      const int32_t ra = l_rows[a];
      for (int64_t b = rs; b < re; ++b) {
        out_i[k] = ra;
        out_j[k] = r_rows[b];
        ++k;
      }
    }
  }
}

}  // extern "C"
