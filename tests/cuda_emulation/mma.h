// CPU emulation of the warp matrix functions (nvcuda::wmma) that
// src/repro_torch/csrc uses: 16×16×16 bf16 tiles with an f32 accumulator.
// Every emulated thread of a warp holds the whole tile and computes the
// whole product; only lane 0 stores it, so the kernel's barrier after a
// store is what makes it visible, as on the card.
#pragma once
#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
enum layout_t { mem_row_major, mem_col_major };

template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
  static constexpr int num_elements = M * N;
  float x[M * N];
};

inline float to_float(float v) { return v; }
inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class Use, class T, class L>
void fill_fragment(fragment<Use, 16, 16, 16, T, L>& f, float v) {
  for (float& e : f.x) e = v;
}

template <class Use, class T, class L>
void load_matrix_sync(fragment<Use, 16, 16, 16, T, L>& f, const T* p,
                      unsigned ldm) {
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 16; ++j) f.x[i * 16 + j] = to_float(p[i * ldm + j]);
}

inline void mma_sync(
    fragment<accumulator, 16, 16, 16, float>& d,
    const fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major>& a,
    const fragment<matrix_b, 16, 16, 16, __nv_bfloat16, row_major>& b,
    const fragment<accumulator, 16, 16, 16, float>& c) {
  float out[256];
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 16; ++j) {
      float s = c.x[i * 16 + j];
      for (int k = 0; k < 16; ++k) s += a.x[i * 16 + k] * b.x[k * 16 + j];
      out[i * 16 + j] = s;
    }
  for (int i = 0; i < 256; ++i) d.x[i] = out[i];
}

inline void store_matrix_sync(
    float* p, const fragment<accumulator, 16, 16, 16, float>& f, unsigned ldm,
    layout_t) {
  if (threadIdx.x % 32 != 0) return;
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 16; ++j) p[i * ldm + j] = f.x[i * 16 + j];
}

}  // namespace wmma
}  // namespace nvcuda
