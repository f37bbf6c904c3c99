// Standalone row DFT kernels for NVIDIA Hopper (sm_90a): a truncated DFT or
// a padded inverse DFT along the last axis of a flattened [M, N_in] input,
// as a product with a DFT operand [N_in, N_out] read from device memory:
//
//   rdft   real x [M,N]        -> (x·Cr, x·Ci)                   pair [M,K]
//   cdft   pair (xr, xi) [M,N] -> (xr·Fr − xi·Fi, xr·Fi + xi·Fr) pair [M,K]
//          (the operand decides: forward-truncated [N,K] or padded
//          inverse [K,N])
//   irdft  pair (xr, xi) [M,K] -> xr·Er − xi·Ei                  real [M,N]
//
// Replaces the TPU kernels repro/kernels/dft.py::_rdft_call, _cdft_call and
// _irdft_call (truncation = an operand with K columns, zero padding = an
// operand with K rows; no copy kernels). Element type float or
// __nv_bfloat16 for the input and the operand; every sum accumulates in
// f32; the output is written once, at the element type.
//
// What bounds it on an H100. At fno2d (M = 8·64·128 rows, N = 128, K = 32)
// the rdft reads 33.6 MB and writes 16.8 MB in f32 (~15 µs at 3.35 TB/s)
// and its dense product is 1.07 GFLOP (~16 µs at the f32 CUDA-core rate);
// an FFT would need a fifth of the operations, so bytes bound the function.
// The Kronecker-combined fno3d outer operand ([4096, 256] complex) makes
// the dense product 8.6 GFLOP per layer at B=1: operations bound that.
//
// Design: a plain tiled product on CUDA cores. A thread block owns a tile
// of kBM rows × kBN output columns; it walks N_in in chunks of kBK, staging
// the input tile (transposed, so a warp reads consecutive rows) and the
// operand tile in shared memory as f32; each thread keeps kTM × kTN
// outputs (re and im) in registers, so every shared-memory load feeds
// kTN (or kTM) multiply-adds. Ragged M, N_in and N_out are masked: the
// TPU's 128-lane mode padding is not ported. Tensor cores (wgmma) and TMA
// are later work.
#include "fno_common.cuh"

namespace {

using fno::ld;
using fno::st;

constexpr int kTX = 8;    // threads along the output columns
constexpr int kTY = 32;   // threads along the rows
constexpr int kTN = 4;    // output columns per thread (kTX apart)
constexpr int kTM = 4;    // rows per thread (kTY apart)
constexpr int kThreads = kTX * kTY;
constexpr int kBN = kTX * kTN;  // 32 output columns per block
constexpr int kBM = kTY * kTM;  // 128 rows per block
constexpr int kBK = 16;         // input columns per shared-memory chunk
constexpr int kLdA = kBM + 1;   // padded row of the transposed input tile

enum Mode { kR2C = 0, kC2C = 1, kC2R = 2 };

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

template <typename T>
struct Args {
  const T* in_r;   // [M, n_in]
  const T* in_i;   // [M, n_in], null for kR2C
  const T* m_r;    // [n_in, n_out]
  const T* m_i;    // [n_in, n_out]
  T* out_r;        // [M, n_out]
  T* out_i;        // [M, n_out], null for kC2R
  int M, n_in, n_out;
};

// Shared memory of one block: the input tile(s) [kBK][kLdA] and the operand
// tiles [kBK][kBN], real and imaginary, in floats.
constexpr int kSmemFloats = 2 * kBK * kLdA + 2 * kBK * kBN;

template <int kMode, typename T>
__global__ void __launch_bounds__(kThreads) dft_rows_kernel(const Args<T> a) {
  constexpr bool kInCplx = kMode != kR2C;
  constexpr bool kOutCplx = kMode != kC2R;
  float* as_r = dyn_smem();          // [kBK][kLdA], column c of the tile
  float* as_i = as_r + kBK * kLdA;   // is row c here
  float* bs_r = as_i + kBK * kLdA;   // [kBK][kBN]
  float* bs_i = bs_r + kBK * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int M = a.M, n_in = a.n_in, n_out = a.n_out;

  float acc_r[kTM][kTN], acc_i[kTM][kTN];
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
#pragma unroll
    for (int v = 0; v < kTN; ++v) acc_r[u][v] = acc_i[u][v] = 0.f;
  }

  for (int k0 = 0; k0 < n_in; k0 += kBK) {
    // Input tile: kBM rows × kBK columns, a row's columns on neighbouring
    // threads (coalesced), stored transposed.
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const long long gr = row0 + r;
      const int gc = k0 + c;
      const bool in = gr < M && gc < n_in;
      const long long at = gr * n_in + gc;
      as_r[c * kLdA + r] = in ? ld(a.in_r + at) : 0.f;
      if (kInCplx) as_i[c * kLdA + r] = in ? ld(a.in_i + at) : 0.f;
    }
    // Operand tile: kBK rows × kBN columns.
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int c = idx / kBN, n = idx % kBN;
      const int gk = k0 + c, gn = col0 + n;
      const bool in = gk < n_in && gn < n_out;
      const long long at = static_cast<long long>(gk) * n_out + gn;
      bs_r[idx] = in ? ld(a.m_r + at) : 0.f;
      bs_i[idx] = in ? ld(a.m_i + at) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float xr[kTM], xi[kTM], mr[kTN], mi[kTN];
#pragma unroll
      for (int u = 0; u < kTM; ++u) {
        xr[u] = as_r[c * kLdA + ty + u * kTY];
        xi[u] = kInCplx ? as_i[c * kLdA + ty + u * kTY] : 0.f;
      }
#pragma unroll
      for (int v = 0; v < kTN; ++v) {
        mr[v] = bs_r[c * kBN + tx + v * kTX];
        mi[v] = bs_i[c * kBN + tx + v * kTX];
      }
#pragma unroll
      for (int u = 0; u < kTM; ++u) {
#pragma unroll
        for (int v = 0; v < kTN; ++v) {
          if (kMode == kR2C) {
            acc_r[u][v] = fmaf(xr[u], mr[v], acc_r[u][v]);
            acc_i[u][v] = fmaf(xr[u], mi[v], acc_i[u][v]);
          } else if (kMode == kC2C) {
            acc_r[u][v] = fmaf(xr[u], mr[v], fmaf(-xi[u], mi[v], acc_r[u][v]));
            acc_i[u][v] = fmaf(xr[u], mi[v], fmaf(xi[u], mr[v], acc_i[u][v]));
          } else {
            acc_r[u][v] = fmaf(xr[u], mr[v], fmaf(-xi[u], mi[v], acc_r[u][v]));
          }
        }
      }
    }
    __syncthreads();
  }

  // Each (u, v) store: neighbouring threads write neighbouring columns.
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const long long gr = row0 + ty + u * kTY;
    if (gr >= M) break;
#pragma unroll
    for (int v = 0; v < kTN; ++v) {
      const int gn = col0 + tx + v * kTX;
      if (gn < n_out) {
        st(a.out_r + gr * n_out + gn, acc_r[u][v]);
        if (kOutCplx) st(a.out_i + gr * n_out + gn, acc_i[u][v]);
      }
    }
  }
}

template <int kMode, typename T>
int launch(const void* in_r, const void* in_i, const void* m_r,
           const void* m_i, void* out_r, void* out_i, int M, int n_in,
           int n_out, void* stream) {
  if (M < 1 || n_in < 1 || n_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<T> a;
  a.in_r = static_cast<const T*>(in_r);
  a.in_i = static_cast<const T*>(in_i);
  a.m_r = static_cast<const T*>(m_r);
  a.m_i = static_cast<const T*>(m_i);
  a.out_r = static_cast<T*>(out_r);
  a.out_i = static_cast<T*>(out_i);
  a.M = M;
  a.n_in = n_in;
  a.n_out = n_out;
  const int smem_bytes = kSmemFloats * static_cast<int>(sizeof(float));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kBM - 1) / kBM, (n_out + kBN - 1) / kBN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, dft_rows_kernel<kMode, T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int dispatch(int dtype, const void* in_r, const void* in_i, const void* m_r,
             const void* m_i, void* out_r, void* out_i, int M, int n_in,
             int n_out, void* stream) {
  if (dtype == 0) {
    return launch<kMode, float>(in_r, in_i, m_r, m_i, out_r, out_i, M, n_in,
                                n_out, stream);
  }
  if (dtype == 1) {
    return launch<kMode, __nv_bfloat16>(in_r, in_i, m_r, m_i, out_r, out_i,
                                        M, n_in, n_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entries, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (input,
// operand and output). All pointers are device pointers to contiguous
// row-major arrays; each entry returns the cudaError_t of its launch.

// x [M,N] real, (cr, ci) [N,K] -> (yr, yi) [M,K].
extern "C" int dft_rows_rdft(int dtype, const void* x, const void* cr,
                             const void* ci, void* yr, void* yi, int M, int N,
                             int K, void* stream) {
  return dispatch<kR2C>(dtype, x, nullptr, cr, ci, yr, yi, M, N, K, stream);
}

// (xr, xi) [M,N], (fr, fi) [N,K] -> (yr, yi) [M,K].
extern "C" int dft_rows_cdft(int dtype, const void* xr, const void* xi,
                             const void* fr, const void* fi, void* yr,
                             void* yi, int M, int N, int K, void* stream) {
  return dispatch<kC2C>(dtype, xr, xi, fr, fi, yr, yi, M, N, K, stream);
}

// (xr, xi) [M,K], (er, ei) [K,N] -> y [M,N] = xr·er − xi·ei.
extern "C" int dft_rows_irdft(int dtype, const void* xr, const void* xi,
                              const void* er, const void* ei, void* y, int M,
                              int K, int N, void* stream) {
  return dispatch<kC2R>(dtype, xr, xi, er, ei, y, nullptr, M, K, N, stream);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* dft_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
