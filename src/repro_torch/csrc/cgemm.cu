// Complex matrix product for NVIDIA Hopper (sm_90a): C = A·B for complex
// A [M,K] and B [K,N] held as (re, im) planes,
//
//   Cr = ar·br − ai·bi,   Ci = ar·bi + ai·br,
//
// four real products in one pass. Replaces the TPU kernel
// repro/kernels/cgemm.py::cgemm_call (blocked CGEMM, f32 VMEM accumulator,
// 128-tiles, operands padded to whole blocks by ops.py). Element type float
// or __nv_bfloat16 for the planes; every sum accumulates in f32 and C is
// written once, at the element type.
//
// What bounds it on an H100. In the FNO's CGEMM regime M = out channels
// (64–128) and K = hidden are small and N = B·ΠK is large (8192 at fno2d
// B=8): (64, 64, 8192) is 0.27 GFLOP (8 per complex multiply-add) against
// 8.4 MB of A, B and C in f32, so the f32 CUDA-core rate bounds it (~4 µs
// at 67 TFLOP/s); the same holds for (128, 128, 8192) (~16 µs).
//
// Design: a plain tiled product on CUDA cores, as the paper's CGEMM
// (TurboFNO Table 1: 32×32×8 tiles, double-buffered shared memory). A
// thread block owns a tile of kBM × kBN outputs and walks K in chunks of
// kBK, staging the A tile (transposed, so a thread's rows are one load
// apart) and the B tile in shared memory as f32; each thread keeps
// kTM × kTN complex outputs in registers, so each shared-memory load feeds
// kTN (or kTM) complex multiply-adds. Ragged M, K and N are masked: the
// TPU's padding to 128 is not ported. Tensor cores (wgmma), TMA and double
// buffering are later work.
#include "fno_common.cuh"

namespace {

using fno::ld;
using fno::st;

constexpr int kTX = 16;  // threads along the output columns
constexpr int kTY = 16;  // threads along the output rows
constexpr int kTN = 4;   // output columns per thread (kTX apart)
constexpr int kTM = 4;   // output rows per thread (kTY apart)
constexpr int kThreads = kTX * kTY;
constexpr int kBN = kTX * kTN;  // 64 output columns per block
constexpr int kBM = kTY * kTM;  // 64 output rows per block
constexpr int kBK = 16;         // depth per shared-memory chunk
constexpr int kLdA = kBM + 1;   // padded row of the transposed A tile

// Shared memory of one block: the A tiles [kBK][kLdA] and the B tiles
// [kBK][kBN], real and imaginary, in floats.
constexpr int kSmemFloats = 2 * kBK * kLdA + 2 * kBK * kBN;

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

template <typename T>
struct Args {
  const T* ar;  // [M, K]
  const T* ai;
  const T* br;  // [K, N]
  const T* bi;
  T* cr;        // [M, N]
  T* ci;
  int M, N, K;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) cgemm_kernel(const Args<T> a) {
  float* as_r = dyn_smem();         // [kBK][kLdA]: column c of the A tile
  float* as_i = as_r + kBK * kLdA;  // is row c here
  float* bs_r = as_i + kBK * kLdA;  // [kBK][kBN]
  float* bs_i = bs_r + kBK * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int M = a.M, N = a.N, K = a.K;

  float acc_r[kTM][kTN], acc_i[kTM][kTN];
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
#pragma unroll
    for (int v = 0; v < kTN; ++v) acc_r[u][v] = acc_i[u][v] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: kBM rows × kBK columns, a row's columns on neighbouring
    // threads (coalesced), stored transposed.
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gr = row0 + r, gc = k0 + c;
      const bool in = gr < M && gc < K;
      const size_t at = static_cast<size_t>(gr) * K + gc;
      as_r[c * kLdA + r] = in ? ld(a.ar + at) : 0.f;
      as_i[c * kLdA + r] = in ? ld(a.ai + at) : 0.f;
    }
    // B tile: kBK rows × kBN columns.
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int c = idx / kBN, n = idx % kBN;
      const int gk = k0 + c, gn = col0 + n;
      const bool in = gk < K && gn < N;
      const size_t at = static_cast<size_t>(gk) * N + gn;
      bs_r[idx] = in ? ld(a.br + at) : 0.f;
      bs_i[idx] = in ? ld(a.bi + at) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float xr[kTM], xi[kTM], yr[kTN], yi[kTN];
#pragma unroll
      for (int u = 0; u < kTM; ++u) {
        xr[u] = as_r[c * kLdA + ty + u * kTY];
        xi[u] = as_i[c * kLdA + ty + u * kTY];
      }
#pragma unroll
      for (int v = 0; v < kTN; ++v) {
        yr[v] = bs_r[c * kBN + tx + v * kTX];
        yi[v] = bs_i[c * kBN + tx + v * kTX];
      }
#pragma unroll
      for (int u = 0; u < kTM; ++u) {
#pragma unroll
        for (int v = 0; v < kTN; ++v) {
          acc_r[u][v] = fmaf(xr[u], yr[v], fmaf(-xi[u], yi[v], acc_r[u][v]));
          acc_i[u][v] = fmaf(xr[u], yi[v], fmaf(xi[u], yr[v], acc_i[u][v]));
        }
      }
    }
    __syncthreads();
  }

  // Each (u, v) store: neighbouring threads write neighbouring columns.
#pragma unroll
  for (int u = 0; u < kTM; ++u) {
    const int gr = row0 + ty + u * kTY;
    if (gr >= M) break;
#pragma unroll
    for (int v = 0; v < kTN; ++v) {
      const int gn = col0 + tx + v * kTX;
      if (gn < N) {
        const size_t at = static_cast<size_t>(gr) * N + gn;
        st(a.cr + at, acc_r[u][v]);
        st(a.ci + at, acc_i[u][v]);
      }
    }
  }
}

template <typename T>
int launch(void* const* ptrs, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.ar = static_cast<const T*>(ptrs[0]);
  a.ai = static_cast<const T*>(ptrs[1]);
  a.br = static_cast<const T*>(ptrs[2]);
  a.bi = static_cast<const T*>(ptrs[3]);
  a.cr = static_cast<T*>(ptrs[4]);
  a.ci = static_cast<T*>(ptrs[5]);
  a.M = M;
  a.N = N;
  a.K = K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cgemm_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (every
// plane). ptrs: 6 device pointers to contiguous row-major planes
// {ar, ai [M,K], br, bi [K,N], cr, ci [M,N]}. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int cgemm(int dtype, void* const* ptrs, int M, int N, int K,
                     void* stream) {
  if (dtype == 0) return launch<float>(ptrs, M, N, K, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(ptrs, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* cgemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
