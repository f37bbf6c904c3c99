// Partial-fusion core for NVIDIA Hopper (sm_90a): the GEMM-adjacent stages
// of the paper's partial fusion in one launch, on a spectrum whose outer
// axes (s_2..s_R) were already transformed by the row kernels:
//
//   A[h,k_1]   = Σ_{i<s_1} z[b,h,i,p] · f[i,k_1]   truncated cDFT along s_1
//   C[o,k_1]   = Σ_h (wr + i·wi)[o,h] · A[h,k_1]     CGEMM over hidden
//   y[b,p,o,j] = Σ_{k_1} C[o,k_1] · g[k_1,j]       padded icDFT along s_1
//
// z is the complex pair [B, H, s_1, P] with P = Π(K_R..K_2) flattened, so one
// kernel serves every rank; y is the pair [B, P, O, s_1], the reference's
// layout ([B, K_R..K_2, O, s_1]). Replaces the TPU kernel
// repro/kernels/engine.py::fused_fnond_core_call (_make_core_kernel), shared
// weights. Element type float or __nv_bfloat16 for z, the weights and the
// operands; every stage accumulates in f32 and the spectra A and C stay f32
// in shared memory; y is written once, at the element type.
//
// What bounds it on an H100. At fno2d (B=8, H=O=64, s_1=128, P=32,
// K_1=32) it reads 16.8 MB and writes 16.8 MB in f32 (~10 µs at 3.35
// TB/s); its dense stages are 1.3 GFLOP (~20 µs at the f32 CUDA-core rate),
// FFT-sized ones a fifth of that, so bytes bound the function.
//
// Design. The TPU kernel walks a sequential grid over hidden tiles and
// carries the [K_1, O] accumulator in VMEM. Here one thread block owns one
// (b, p) column: it streams z over chunks of s_1 rows into shared memory and
// accumulates the spectrum A [H, K_1] there, forms C [O, K_1] from the
// weights it staged in shared memory, and writes each output row y[b,p,o,:]
// straight from registers, neighbouring threads on neighbouring points. No
// spectrum touches device memory. At fno2d that is B·P = 256 blocks of 256
// threads, two per SM. Each thread keeps kTP outputs so that one operand
// load feeds kTP multiply-adds. z is gathered with stride P (a block reads
// one column); the neighbouring columns' blocks share those sectors in L2.
#include "fno_common.cuh"

namespace {

using fno::ld;
using fno::st;

constexpr int kThreads = 256;
constexpr int kTP = 4;  // outputs per thread, sharing each operand load

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

template <typename T>
struct Args {
  const T* zr;  // [B, H, n1, P]
  const T* zi;
  const T* wr;  // [O, H]
  const T* wi;
  const T* fr;  // [n1, K1]
  const T* fi;
  const T* gr;  // [K1, n1]
  const T* gi;
  T* yr;        // [B, P, O, n1]
  T* yi;
  int H, O, n1, K1, P;
  int rows;     // s_1 rows per chunk of the forward stage
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_core_kernel(const Args<T> a) {
  const int H = a.H, O = a.O, n1 = a.n1, K1 = a.K1, P = a.P;
  const int p = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // Shared memory: the weights, the spectrum A, then a work area that holds
  // a chunk of z in the forward stage and C after it.
  float* Wr = dyn_smem();
  float* Wi = Wr + O * H;
  float* Ar = Wi + O * H;        // [H][K1]
  float* Ai = Ar + H * K1;
  float* work = Ai + H * K1;
  for (int i = tid; i < O * H; i += kThreads) {
    Wr[i] = ld(a.wr + i);
    Wi[i] = ld(a.wi + i);
  }
  for (int i = tid; i < H * K1; i += kThreads) Ar[i] = Ai[i] = 0.f;

  // Truncated cDFT along s_1, streamed over chunks of rows:
  //   A[h][k] += Σ_{r<nr} Z[h][r] · f[c0 + r][k]
  const size_t zb = static_cast<size_t>(b) * H * n1 * P + p;
  const int hg = (H + kTP - 1) / kTP;  // groups of kTP hidden channels
  for (int c0 = 0; c0 < n1; c0 += a.rows) {
    const int nr = min(a.rows, n1 - c0);
    float* Zr = work;  // [H][nr]
    float* Zi = work + H * nr;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < H * nr; i += kThreads) {
      const int h = i / nr, r = i % nr;
      const size_t at = zb + (static_cast<size_t>(h) * n1 + c0 + r) * P;
      Zr[i] = ld(a.zr + at);
      Zi[i] = ld(a.zi + at);
    }
    __syncthreads();
    for (int idx = tid; idx < hg * K1; idx += kThreads) {
      const int k = idx % K1, h0 = idx / K1 * kTP;
      float sr[kTP], si[kTP];
#pragma unroll
      for (int u = 0; u < kTP; ++u) sr[u] = si[u] = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float mr = ld(a.fr + (c0 + r) * K1 + k);
        const float mi = ld(a.fi + (c0 + r) * K1 + k);
#pragma unroll
        for (int u = 0; u < kTP; ++u) {
          const int h = min(h0 + u, H - 1);
          const float zr = Zr[h * nr + r], zi = Zi[h * nr + r];
          sr[u] = fmaf(zr, mr, fmaf(-zi, mi, sr[u]));
          si[u] = fmaf(zr, mi, fmaf(zi, mr, si[u]));
        }
      }
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        if (h0 + u < H) {  // every thread owns distinct (h, k)
          Ar[(h0 + u) * K1 + k] += sr[u];
          Ai[(h0 + u) * K1 + k] += si[u];
        }
      }
    }
  }
  __syncthreads();

  // CGEMM over the hidden axis: C[o][k] = Σ_h W[o][h] · A[h][k].
  float* Cr = work;  // [O][K1]
  float* Ci = work + O * K1;
  const int og = (O + kTP - 1) / kTP;
  for (int idx = tid; idx < og * K1; idx += kThreads) {
    const int k = idx % K1, o0 = idx / K1 * kTP;
    float cr[kTP], ci[kTP];
#pragma unroll
    for (int u = 0; u < kTP; ++u) cr[u] = ci[u] = 0.f;
    for (int h = 0; h < H; ++h) {
      const float ar = Ar[h * K1 + k], ai = Ai[h * K1 + k];
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        const int o = min(o0 + u, O - 1);
        const float wr = Wr[o * H + h], wi = Wi[o * H + h];
        cr[u] = fmaf(wr, ar, fmaf(-wi, ai, cr[u]));
        ci[u] = fmaf(wr, ai, fmaf(wi, ar, ci[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kTP; ++u) {
      if (o0 + u < O) {
        Cr[(o0 + u) * K1 + k] = cr[u];
        Ci[(o0 + u) * K1 + k] = ci[u];
      }
    }
  }
  __syncthreads();

  // Padded icDFT along s_1: y[b,p,o,j] = Σ_k C[o][k] · g[k][j], one row of
  // n1 points per (o), neighbouring threads on neighbouring j.
  const size_t yb = (static_cast<size_t>(b) * P + p) * O * n1;
  for (int idx = tid; idx < og * n1; idx += kThreads) {
    const int j = idx % n1, o0 = idx / n1 * kTP;
    float yr[kTP], yi[kTP];
#pragma unroll
    for (int u = 0; u < kTP; ++u) yr[u] = yi[u] = 0.f;
    for (int k = 0; k < K1; ++k) {
      const float mr = ld(a.gr + k * n1 + j);
      const float mi = ld(a.gi + k * n1 + j);
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        const int o = min(o0 + u, O - 1);
        const float cr = Cr[o * K1 + k], ci = Ci[o * K1 + k];
        yr[u] = fmaf(cr, mr, fmaf(-ci, mi, yr[u]));
        yi[u] = fmaf(cr, mi, fmaf(ci, mr, yi[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kTP; ++u) {
      if (o0 + u < O) {
        const size_t at = yb + static_cast<size_t>(o0 + u) * n1 + j;
        st(a.yr + at, yr[u]);
        st(a.yi + at, yi[u]);
      }
    }
  }
}

template <typename T>
int launch(const void* const* ptrs, void* yr, void* yi, const int* dims,
           int rows, int smem_bytes, void* stream) {
  Args<T> a;
  a.zr = static_cast<const T*>(ptrs[0]);
  a.zi = static_cast<const T*>(ptrs[1]);
  a.wr = static_cast<const T*>(ptrs[2]);
  a.wi = static_cast<const T*>(ptrs[3]);
  a.fr = static_cast<const T*>(ptrs[4]);
  a.fi = static_cast<const T*>(ptrs[5]);
  a.gr = static_cast<const T*>(ptrs[6]);
  a.gi = static_cast<const T*>(ptrs[7]);
  a.yr = static_cast<T*>(yr);
  a.yi = static_cast<T*>(yi);
  const int batch = dims[0];
  a.H = dims[1];
  a.O = dims[2];
  a.n1 = dims[3];
  a.K1 = dims[4];
  a.P = dims[5];
  a.rows = rows;
  if (batch < 1 || a.H < 1 || a.O < 1 || a.n1 < 1 || a.K1 < 1 || a.P < 1 ||
      rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(&cfg, fused_core_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (z, the
// weights, the operands and y). ptrs: device pointers {zr, zi, wr, wi, fr,
// fi, gr, gi}; yr, yi: the outputs [B, P, O, n1]. dims: {B, H, O, n1, K1, P}.
// rows: s_1 rows per forward chunk; smem_bytes: the block's dynamic shared
// memory (4·(2·O·H + 2·H·K1 + max(2·H·rows, 2·O·K1))). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fused_core(int dtype, const void* const* ptrs, void* yr,
                          void* yi, const int* dims, int rows, int smem_bytes,
                          void* stream) {
  if (dtype == 0) {
    return launch<float>(ptrs, yr, yi, dims, rows, smem_bytes, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(ptrs, yr, yi, dims, rows, smem_bytes,
                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* fused_core_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
