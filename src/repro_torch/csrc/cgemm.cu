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
// B=8). (64, 64, 8192) is 0.27 GFLOP (8 per complex multiply-add) against
// 8.4 MB of A, B and C in f32: 2.5 µs at 3.35 TB/s. On the CUDA cores the
// operations alone take 4.0 µs (67 TFLOP/s); as three TF32 passes on the
// tensor cores (3xTF32, tc_common.cuh) 1.6 µs, so the bytes bound it.
// (128, 128, 8192): 1.07 GFLOP against 16.9 MB, 6.5 µs as 3xTF32 against
// 5.0 µs of bytes. In bf16 the tensor cores leave both byte-bound.
//
// Design. A is small and B long: a persistent block keeps its slice of A
// (at most 128 rows, both planes) resident in shared memory and walks
// 16-column strips of B, each copied by 16-byte cp.async into the second of
// two buffers while the current strip is multiplied. Each warp owns a
// 16-row tile of the slice and accumulates its tile of the strip's Cr and
// Ci on the tensor cores (mma.sync: bf16 m16n8k16; f32 as 3xTF32 on
// m16n8k8), each fragment loaded and split once a step: ar·br, ai·bi and
// ar·bi + ai·br in three accumulators, Cr their difference at the end. Where the slice of A and two strips do not fit a
// block, the same kernel walks K in chunks, the chunk of A double-buffered
// beside B's. Ragged M, K and N are zero-padded in shared memory; a strip
// of C is staged there and written in 16-byte pieces. The grid holds at
// most half as many blocks as strips, so every block walks two or more
// and its copies overlap its products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fno_common.cuh"
#include "tc_common.cuh"

namespace {

using tc::align128;
using tc::aligned16;
using tc::pad_to;

constexpr int kBN = 16;           // columns of a strip
constexpr int kMaxRows = 128;     // rows of A a block keeps
constexpr int kMaxThreads = 2 * kMaxRows;  // one warp a 16-row tile
constexpr int kSmemSlack = 128;   // the base rounded up to 128 bytes

// The blocks' plan: M in `slices` of ms rows (msp padded to 16), K in nk
// chunks of kc (kcp padded to the tensor cores' depth); shared memory (byte
// offsets) holds A [2 planes][msp][lda] (one buffer when nk = 1, else
// two), B [2 planes][kcp][ldb] twice and C [2 planes][msp][ldc] f32.
struct Plan {
  int slices, ms, msp;
  int kc, kcp, nk;
  int lda, ldb, ldc;
  long long a1, b0, b1, c, bytes;
};

Plan make_plan(int esize, int M, int K, int kc) {
  Plan p = {};
  p.slices = (M + kMaxRows - 1) / kMaxRows;
  p.ms = (M + p.slices - 1) / p.slices;
  p.msp = pad_to(p.ms, tc::kTile);
  p.kc = kc;
  p.kcp = pad_to(kc, esize == 2 ? 16 : 8);
  p.nk = (K + kc - 1) / kc;
  p.lda = p.kcp + 16 / esize;
  p.ldb = kBN + 8;  // f32: conflict-free TF32 B loads; bf16: ldmatrix rows
  p.ldc = kBN + 4;
  const long long a = align128(2LL * p.msp * p.lda * esize);
  const long long b = align128(2LL * p.kcp * p.ldb * esize);
  p.a1 = p.nk == 1 ? 0 : a;
  p.b0 = p.a1 + a;
  p.b1 = p.b0 + b;
  p.c = p.b1 + b;
  p.bytes = p.c + align128(4LL * 2 * p.msp * p.ldc);
  return p;
}

// A resident (one K chunk) where that fits a block, else the longest
// chunks, a multiple of the depth, that do.
Plan pick_plan(int esize, int M, int K) {
  const int depth = esize == 2 ? 16 : 8;
  Plan p = make_plan(esize, M, K, K);
  for (int kc = (K - 1) / depth * depth;
       p.bytes + kSmemSlack > tc::kSmemLimit && kc >= depth; kc -= depth) {
    p = make_plan(esize, M, K, kc);
  }
  return p;
}

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
  int M, N, K, strips;
  int vec_a, vec_b, vec_c;  // rows copied / written in 16-byte pieces
  Plan p;
};

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) cgemm_kernel(const Args<T> a) {
  const Plan& p = a.p;
  // Rounded up to 128 bytes by an offset, so the pointer keeps the shared
  // state space (smem_base in dft_rows.cu).
  char* base = reinterpret_cast<char*>(dyn_smem());
  base += (128 - (reinterpret_cast<uintptr_t>(base) & 127)) & 127;
  T* as[2] = {reinterpret_cast<T*>(base), reinterpret_cast<T*>(base + p.a1)};
  T* bs[2] = {reinterpret_cast<T*>(base + p.b0),
              reinterpret_cast<T*>(base + p.b1)};
  float* cs = reinterpret_cast<float*>(base + p.c);
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32;
  const int N = a.N, K = a.K;
  const int m0 = blockIdx.y * p.ms, mr = min(p.ms, a.M - m0);

  // Zero A and B once where M or K is ragged: rows and columns past them
  // are never copied. (Columns past N only meet columns of C that are not
  // written.)
  if (mr < p.msp || K % p.kc != 0 || p.kc < p.kcp) {
    for (int i = tid; i < p.c / 16; i += nthreads) {
      reinterpret_cast<float4*>(base)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }

  // Stage s: strip blockIdx.x + (s / nk)·gridDim.x, K chunk s % nk, into
  // buffers s & 1 (A's only where K is chunked; else A once, with stage 0).
  auto load_stage = [&](int s) {
    const int n0 = (blockIdx.x + (s / p.nk) * gridDim.x) * kBN;
    const int k0 = (s % p.nk) * p.kc, kc = min(p.kc, K - k0);
    const int bn = min(kBN, N - n0);
    T* b = bs[s & 1];
    const long long bat = static_cast<long long>(k0) * N + n0;
    tc::load_tile(b, p.ldb, a.br + bat, N, kc, bn, a.vec_b, nthreads);
    tc::load_tile(b + p.kcp * p.ldb, p.ldb, a.bi + bat, N, kc, bn, a.vec_b,
                  nthreads);
    if (p.nk > 1 && kc < p.kcp) {
      // The ragged last chunk: B's rows past K hold an earlier chunk.
      const int tail = (p.kcp - kc) * p.ldb;
      for (int i = tid; i < 2 * tail; i += nthreads) {
        fno::st(b + (i < tail ? 0 : p.kcp * p.ldb) + kc * p.ldb + i % tail,
                0.f);
      }
    }
    if (p.nk > 1 || s == 0) {
      T* A = as[s & 1];
      const long long aat = static_cast<long long>(m0) * K + k0;
      tc::load_tile(A, p.lda, a.ar + aat, K, mr, kc, a.vec_a, nthreads);
      tc::load_tile(A + p.msp * p.lda, p.lda, a.ai + aat, K, mr, kc,
                    a.vec_a, nthreads);
    }
  };

  const int stages =
      (a.strips - blockIdx.x + gridDim.x - 1) / gridDim.x * p.nk;
  // This warp's 16 rows of the strip, two 8-column pieces each: ar·br,
  // ai·bi and ar·bi + ai·br.
  float rr[1][2][4] = {}, ii[1][2][4] = {}, ci[1][2][4] = {};
  load_stage(0);
  tc::async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load_stage(s + 1);
    tc::async_commit();
    tc::async_wait_one();
    __syncthreads();
    const T* A = as[p.nk > 1 ? s & 1 : 0] + warp * tc::kTile * p.lda;
    const T* B = bs[s & 1];
    for (int k = 0; k < p.kcp; k += tc::depth<T>()) {
      tc::Frag<T, 4> xr, xi;
      tc::Frag<T, 2> yr[2], yi[2];
      tc::load_a(xr.hi, A + k, p.lda);
      tc::load_a(xi.hi, A + p.msp * p.lda + k, p.lda);
      tc::split(xr);
      tc::split(xi);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tc::load_b(yr[j].hi, B + k * p.ldb + 8 * j, p.ldb);
        tc::load_b(yi[j].hi, B + (p.kcp + k) * p.ldb + 8 * j, p.ldb);
        tc::split(yr[j]);
        tc::split(yi[j]);
        tc::mma<T>(rr[0][j], xr, yr[j]);
        tc::mma<T>(ii[0][j], xi, yi[j]);
        tc::mma<T>(ci[0][j], xr, yi[j]);
        tc::mma<T>(ci[0][j], xi, yr[j]);
      }
    }
    if (s % p.nk == p.nk - 1) {  // the strip's last chunk: write it
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rr[0][j][e] -= ii[0][j][e];
      }
      tc::store_acc(cs + warp * tc::kTile * p.ldc, p.ldc, rr);
      tc::store_acc(cs + (p.msp + warp * tc::kTile) * p.ldc, p.ldc, ci);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rr[0][j][e] = ii[0][j][e] = ci[0][j][e] = 0.f;
      }
      __syncthreads();
      const int n0 = (blockIdx.x + (s / p.nk) * gridDim.x) * kBN;
      const int bn = min(kBN, N - n0);
      if (a.vec_c) {
        const int q = bn / 4;
        for (int t = tid; t < 2 * mr * q; t += nthreads) {
          const int pl = t / (mr * q), r = (t / q) % mr, c = 4 * (t % q);
          st4((pl ? a.ci : a.cr) + static_cast<long long>(m0 + r) * N + n0 +
                  c,
              *reinterpret_cast<const float4*>(
                  cs + (pl * p.msp + r) * p.ldc + c));
        }
      } else {
        for (int t = tid; t < 2 * mr * bn; t += nthreads) {
          const int pl = t / (mr * bn), r = (t / bn) % mr, c = t % bn;
          fno::st((pl ? a.ci : a.cr) + static_cast<long long>(m0 + r) * N +
                      n0 + c,
                  cs[(pl * p.msp + r) * p.ldc + c]);
        }
      }
    }
    __syncthreads();  // buffers s & 1 and C free for the next copies
  }
}

template <typename T>
int launch(void* const* ptrs, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kE = static_cast<int>(sizeof(T));
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
  a.strips = (N + kBN - 1) / kBN;
  a.vec_a = (K * kE) % 16 == 0 && aligned16(ptrs[0]) && aligned16(ptrs[1]);
  a.vec_b = (N * kE) % 16 == 0 && aligned16(ptrs[2]) && aligned16(ptrs[3]);
  a.vec_c = N % 4 == 0 && aligned16(ptrs[4]) && aligned16(ptrs[5]);
  a.p = pick_plan(kE, M, K);
  const long long smem = a.p.bytes + kSmemSlack;
  if (smem > tc::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = a.p.msp / tc::kTile * 32;
  int blocks = 0;
  cudaError_t err = tc::resident_blocks(
      reinterpret_cast<const void*>(cgemm_kernel<T>), threads, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::max(1, std::min((a.strips + 1) / 2,
                                          blocks / a.p.slices)),
                     a.p.slices, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(&cfg, cgemm_kernel<T>, a);
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

// The plan of an (M, K) product: {slices of M, rows a slice, K chunk,
// chunks, shared memory of a block}. One chunk: A resident.
extern "C" void cgemm_plan(int dtype, int M, int K, long long* out) {
  const Plan p = pick_plan(dtype == 1 ? 2 : 4, M, K);
  out[0] = p.slices;
  out[1] = p.ms;
  out[2] = p.kc;
  out[3] = p.nk;
  out[4] = p.bytes + kSmemSlack;
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* cgemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
