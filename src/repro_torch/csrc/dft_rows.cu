// Row DFT kernels for NVIDIA Hopper (sm_90a).
//
//   rdft   real x [S, n2, n3]           -> pair Z [S, k3, k2]
//          Z[k3,k2] = Σ_{s2,s3} x[s2,s3]·F3[s3,k3]·F2[s2,k2]
//   irdft  pair Z [S, k3, k2]           -> real y [S, n2, n3]
//          y[s2,s3] = Re Σ_{k3,k2} Z[k3,k2]·E2[k2,s2]·E3[k3,s3]
//   cdft   pair (xr, xi) [M,N] -> (xr·Fr − xi·Fi, xr·Fi + xi·Fr) pair [M,K]
//
// rdft and irdft replace the TPU kernels repro/kernels/dft.py::_rdft_call
// (dft.py:44) and _irdft_call (dft.py:97) on the partial variant's path. At
// rank 3 they transform a slab's two outer axes (s_2, s_3) with the per-axis
// factors instead of the reference's dense Kronecker operand
// (core/spectral.py outer_fwd_mats / outer_inv_mats): F3 = cdft_mats(n3, k3)
// (the last axis truncated), F2 = cdft_mats(n2, k2); E2 = cdft_mats(n2, k2,
// inverse), E3 = irdft_mats(n3, k3) (hermitian folded). The spectrum's
// columns run (k3, k2) with k2 minor, the layout the fused core takes. At
// rank 2 a row is a slab with n2 = k2 = 1: one stage, the one-axis operand.
// cdft replaces _cdft_call (dft.py:75); it has no model path.
//
// What bounds them on an H100. fno3d at B=8 is S = 16,384 slabs of 64×64:
// the rdft moves ≈ 302 MB in f32 (x read, the pair written), 0.090 ms at
// 3.35 TB/s. The dense Kronecker product did 34.4e9 multiply-adds (1.03 ms
// at the 67 TFLOP/s f32 CUDA-core rate); the two separable stages do 3.2e9
// (0.096 ms), so bytes and operations sit side by side. The irdft is the
// mirror image. At fno2d (65,536 rows of 128 → 32 modes) the rdft moves
// 50 MB (0.015 ms) for 0.54e9 multiply-adds (0.016 ms in f32).
//
// Design. A persistent block owns groups of whole slabs (rows at rank 2)
// and walks them with a stride of the grid; the next group's input is
// copied with 16-byte cp.async into the second of two shared-memory
// buffers while the current one is transformed. The DFT factors stay
// resident in shared memory for the block's life. Each stage is one
// product on shared-memory tiles with every intermediate in f32, so the
// only down-cast is the output write:
//   rdft:  stage A along s3, T[(slab,s2), (re k3 | im k3)] = x·[F3r | F3i];
//          stage B along s2 (complex), Z[k3,k2] = Σ_s2 T[s2,k3]·F2[s2,k2],
//          a 4×4 tile per four lanes that split s2 and add by shuffles.
//   irdft: stage 1 along k2 (complex), U[(slab,s2), (re k3 | im k3)] =
//          Σ_k2 Z[k3,k2]·E2[k2,s2]; stage 2 along k3 (the folded real
//          inverse), y = U·[E3r ; −E3i], written from registers.
// In f32 the products run on the CUDA cores (FFMA: TF32 would not hold
// 2e-4), each thread keeping an 8 × 8 (or 8 × 4) tile in registers fed by
// 16-byte shared-memory loads. In bf16 every product whose operands are
// bf16 in memory (stage A; the rank-2 inverse) runs on the tensor cores
// (wmma, bf16 in, f32 accumulate); products of the f32 intermediate stay
// on the CUDA cores. The launch sizes a slab group to the shared memory,
// up to the wrapper's cap (kernels/dft.py MAX_GROUP_ROWS); a slab over
// the budget is refused, by the wrapper and by the launch. Ragged extents
// are zero-padded in shared memory.
// Measured on an H100 (PERF.md §6, rows 4 and 6), the stages and not the
// bytes set the pace: fno3d B=8 f32 rdft 0.30 ms and irdft 0.28 against
// the 0.090 bound.
//
// cdft is the first kernel of this port, kept as it was: a tiled product
// on CUDA cores with the operand read from device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "fno_common.cuh"

namespace {

using fno::ld;
using fno::st;

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

// ---------------------------------------------------------------------------
// cdft: a plain tiled product with the operand read from device memory.
// ---------------------------------------------------------------------------
constexpr int kTX = 8;    // threads along the output columns
constexpr int kTY = 32;   // threads along the rows
constexpr int kTN = 4;    // output columns per thread (kTX apart)
constexpr int kTM = 4;    // rows per thread (kTY apart)
constexpr int kThreads = kTX * kTY;
constexpr int kBN = kTX * kTN;  // 32 output columns per block
constexpr int kBM = kTY * kTM;  // 128 rows per block
constexpr int kBK = 16;         // input columns per shared-memory chunk
constexpr int kLdA = kBM + 1;   // padded row of the transposed input tile

template <typename T>
struct Args {
  const T* in_r;   // [M, n_in]
  const T* in_i;   // [M, n_in]
  const T* m_r;    // [n_in, n_out]
  const T* m_i;    // [n_in, n_out]
  T* out_r;        // [M, n_out]
  T* out_i;        // [M, n_out]
  int M, n_in, n_out;
};

// Shared memory of one block: the input tiles [kBK][kLdA] and the operand
// tiles [kBK][kBN], real and imaginary, in floats.
constexpr int kSmemFloats = 2 * kBK * kLdA + 2 * kBK * kBN;

template <typename T>
__global__ void __launch_bounds__(kThreads) cdft_kernel(const Args<T> a) {
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
      as_i[c * kLdA + r] = in ? ld(a.in_i + at) : 0.f;
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
        xi[u] = as_i[c * kLdA + ty + u * kTY];
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
          acc_r[u][v] = fmaf(xr[u], mr[v], fmaf(-xi[u], mi[v], acc_r[u][v]));
          acc_i[u][v] = fmaf(xr[u], mi[v], fmaf(xi[u], mr[v], acc_i[u][v]));
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
        st(a.out_i + gr * n_out + gn, acc_i[u][v]);
      }
    }
  }
}

template <typename T>
int launch_cdft(const void* in_r, const void* in_i, const void* m_r,
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kBM - 1) / kBM, (n_out + kBN - 1) / kBN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, cdft_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// rdft / irdft: separable stages on slab groups resident in shared memory.
// ---------------------------------------------------------------------------
constexpr int kRowThreads = 256;
constexpr int kRM = 8;         // rows per thread of the FFMA product
constexpr int kSplit = 4;      // lanes that share one tile of stage B
constexpr int kMmaTile = 16;   // wmma's m = n = k
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kSmemSlack = 128;     // the base rounded up to 128 bytes

__host__ __device__ constexpr int pad_to(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr long long align128(long long v) {
  return (v + 127) / 128 * 128;
}

// Shared-memory layout of one block (byte offsets, regions 128-B aligned)
// and the padded extents of its products.
struct Layout {
  int mp, kp, np;       // the product C[mp × np] = A[mp × kp]·B[kp × np]
  int lda, ldb, ldc;    // leading dimensions (elements of each region)
  int hc;               // rdft: width of C's real half; irdft: of the input's
  int hb;               // irdft: rows of B's real half
  int in_rows, in_ld;   // irdft: one input buffer's rows and leading
                        // dimension (rdft: mp and lda)
  int h2, ld2;          // the outer factor's real half width and row
  int ldu;              // outer irdft: U's leading dimension
  int direct;           // irdft: the product writes y itself, C is unused
  long long in0, in1, opb, c, op2, u, bytes;
};

// rdft at slabs of n2 × n3 in groups of g: x buffers [mp][lda] (T), the
// stacked last-axis factor [F3r | F3i] [kp][ldb] (bf16 for wmma, else f32),
// T = C [mp][ldc] f32 (real half, then imaginary at column hc), and at
// rank 3 F2 [n2][ld2] f32.
__host__ __device__ inline Layout rdft_layout(int esize, bool outer, int g,
                                              int n2, int n3, int k2,
                                              int k3) {
  const bool mma = esize == 2;
  Layout L = {};
  L.mp = pad_to(g * n2, mma ? kMmaTile : kRM);
  L.kp = pad_to(n3, mma ? kMmaTile : 4);
  L.hc = pad_to(k3, mma ? kMmaTile / 2 : 4);
  L.np = 2 * L.hc;
  L.lda = L.kp + 16 / esize;
  L.ldb = L.np + (mma ? 8 : 4);
  L.ldc = L.np + 4;
  L.h2 = outer ? pad_to(k2, 4) : 0;
  L.ld2 = 2 * L.h2 + 4;
  L.in0 = 0;
  L.in1 = align128(L.in0 + 1LL * L.mp * L.lda * esize);
  L.opb = align128(L.in1 + 1LL * L.mp * L.lda * esize);
  L.c = align128(L.opb + 1LL * L.kp * L.ldb * (mma ? 2 : 4));
  L.op2 = align128(L.c + 4LL * L.mp * L.ldc);
  L.bytes = outer ? align128(L.op2 + 4LL * n2 * L.ld2) : L.op2;
  return L;
}

// irdft: input buffers [in_rows][in_ld] (T; the real half, then the
// imaginary half at column hc), the stacked hermitian-folded inverse
// [E3r ; −E3i] [kp][ldb] (rows [0, hb), [hb, 2hb); bf16 for wmma, else
// f32), C [mp][ldc] f32 (none where the FFMA product writes y straight
// from registers: n3 % 4 == 0), and at rank 3 E2 [k2][ld2] f32 and U
// [mp][ldu] f32.
__host__ __device__ inline Layout irdft_layout(int esize, bool outer, int g,
                                               int n2, int n3, int k2,
                                               int k3) {
  const bool mma = esize == 2 && !outer;
  Layout L = {};
  const int row_len = outer ? k2 : k3;
  L.hc = pad_to(row_len, 8);
  L.in_ld = 2 * L.hc + 16 / esize;
  L.mp = pad_to(outer ? g * n2 : g, mma ? kMmaTile : kRM);
  L.in_rows = outer ? g * k3 : L.mp;
  L.hb = outer ? pad_to(k3, 4) : L.hc;
  L.lda = outer ? 2 * L.hb + 4 : L.in_ld;
  L.ldu = L.lda;
  L.kp = 2 * L.hb;
  L.np = pad_to(n3, mma ? kMmaTile : 4);
  L.ldb = L.np + (mma ? 8 : 4);
  L.ldc = L.np + 4;
  L.direct = !mma && n3 % 4 == 0;
  L.h2 = outer ? pad_to(n2, 4) : 0;
  L.ld2 = 2 * L.h2 + 4;
  L.in0 = 0;
  L.in1 = align128(L.in0 + 1LL * L.in_rows * L.in_ld * esize);
  L.opb = align128(L.in1 + 1LL * L.in_rows * L.in_ld * esize);
  L.c = align128(L.opb + 1LL * L.kp * L.ldb * (mma ? 2 : 4));
  L.op2 = align128(L.c + (L.direct ? 0 : 4LL * L.mp * L.ldc));
  L.u = align128(L.op2 + 4LL * k2 * L.ld2);
  L.bytes = outer ? align128(L.u + 4LL * L.mp * L.ldu) : L.op2;
  return L;
}

template <typename T>
struct RowArgs {
  const T* in_r;   // rdft: x [S, n2, n3]; irdft: the pair [S, k3, k2]
  const T* in_i;   // irdft only
  const T* m3r;    // last-axis factor pair: rdft [n3, k3], irdft [k3, n3]
  const T* m3i;
  const T* m2r;    // outer-axis factor pair (rank 3): rdft [n2, k2],
  const T* m2i;    // irdft [k2, n2]
  T* out_r;        // rdft: the pair [S, k3, k2]; irdft: y [S, n2, n3]
  T* out_i;
  int slabs, n2, n3, k2, k3, group;
  int vec_in;      // the input rows are copied in 16-byte pieces
  int vec_out;     // the output rows are written in 4-element pieces
  Layout L;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes from device to shared memory, asynchronously (cp.async; a plain
// copy where the source is compiled for the host).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most one committed group of this thread's copies is left.
__device__ __forceinline__ void async_wait_one() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Four outputs from f32 to T at p (16-byte aligned for float, 8 for bf16).
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

// Copy `nrows` rows of `len` elements (contiguous at src, rows `len` apart)
// into dst rows `ld` apart: 16-byte cp.async pieces when `vec`, else one
// element per thread and step.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int nrows, int len, bool vec) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int per_row = len / kE;
    for (int c = threadIdx.x; c < nrows * per_row; c += kRowThreads) {
      const int r = c / per_row, j = (c - r * per_row) * kE;
      copy16_async(dst + r * ld + j,
                   src + static_cast<long long>(r) * len + j);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * len; i += kRowThreads) {
      const int r = i / len;
      dst[r * ld + i - r * len] = src[i];
    }
  }
}

// C[mp × np] = A[mp × kp]·B[kp × np], f32 in shared memory, on the CUDA
// cores: each thread keeps kRM rows × kCN columns in registers; a warp's
// neighbouring threads take neighbouring column tiles of one row tile, so
// A's loads broadcast and B's are contiguous. kp % 4 == 0, np % kCN == 0,
// mp % kRM == 0. With `y` set, each thread writes its tile's first `rows`
// rows straight to device memory (rows np apart) instead of to C.
template <int kCN, typename TY>
__device__ __forceinline__ void product_ffma(const float* A, int lda,
                                             const float* B, int ldb,
                                             float* C, int ldc, int mp,
                                             int kp, int np, TY* y,
                                             int rows) {
  const int nct = np / kCN;
  const int tiles = (mp / kRM) * nct;
  for (int t = threadIdx.x; t < tiles; t += kRowThreads) {
    const int r0 = (t / nct) * kRM, c0 = (t % nct) * kCN;
    float acc[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int c = 0; c < kCN; ++c) acc[i][c] = 0.f;
    }
    const float* a0 = A + r0 * lda;
    const float* b0 = B + c0;
#pragma unroll 2
    for (int k = 0; k < kp; k += 4) {
      float4 av[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a0 + i * lda + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[kCN];
#pragma unroll
        for (int c = 0; c < kCN; c += 4) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(b0 + (k + kk) * ldb + c);
          b[c] = b4.x;
          b[c + 1] = b4.y;
          b[c + 2] = b4.z;
          b[c + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float x = kk == 0 ? av[i].x
                        : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int c = 0; c < kCN; ++c) acc[i][c] = fmaf(x, b[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int c = 0; c < kCN; c += 4) {
        const float4 v = make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2],
                                     acc[i][c + 3]);
        if (y == nullptr) {
          *reinterpret_cast<float4*>(C + (r0 + i) * ldc + c0 + c) = v;
        } else if (r0 + i < rows) {
          st4(y + static_cast<long long>(r0 + i) * np + c0 + c, v);
        }
      }
    }
  }
}

// The FFMA product with 8 columns a thread where that still gives every
// thread a tile (half the shared-memory loads per multiply-add), else 4.
template <typename TY>
__device__ __forceinline__ void product_f32(const float* A, int lda,
                                            const float* B, int ldb,
                                            float* C, int ldc, int mp,
                                            int kp, int np, TY* y = nullptr,
                                            int rows = 0) {
  if (np % 8 == 0 && (mp / kRM) * (np / 8) >= kRowThreads) {
    product_ffma<8>(A, lda, B, ldb, C, ldc, mp, kp, np, y, rows);
  } else {
    product_ffma<4>(A, lda, B, ldb, C, ldc, mp, kp, np, y, rows);
  }
}

// The same product with bf16 A and B on the tensor cores (wmma 16×16×16,
// f32 accumulate): a warp takes a 16-row tile and up to four 16-column
// tiles of C, so one A fragment feeds four independent accumulators. mp, kp
// and np are multiples of 16.
__device__ __forceinline__ void product_mma(const __nv_bfloat16* A, int lda,
                                            const __nv_bfloat16* B, int ldb,
                                            float* C, int ldc, int mp,
                                            int kp, int np) {
  namespace w = nvcuda::wmma;
  constexpr int kTiles = 4;  // column tiles a warp holds
  const int nct = np / kMmaTile, ncg = (nct + kTiles - 1) / kTiles;
  const int items = (mp / kMmaTile) * ncg;
  for (int t = threadIdx.x / 32; t < items; t += kRowThreads / 32) {
    const int r0 = (t / ncg) * kMmaTile, ct0 = (t % ncg) * kTiles;
    const int nc = min(kTiles, nct - ct0);
    w::fragment<w::accumulator, 16, 16, 16, float> acc[kTiles];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) w::fill_fragment(acc[j], 0.0f);
    for (int k = 0; k < kp; k += kMmaTile) {
      w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> a;
      w::load_matrix_sync(a, A + r0 * lda + k, lda);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < nc) {
          w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major>
              b;
          w::load_matrix_sync(b, B + k * ldb + (ct0 + j) * kMmaTile, ldb);
          w::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < nc) {
        w::store_matrix_sync(C + r0 * ldc + (ct0 + j) * kMmaTile, acc[j],
                             ldc, w::mem_row_major);
      }
    }
  }
}

__device__ __forceinline__ char* smem_base() {
  const uintptr_t p = reinterpret_cast<uintptr_t>(dyn_smem());
  return reinterpret_cast<char*>((p + 127) & ~static_cast<uintptr_t>(127));
}

template <typename T, bool kOuter>
__global__ void __launch_bounds__(kRowThreads) rdft_kernel(
    const RowArgs<T> a) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using TB = typename std::conditional<kMma, __nv_bfloat16, float>::type;
  const Layout& L = a.L;
  char* base = smem_base();
  T* xs[2] = {reinterpret_cast<T*>(base + L.in0),
              reinterpret_cast<T*>(base + L.in1)};
  TB* bs = reinterpret_cast<TB*>(base + L.opb);
  float* cs = reinterpret_cast<float*>(base + L.c);
  float* f2 = reinterpret_cast<float*>(base + L.op2);
  const int tid = threadIdx.x;
  const int n2 = a.n2, n3 = a.n3, k2 = a.k2, k3 = a.k3, G = a.group;

  // Zero the input's padding columns [n3, kp) once: the copies never
  // touch them.
  const int padc = L.kp - n3;
  for (int i = tid; i < 2 * L.mp * padc; i += kRowThreads) {
    const int r = i / padc;
    xs[r / L.mp][(r % L.mp) * L.lda + n3 + i % padc] = from_f32<T>(0.f);
  }
  // The last-axis factor, stacked [F3r | F3i] at columns [0, hc), [hc, 2hc).
  for (int i = tid; i < L.kp * L.np; i += kRowThreads) {
    const int s = i / L.np, c = i % L.np, m = c < L.hc ? c : c - L.hc;
    float v = 0.f;
    if (s < n3 && m < k3) v = ld((c < L.hc ? a.m3r : a.m3i) + s * k3 + m);
    bs[s * L.ldb + c] = from_f32<TB>(v);
  }
  // The outer factor (rank 3), [F2r | F2i] at columns [0, h2), [h2, 2h2).
  if (kOuter) {
    for (int i = tid; i < n2 * 2 * L.h2; i += kRowThreads) {
      const int s = i / (2 * L.h2), c = i % (2 * L.h2);
      const int m = c < L.h2 ? c : c - L.h2;
      f2[s * L.ld2 + c] =
          m < k2 ? ld((c < L.h2 ? a.m2r : a.m2i) + s * k2 + m) : 0.f;
    }
  }

  const int ngroups = (a.slabs + G - 1) / G;
  const long long group_len = static_cast<long long>(G) * n2 * n3;
  int g = blockIdx.x;
  load_rows(xs[0], L.lda, a.in_r + g * group_len,
            min(G, a.slabs - g * G) * n2, n3, a.vec_in);
  async_commit();
  for (int it = 0; g < ngroups; ++it, g += gridDim.x) {
    const int gn = g + gridDim.x;
    if (gn < ngroups) {
      load_rows(xs[(it + 1) & 1], L.lda, a.in_r + gn * group_len,
                min(G, a.slabs - gn * G) * n2, n3, a.vec_in);
    }
    async_commit();
    async_wait_one();
    __syncthreads();
    const int cnt = min(G, a.slabs - g * G);
    // Stage A along s3: C = x·[F3r | F3i].
    if constexpr (kMma) {
      product_mma(xs[it & 1], L.lda, bs, L.ldb, cs, L.ldc, L.mp, L.kp, L.np);
    } else {
      product_f32<float>(xs[it & 1], L.lda, bs, L.ldb, cs, L.ldc, L.mp, L.kp,
                         L.np);
    }
    __syncthreads();
    const long long slab0 = static_cast<long long>(g) * G;
    if (kOuter) {
      // Stage B along s2 (complex): Z[k3,k2] = Σ_s2 T[s2,k3]·F2[s2,k2].
      // A tile is four k3 × four k2; its kSplit lanes (neighbours in a
      // warp) take every kSplit-th s2 and add their sums with shuffles,
      // then each writes one k3 row. The loop runs the same count on every
      // lane, so the shuffles see the whole warp.
      const int q3 = (k3 + 3) / 4, q2 = (k2 + 3) / 4;
      const int tiles = cnt * q3 * q2;
      const int part = tid % kSplit;
      for (int w0 = 0; w0 < tiles * kSplit; w0 += kRowThreads) {
        const int w = w0 + tid;
        const int tile = min(w / kSplit, tiles - 1);
        const int gi = tile / (q3 * q2);
        const int a0 = 4 * ((tile / q2) % q3), b0 = 4 * (tile % q2);
        float zr[4][4], zi[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) zr[i][j] = zi[i][j] = 0.f;
        }
        const float* trow = cs + gi * n2 * L.ldc + a0;
#pragma unroll 4
        for (int s = part; s < n2; s += kSplit) {
          const float4 tr4 =
              *reinterpret_cast<const float4*>(trow + s * L.ldc);
          const float4 ti4 =
              *reinterpret_cast<const float4*>(trow + s * L.ldc + L.hc);
          const float4 fr4 =
              *reinterpret_cast<const float4*>(f2 + s * L.ld2 + b0);
          const float4 fi4 =
              *reinterpret_cast<const float4*>(f2 + s * L.ld2 + L.h2 + b0);
          const float tr[4] = {tr4.x, tr4.y, tr4.z, tr4.w};
          const float ti[4] = {ti4.x, ti4.y, ti4.z, ti4.w};
          const float fr[4] = {fr4.x, fr4.y, fr4.z, fr4.w};
          const float fi[4] = {fi4.x, fi4.y, fi4.z, fi4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              zr[i][j] = fmaf(tr[i], fr[j], fmaf(-ti[i], fi[j], zr[i][j]));
              zi[i][j] = fmaf(tr[i], fi[j], fmaf(ti[i], fr[j], zi[i][j]));
            }
          }
        }
#pragma unroll
        for (int m = 1; m < kSplit; m *= 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              zr[i][j] += __shfl_xor_sync(0xffffffffu, zr[i][j], m);
              zi[i][j] += __shfl_xor_sync(0xffffffffu, zi[i][j], m);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i != part || w >= tiles * kSplit || a0 + i >= k3) continue;
          const long long at = ((slab0 + gi) * k3 + a0 + i) * k2 + b0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (b0 + j < k2) {
              st(a.out_r + at + j, zr[i][j]);
              st(a.out_i + at + j, zi[i][j]);
            }
          }
        }
      }
    } else if (a.vec_out) {
      // Rank 2: the rows of C's two halves are the pair's rows.
      const int q = k3 / 4;
      for (int t = tid; t < 2 * cnt * q; t += kRowThreads) {
        const int p = t / (cnt * q), r = (t / q) % cnt, c = 4 * (t % q);
        const float4 v = *reinterpret_cast<const float4*>(
            cs + r * L.ldc + p * L.hc + c);
        st4((p ? a.out_i : a.out_r) + (slab0 + r) * k3 + c, v);
      }
    } else {
      for (int t = tid; t < 2 * cnt * k3; t += kRowThreads) {
        const int p = t / (cnt * k3), r = (t / k3) % cnt, c = t % k3;
        st((p ? a.out_i : a.out_r) + (slab0 + r) * k3 + c,
           cs[r * L.ldc + p * L.hc + c]);
      }
    }
  }
}

// Two blocks a multiprocessor where shared memory allows (the product
// writes y itself, so C takes no room): registers are capped to fit.
template <typename T, bool kOuter>
__global__ void __launch_bounds__(kRowThreads, 2) irdft_kernel(
    const RowArgs<T> a) {
  constexpr bool kMma = !kOuter && std::is_same<T, __nv_bfloat16>::value;
  using TB = typename std::conditional<kMma, __nv_bfloat16, float>::type;
  const Layout& L = a.L;
  char* base = smem_base();
  T* xs[2] = {reinterpret_cast<T*>(base + L.in0),
              reinterpret_cast<T*>(base + L.in1)};
  TB* bs = reinterpret_cast<TB*>(base + L.opb);
  float* cs = reinterpret_cast<float*>(base + L.c);
  float* e2 = reinterpret_cast<float*>(base + L.op2);
  float* us = reinterpret_cast<float*>(base + L.u);
  const int tid = threadIdx.x;
  const int n2 = a.n2, n3 = a.n3, k2 = a.k2, k3 = a.k3, G = a.group;
  const int row_len = kOuter ? k2 : k3;   // elements of one input row
  const int rows_per_slab = kOuter ? k3 : 1;

  // Zero the input's padding columns of both halves once.
  const int padc = L.hc - row_len;
  for (int i = tid; i < 2 * L.in_rows * 2 * padc; i += kRowThreads) {
    const int r = i / (2 * padc), c = i % (2 * padc);
    const int col = (c < padc ? 0 : L.hc) + row_len + c % padc;
    xs[r / L.in_rows][(r % L.in_rows) * L.in_ld + col] = from_f32<T>(0.f);
  }
  // The hermitian-folded last-axis inverse, stacked [E3r ; −E3i] at rows
  // [0, hb), [hb, 2hb).
  for (int i = tid; i < L.kp * L.np; i += kRowThreads) {
    const int r = i / L.np, s = i % L.np, m = r < L.hb ? r : r - L.hb;
    float v = 0.f;
    if (s < n3 && m < k3) {
      v = r < L.hb ? ld(a.m3r + m * n3 + s) : -ld(a.m3i + m * n3 + s);
    }
    bs[r * L.ldb + s] = from_f32<TB>(v);
  }
  // The outer inverse (rank 3), [E2r | E2i] at columns [0, h2), [h2, 2h2).
  if (kOuter) {
    for (int i = tid; i < k2 * 2 * L.h2; i += kRowThreads) {
      const int b = i / (2 * L.h2), c = i % (2 * L.h2);
      const int s = c < L.h2 ? c : c - L.h2;
      e2[b * L.ld2 + c] =
          s < n2 ? ld((c < L.h2 ? a.m2r : a.m2i) + b * n2 + s) : 0.f;
    }
  }

  const int ngroups = (a.slabs + G - 1) / G;
  const long long group_len =
      static_cast<long long>(G) * rows_per_slab * row_len;
  // Both halves of a group: the real rows, then the imaginary rows.
  auto load_group = [&](T* dst, int grp) {
    const int nrows = min(G, a.slabs - grp * G) * rows_per_slab;
    load_rows(dst, L.in_ld, a.in_r + grp * group_len, nrows, row_len,
              a.vec_in);
    load_rows(dst + L.hc, L.in_ld, a.in_i + grp * group_len, nrows, row_len,
              a.vec_in);
  };
  int g = blockIdx.x;
  load_group(xs[0], g);
  async_commit();
  for (int it = 0; g < ngroups; ++it, g += gridDim.x) {
    const int gn = g + gridDim.x;
    if (gn < ngroups) load_group(xs[(it + 1) & 1], gn);
    async_commit();
    async_wait_one();
    __syncthreads();
    const T* zs = xs[it & 1];
    const int cnt = min(G, a.slabs - g * G);
    if constexpr (kOuter) {
      // Stage 1 along k2 (complex): U[s2, k3] = Σ_k2 Z[k3,k2]·E2[k2,s2];
      // each thread four k3 × four s2. U's columns past k3 are written as
      // zeros: they meet B's zero rows in stage 2.
      const int q3 = (k3 + 3) / 4, q4 = (n2 + 3) / 4;
      for (int t = tid; t < cnt * q3 * q4; t += kRowThreads) {
        const int gi = t / (q3 * q4);
        const int a0 = 4 * ((t / q4) % q3), s0 = 4 * (t % q4);
        const T* z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          z[i] = zs + (gi * k3 + min(a0 + i, k3 - 1)) * L.in_ld;
        }
        float ur[4][4], ui[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) ur[i][j] = ui[i][j] = 0.f;
        }
#pragma unroll 4
        for (int b = 0; b < k2; ++b) {
          float zr[4], zi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            zr[i] = to_f32(z[i][b]);
            zi[i] = to_f32(z[i][L.hc + b]);
          }
          const float4 er4 =
              *reinterpret_cast<const float4*>(e2 + b * L.ld2 + s0);
          const float4 ei4 =
              *reinterpret_cast<const float4*>(e2 + b * L.ld2 + L.h2 + s0);
          const float er[4] = {er4.x, er4.y, er4.z, er4.w};
          const float ei[4] = {ei4.x, ei4.y, ei4.z, ei4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ur[i][j] = fmaf(zr[i], er[j], fmaf(-zi[i], ei[j], ur[i][j]));
              ui[i][j] = fmaf(zr[i], ei[j], fmaf(zi[i], er[j], ui[i][j]));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (s0 + j >= n2) break;
          float* urow = us + (gi * n2 + s0 + j) * L.ldu;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = a0 + i < k3;
            urow[a0 + i] = in ? ur[i][j] : 0.f;
            urow[L.hb + a0 + i] = in ? ui[i][j] : 0.f;
          }
        }
      }
      __syncthreads();
    }
    // Stage 2 along k3 (the folded real inverse): y = [Ur | Ui]·[E3r ; −E3i]
    // (at rank 2 the input pair itself). The group's output rows are
    // contiguous, slab by slab, s2 by s2; the FFMA product writes them
    // straight from registers where the rows take 4-element stores.
    const int nrows = cnt * (kOuter ? n2 : 1);
    T* y = a.out_r + static_cast<long long>(g) * G * (kOuter ? n2 : 1) * n3;
    const bool direct = L.direct;
    if constexpr (kMma) {
      product_mma(zs, L.in_ld, bs, L.ldb, cs, L.ldc, L.mp, L.kp, L.np);
    } else {
      product_f32(kOuter ? us : reinterpret_cast<const float*>(zs),
                  kOuter ? L.ldu : L.in_ld,
                  reinterpret_cast<const float*>(bs), L.ldb, cs, L.ldc, L.mp,
                  L.kp, L.np, direct ? y : nullptr, nrows);
    }
    __syncthreads();
    if (direct) continue;
    if (a.vec_out) {
      const int q = n3 / 4;
      for (int t = tid; t < nrows * q; t += kRowThreads) {
        const int r = t / q, c = 4 * (t % q);
        st4(y + static_cast<long long>(r) * n3 + c,
            *reinterpret_cast<const float4*>(cs + r * L.ldc + c));
      }
    } else {
      for (int t = tid; t < nrows * n3; t += kRowThreads) {
        const int r = t / n3, c = t % n3;
        st(y + static_cast<long long>(r) * n3 + c, cs[r * L.ldc + c]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Layout row_layout(bool inverse, int esize, bool outer, int g, int n2,
                  int n3, int k2, int k3) {
  return inverse ? irdft_layout(esize, outer, g, n2, n3, k2, k3)
                 : rdft_layout(esize, outer, g, n2, n3, k2, k3);
}

// The slab group of a launch: the most slabs, up to max_group and the
// slab count, whose block fits kSmemLimit; 0 when one slab does not fit.
int pick_group(bool inverse, int esize, bool outer, int max_group, int slabs,
               int n2, int n3, int k2, int k3) {
  for (int g = std::max(1, std::min(max_group, slabs)); g >= 1; --g) {
    if (row_layout(inverse, esize, outer, g, n2, n3, k2, k3).bytes +
            kSmemSlack <= kSmemLimit) {
      return g;
    }
  }
  return 0;
}

// Resident blocks of `kernel` on the current card at `smem` bytes (blocks
// a multiprocessor × multiprocessors), queried once per (kernel, card,
// smem) and kept: the launches of a model repeat a handful of shapes. The
// first query of a (kernel, card) raises its dynamic shared-memory limit
// to kSmemLimit, so every later launch of it fits.
cudaError_t resident_blocks(const void* kernel, long long smem, int* blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    long long smem;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel != kernel || cache[i].dev != dev) continue;
    raised = true;
    if (cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  if (!raised) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kRowThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = std::max(per_sm, 1) * sms;
  if (used < 64) cache[used++] = {kernel, dev, smem, *blocks};
  return cudaSuccess;
}

// One launch over `slabs` slabs in groups of at most max_group slabs.
template <typename T, bool kInverse, bool kOuter>
int launch_rows(const void* in_r, const void* in_i, const void* m3r,
                const void* m3i, const void* m2r, const void* m2i,
                void* out_r, void* out_i, int slabs, int n2, int n3, int k2,
                int k3, int max_group, void* stream) {
  if (slabs < 1 || n2 < 1 || n3 < 1 || k2 < 1 || k3 < 1 || max_group < 1 ||
      (!kOuter && (n2 != 1 || k2 != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kE = static_cast<int>(sizeof(T));
  const int group =
      pick_group(kInverse, kE, kOuter, max_group, slabs, n2, n3, k2, k3);
  if (group == 0) return static_cast<int>(cudaErrorInvalidValue);
  RowArgs<T> a;
  a.in_r = static_cast<const T*>(in_r);
  a.in_i = static_cast<const T*>(in_i);
  a.m3r = static_cast<const T*>(m3r);
  a.m3i = static_cast<const T*>(m3i);
  a.m2r = static_cast<const T*>(m2r);
  a.m2i = static_cast<const T*>(m2i);
  a.out_r = static_cast<T*>(out_r);
  a.out_i = static_cast<T*>(out_i);
  a.slabs = slabs;
  a.n2 = n2;
  a.n3 = n3;
  a.k2 = k2;
  a.k3 = k3;
  a.group = group;
  a.L = row_layout(kInverse, kE, kOuter, group, n2, n3, k2, k3);
  const long long smem = a.L.bytes + kSmemSlack;
  const int in_len = kInverse ? (kOuter ? k2 : k3) : n3;
  a.vec_in = (in_len * kE) % 16 == 0 && aligned16(in_r) && aligned16(in_i);
  const int out_len = kInverse ? n3 : k3;
  a.vec_out = out_len % 4 == 0 && aligned16(out_r) && aligned16(out_i);
  if (a.L.direct && !a.vec_out) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const RowArgs<T>) =
      kInverse ? irdft_kernel<T, kOuter> : rdft_kernel<T, kOuter>;
  int blocks = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel),
                                    smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngroups = (slabs + group - 1) / group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::min(ngroups, blocks), 1, 1);
  cfg.blockDim = dim3(kRowThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInverse>
int dispatch_rows(int dtype, const void* in_r, const void* in_i,
                  const void* m3r, const void* m3i, const void* m2r,
                  const void* m2i, void* out_r, void* out_i, int slabs,
                  int n2, int n3, int k2, int k3, int max_group,
                  void* stream) {
  const bool outer = m2r != nullptr;
  if (dtype == 0) {
    return outer ? launch_rows<float, kInverse, true>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream)
                 : launch_rows<float, kInverse, false>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream);
  }
  if (dtype == 1) {
    return outer ? launch_rows<__nv_bfloat16, kInverse, true>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream)
                 : launch_rows<__nv_bfloat16, kInverse, false>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entries, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (input,
// operands and output). All pointers are device pointers to contiguous
// row-major arrays; each entry returns the cudaError_t of its launch.

// x [S, n2, n3] real, (f3r, f3i) [n3, k3], (f2r, f2i) [n2, k2] or null
// (rank 2: n2 = k2 = 1) -> (zr, zi) [S, k3, k2]; slab groups of at most
// `max_group` slabs (dft_rows_group).
extern "C" int dft_rows_rdft(int dtype, const void* x, const void* f3r,
                             const void* f3i, const void* f2r,
                             const void* f2i, void* zr, void* zi, int slabs,
                             int n2, int n3, int k2, int k3, int max_group,
                             void* stream) {
  return dispatch_rows<false>(dtype, x, nullptr, f3r, f3i, f2r, f2i, zr, zi,
                              slabs, n2, n3, k2, k3, max_group, stream);
}

// (zr, zi) [S, k3, k2], (e3r, e3i) [k3, n3] (hermitian folded), (e2r, e2i)
// [k2, n2] or null (rank 2) -> y [S, n2, n3].
extern "C" int dft_rows_irdft(int dtype, const void* zr, const void* zi,
                              const void* e3r, const void* e3i,
                              const void* e2r, const void* e2i, void* y,
                              int slabs, int n2, int n3, int k2, int k3,
                              int max_group, void* stream) {
  return dispatch_rows<true>(dtype, zr, zi, e3r, e3i, e2r, e2i, y, nullptr,
                             slabs, n2, n3, k2, k3, max_group, stream);
}

// The slab group an rdft (inverse = 0) or irdft launch takes (0: one slab
// over the budget), and the dynamic shared memory of one block of `group`
// slabs: the wrapper's one-slab refusal (kernels/dft.py smem_bytes)
// mirrors the latter.
extern "C" int dft_rows_group(int inverse, int dtype, int outer,
                              int max_group, int slabs, int n2, int n3,
                              int k2, int k3) {
  return pick_group(inverse != 0, dtype == 1 ? 2 : 4, outer != 0, max_group,
                    slabs, n2, n3, k2, k3);
}

extern "C" long long dft_rows_smem(int inverse, int dtype, int outer,
                                   int group, int n2, int n3, int k2,
                                   int k3) {
  return row_layout(inverse != 0, dtype == 1 ? 2 : 4, outer != 0, group, n2,
                    n3, k2, k3).bytes +
         kSmemSlack;
}

// (xr, xi) [M,N], (fr, fi) [N,K] -> (yr, yi) [M,K].
extern "C" int dft_rows_cdft(int dtype, const void* xr, const void* xi,
                             const void* fr, const void* fi, void* yr,
                             void* yi, int M, int N, int K, void* stream) {
  if (dtype == 0) {
    return launch_cdft<float>(xr, xi, fr, fi, yr, yi, M, N, K, stream);
  }
  if (dtype == 1) {
    return launch_cdft<__nv_bfloat16>(xr, xi, fr, fi, yr, yi, M, N, K,
                                      stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* dft_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
