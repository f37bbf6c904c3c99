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
// cdft replaces _cdft_call (dft.py:75), forward-truncated or padded-inverse
// as its operand says; it has no model path.
//
// What bounds them on an H100. fno3d at B=8 is S = 16,384 slabs of 64×64:
// the rdft moves ≈ 302 MB in f32 (x read, the pair written), 0.090 ms at
// 3.35 TB/s. The dense Kronecker product did 34.4e9 multiply-adds (1.03 ms
// at the 67 TFLOP/s f32 CUDA-core rate); the two separable stages do 3.2e9
// (0.096 ms), so bytes and operations sit side by side. The irdft is the
// mirror image. At fno2d (65,536 rows of 128 → 32 modes) the rdft moves
// 50 MB (0.015 ms) for 0.54e9 multiply-adds (0.016 ms in f32). The cdft at
// fno2d B=8 (16,384 rows, 128 → 32) moves 21 MB (6.3 µs) for 67.1e6
// complex multiply-adds: 8.0 µs on the CUDA cores, so an FFMA kernel is
// bound by its operations; as three TF32 passes on the tensor cores they
// take 3.3 µs and the bytes bound it.
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
//   cdft:  one real product on the tensor cores, [xr | xi]·[[Fr, Fi],
//          [−Fi, Fr]] = [yr | yi] (mma.sync: f32 as 3xTF32, bf16 as it
//          is; tc_common.cuh), the stacked operand copied into shared
//          memory once per block by cp.async beside the first group (64
//          KB at 128 × 32 in f32; the −Fi block negated in place).
// In rdft and irdft the f32 products run on the CUDA cores (FFMA), each
// thread keeping an 8 × 8 (or 8 × 4) tile in registers fed by 16-byte
// shared-memory loads. In bf16 every product whose operands are bf16 in
// memory (stage A; the rank-2 inverse) runs on the tensor cores (mma, bf16
// in, f32 accumulate); products of the f32 intermediate stay on the CUDA
// cores. The launch sizes a group to the shared memory, up to the
// wrapper's cap (kernels/dft.py MAX_GROUP_ROWS); a slab (a cdft row) over
// the budget is refused, by the wrapper and by the launch. Ragged extents
// are zero-padded in shared memory.
// Measured on an H100 (PERF.md §6, rows 4 and 6), the stages and not the
// bytes set the pace: fno3d B=8 f32 rdft 0.30 ms and irdft 0.28 against
// the 0.090 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "fno_common.cuh"
#include "tc_common.cuh"

namespace {

using fno::ld;
using fno::st;
using tc::align128;
using tc::aligned16;
using tc::async_commit;
using tc::async_wait_one;
using tc::from_f32;
using tc::kSmemLimit;
using tc::pad_to;
using tc::to_f32;

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float smem[];
  return smem;
}

// ---------------------------------------------------------------------------
// rdft / irdft: separable stages on slab groups resident in shared memory.
// ---------------------------------------------------------------------------
constexpr int kRowThreads = 256;
constexpr int kRM = 8;         // rows per thread of the FFMA product
constexpr int kSplit = 4;      // lanes that share one tile of stage B
constexpr int kMmaTile = 16;  // the tensor-core products' tile
constexpr int kSmemSlack = 128;     // the base rounded up to 128 bytes

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
// stacked last-axis factor [F3r | F3i] [kp][ldb] (bf16 for the tensor
// cores, else f32),
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
// [E3r ; −E3i] [kp][ldb] (rows [0, hb), [hb, 2hb); bf16 for mma, else
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

// cdft at rows of n3 points and k3 outputs, in groups of g: input buffers
// [mp][lda] (T; xr at column 0, xi at column hb), the stacked operand
// [[Fr, Fi], [−Fi, Fr]] [kp = 2hb][ldb] (T; the xi rows from row hb, the
// yi columns from column hc) and C [mp][ldc] f32 (yr, then yi at column
// hc). hb is n3 padded to the tensor cores' depth, hc k3 padded to 16.
__host__ __device__ inline Layout cdft_layout(int esize, int g, int n3,
                                              int k3) {
  Layout L = {};
  L.mp = pad_to(g, kMmaTile);
  L.hb = pad_to(n3, esize == 2 ? 16 : 8);
  L.kp = 2 * L.hb;
  L.hc = pad_to(k3, kMmaTile);
  L.np = 2 * L.hc;
  L.lda = L.kp + 16 / esize;
  L.ldb = L.np + 8;
  L.ldc = L.np + 4;
  L.in0 = 0;
  L.in1 = align128(1LL * L.mp * L.lda * esize);
  L.opb = align128(L.in1 + 1LL * L.mp * L.lda * esize);
  L.c = align128(L.opb + 1LL * L.kp * L.ldb * esize);
  L.bytes = align128(L.c + 4LL * L.mp * L.ldc);
  return L;
}

enum RowKind { kRdft = 0, kIrdft = 1, kCdft = 2 };

template <typename T>
struct RowArgs {
  const T* in_r;   // rdft: x [S, n2, n3]; irdft: the pair [S, k3, k2];
  const T* in_i;   // cdft: the pair [S, n3] (in_i: irdft and cdft)
  const T* m3r;    // last-axis factor pair: rdft and cdft [n3, k3],
  const T* m3i;    // irdft [k3, n3]
  const T* m2r;    // outer-axis factor pair (rank 3): rdft [n2, k2],
  const T* m2i;    // irdft [k2, n2]
  T* out_r;        // rdft: the pair [S, k3, k2]; irdft: y [S, n2, n3];
  T* out_i;        // cdft: the pair [S, k3]
  int slabs, n2, n3, k2, k3, group;
  int vec_in;      // the input rows are copied in 16-byte pieces
  int vec_out;     // the output rows are written in 4-element pieces
  int vec_op;      // cdft: the operand rows are copied in 16-byte pieces
  Layout L;
};

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

// Copy `nrows` contiguous rows of `len` elements into dst rows `ld` apart.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int nrows, int len, bool vec) {
  tc::load_tile(dst, ld, src, len, nrows, len, vec, kRowThreads);
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

// The same product on the tensor cores with T operands in shared memory
// and f32 C (bf16 as it is, f32 as 3xTF32: tc_common.cuh): a warp takes a
// 16kM-row by 8kN-column tile of C, so each A fragment feeds kN products
// and each B fragment kM. mp and np are multiples of 16, kp of the depth.
template <typename T, int kM, int kN>
__device__ __forceinline__ void product_tc_tiles(const T* A, int lda,
                                                 const T* B, int ldb,
                                                 float* C, int ldc, int mp,
                                                 int kp, int np) {
  const int nct = np / (8 * kN);
  const int items = (mp / (16 * kM)) * nct;
  for (int t = threadIdx.x / 32; t < items; t += kRowThreads / 32) {
    const int r0 = (t / nct) * 16 * kM, c0 = (t % nct) * 8 * kN;
    float acc[kM][kN][4] = {};
    tc::warp_product<T, kM, kN>(acc, A + r0 * lda, lda, B + c0, ldb, kp);
    tc::store_acc<kM, kN>(C + r0 * ldc + c0, ldc, acc);
  }
}

// The largest warp tile that still gives every warp one.
template <typename T>
__device__ __forceinline__ void product_tc(const T* A, int lda, const T* B,
                                           int ldb, float* C, int ldc,
                                           int mp, int kp, int np) {
  constexpr int kWarps = kRowThreads / 32;
  if (mp % 32 == 0 && np % 32 == 0 && (mp / 32) * (np / 32) >= kWarps) {
    product_tc_tiles<T, 2, 4>(A, lda, B, ldb, C, ldc, mp, kp, np);
  } else if (mp % 32 == 0 && (mp / 32) * (np / 16) >= kWarps) {
    product_tc_tiles<T, 2, 2>(A, lda, B, ldb, C, ldc, mp, kp, np);
  } else {
    product_tc_tiles<T, 1, 2>(A, lda, B, ldb, C, ldc, mp, kp, np);
  }
}

// The group's rows of C's two halves (columns [0, k) and [hc, hc + k)) to
// rows row0.. of the pair's planes, rows k apart: 4-element pieces when
// vec.
template <typename T>
__device__ __forceinline__ void store_pair(T* out_r, T* out_i,
                                           const float* cs, int ldc, int hc,
                                           long long row0, int cnt, int k,
                                           bool vec) {
  if (vec) {
    const int q = k / 4;
    for (int t = threadIdx.x; t < 2 * cnt * q; t += kRowThreads) {
      const int p = t / (cnt * q), r = (t / q) % cnt, c = 4 * (t % q);
      st4((p ? out_i : out_r) + (row0 + r) * k + c,
          *reinterpret_cast<const float4*>(cs + r * ldc + p * hc + c));
    }
  } else {
    for (int t = threadIdx.x; t < 2 * cnt * k; t += kRowThreads) {
      const int p = t / (cnt * k), r = (t / k) % cnt, c = t % k;
      st((p ? out_i : out_r) + (row0 + r) * k + c, cs[r * ldc + p * hc + c]);
    }
  }
}

// The dynamic shared memory rounded up to 128 bytes by an offset: a
// pointer cast to an integer and back would lose the shared state space,
// and the accesses through it outside the products' explicit loads (the
// staging of C, the operand's padding and sign) would be generic ones.
__device__ __forceinline__ char* smem_base() {
  char* p = reinterpret_cast<char*>(dyn_smem());
  return p + ((128 - (reinterpret_cast<uintptr_t>(p) & 127)) & 127);
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
      product_tc(xs[it & 1], L.lda, bs, L.ldb, cs, L.ldc, L.mp, L.kp, L.np);
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
    } else {
      // Rank 2: the rows of C's two halves are the pair's rows.
      store_pair(a.out_r, a.out_i, cs, L.ldc, L.hc, slab0, cnt, k3,
                 a.vec_out);
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
      product_tc(zs, L.in_ld, bs, L.ldb, cs, L.ldc, L.mp, L.kp, L.np);
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

// cdft: (yr | yi) = [xr | xi]·[[Fr, Fi], [−Fi, Fr]] a group of rows at a
// time, one real product on the tensor cores with the stacked operand
// resident in shared memory.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) cdft_kernel(
    const RowArgs<T> a) {
  const Layout& L = a.L;
  char* base = smem_base();
  T* xs[2] = {reinterpret_cast<T*>(base + L.in0),
              reinterpret_cast<T*>(base + L.in1)};
  T* bs = reinterpret_cast<T*>(base + L.opb);
  float* cs = reinterpret_cast<float*>(base + L.c);
  const int tid = threadIdx.x;
  const int n = a.n3, k = a.k3, G = a.group;
  const int ngroups = (a.slabs + G - 1) / G;
  const long long group_len = static_cast<long long>(G) * n;
  // Both planes of a group: xr at column 0, xi at column hb.
  auto load_group = [&](T* dst, int grp) {
    const int nrows = min(G, a.slabs - grp * G);
    load_rows(dst, L.lda, a.in_r + grp * group_len, nrows, n, a.vec_in);
    load_rows(dst + L.hb, L.lda, a.in_i + grp * group_len, nrows, n,
              a.vec_in);
  };
  // The stacked operand, copied beside the first group: Fr on the diagonal
  // blocks, Fi above it (xr·Fi into yi) and below it, negated once landed
  // (−xi·Fi into yr).
  T* const neg_fi = bs + L.hb * L.ldb;
  load_rows(bs, L.ldb, a.m3r, n, k, a.vec_op);
  load_rows(bs + L.hc, L.ldb, a.m3i, n, k, a.vec_op);
  load_rows(neg_fi, L.ldb, a.m3i, n, k, a.vec_op);
  load_rows(neg_fi + L.hc, L.ldb, a.m3r, n, k, a.vec_op);
  int g = blockIdx.x;
  load_group(xs[0], g);
  async_commit();
  // Meanwhile zero the padding of the operand (rows past n, columns past
  // k of each block) and of both input planes (columns past n): the
  // copies never touch it.
  if (n < L.hb || k < L.hc) {
    for (int i = tid; i < L.kp * L.np; i += kRowThreads) {
      const int r = i / L.np, c = i % L.np;
      if ((r < L.hb ? r : r - L.hb) >= n || (c < L.hc ? c : c - L.hc) >= k) {
        bs[r * L.ldb + c] = from_f32<T>(0.f);
      }
    }
  }
  const int padc = L.hb - n;
  for (int i = tid; i < 2 * L.mp * 2 * padc; i += kRowThreads) {
    const int r = i / (2 * padc), c = i % (2 * padc);
    const int col = (c < padc ? 0 : L.hb) + n + c % padc;
    xs[r / L.mp][(r % L.mp) * L.lda + col] = from_f32<T>(0.f);
  }
  tc::async_wait_all();
  __syncthreads();
  for (int i = tid; i < n * k; i += kRowThreads) {
    T* v = neg_fi + (i / k) * L.ldb + i % k;
    *v = from_f32<T>(-to_f32(*v));
  }
  for (int it = 0; g < ngroups; ++it, g += gridDim.x) {
    const int gn = g + gridDim.x;
    if (gn < ngroups) load_group(xs[(it + 1) & 1], gn);
    async_commit();
    async_wait_one();
    __syncthreads();
    product_tc(xs[it & 1], L.lda, bs, L.ldb, cs, L.ldc, L.mp, L.kp, L.np);
    __syncthreads();
    store_pair(a.out_r, a.out_i, cs, L.ldc, L.hc,
               static_cast<long long>(g) * G, min(G, a.slabs - g * G), k,
               a.vec_out);
  }
}

Layout row_layout(int kind, int esize, bool outer, int g, int n2, int n3,
                  int k2, int k3) {
  if (kind == kCdft) return cdft_layout(esize, g, n3, k3);
  return kind == kIrdft ? irdft_layout(esize, outer, g, n2, n3, k2, k3)
                        : rdft_layout(esize, outer, g, n2, n3, k2, k3);
}

// The group of a launch: the most slabs (cdft rows), up to max_group and
// the slab count, whose block fits kSmemLimit; 0 when one does not fit.
int pick_group(int kind, int esize, bool outer, int max_group, int slabs,
               int n2, int n3, int k2, int k3) {
  for (int g = std::max(1, std::min(max_group, slabs)); g >= 1; --g) {
    if (row_layout(kind, esize, outer, g, n2, n3, k2, k3).bytes +
            kSmemSlack <= kSmemLimit) {
      return g;
    }
  }
  return 0;
}

// One launch over `slabs` slabs in groups of at most max_group slabs.
template <typename T, int kKind, bool kOuter>
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
      pick_group(kKind, kE, kOuter, max_group, slabs, n2, n3, k2, k3);
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
  a.L = row_layout(kKind, kE, kOuter, group, n2, n3, k2, k3);
  const long long smem = a.L.bytes + kSmemSlack;
  const int in_len = kKind == kIrdft ? (kOuter ? k2 : k3) : n3;
  a.vec_in = (in_len * kE) % 16 == 0 && aligned16(in_r) && aligned16(in_i);
  const int out_len = kKind == kIrdft ? n3 : k3;
  a.vec_out = out_len % 4 == 0 && aligned16(out_r) && aligned16(out_i);
  a.vec_op = (k3 * kE) % 16 == 0 && aligned16(m3r) && aligned16(m3i);
  if (a.L.direct && !a.vec_out) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const RowArgs<T>) =
      kKind == kCdft    ? cdft_kernel<T>
      : kKind == kIrdft ? irdft_kernel<T, kOuter>
                        : rdft_kernel<T, kOuter>;
  int blocks = 0;
  cudaError_t err = tc::resident_blocks(
      reinterpret_cast<const void*>(kernel), kRowThreads, smem, &blocks);
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

template <int kKind>
int dispatch_rows(int dtype, const void* in_r, const void* in_i,
                  const void* m3r, const void* m3i, const void* m2r,
                  const void* m2i, void* out_r, void* out_i, int slabs,
                  int n2, int n3, int k2, int k3, int max_group,
                  void* stream) {
  const bool outer = kKind != kCdft && m2r != nullptr;
  if (dtype == 0) {
    return outer ? launch_rows<float, kKind, true>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream)
                 : launch_rows<float, kKind, false>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream);
  }
  if (dtype == 1) {
    return outer ? launch_rows<__nv_bfloat16, kKind, true>(
                       in_r, in_i, m3r, m3i, m2r, m2i, out_r, out_i, slabs,
                       n2, n3, k2, k3, max_group, stream)
                 : launch_rows<__nv_bfloat16, kKind, false>(
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
  return dispatch_rows<kRdft>(dtype, x, nullptr, f3r, f3i, f2r, f2i, zr, zi,
                              slabs, n2, n3, k2, k3, max_group, stream);
}

// (zr, zi) [S, k3, k2], (e3r, e3i) [k3, n3] (hermitian folded), (e2r, e2i)
// [k2, n2] or null (rank 2) -> y [S, n2, n3].
extern "C" int dft_rows_irdft(int dtype, const void* zr, const void* zi,
                              const void* e3r, const void* e3i,
                              const void* e2r, const void* e2i, void* y,
                              int slabs, int n2, int n3, int k2, int k3,
                              int max_group, void* stream) {
  return dispatch_rows<kIrdft>(dtype, zr, zi, e3r, e3i, e2r, e2i, y, nullptr,
                               slabs, n2, n3, k2, k3, max_group, stream);
}

// (xr, xi) [M,N], (fr, fi) [N,K] -> (yr, yi) [M,K]; groups of at most
// `max_group` rows.
extern "C" int dft_rows_cdft(int dtype, const void* xr, const void* xi,
                             const void* fr, const void* fi, void* yr,
                             void* yi, int M, int N, int K, int max_group,
                             void* stream) {
  return dispatch_rows<kCdft>(dtype, xr, xi, fr, fi, nullptr, nullptr, yr, yi,
                              M, 1, N, 1, K, max_group, stream);
}

// The group a launch of `kind` (0 rdft, 1 irdft, 2 cdft) takes (0: one
// slab or row over the budget), and the dynamic shared memory of one block
// of `group` slabs: the wrapper's one-slab refusal (kernels/dft.py
// smem_bytes) mirrors the latter.
extern "C" int dft_rows_group(int kind, int dtype, int outer, int max_group,
                              int slabs, int n2, int n3, int k2, int k3) {
  return pick_group(kind, dtype == 1 ? 2 : 4, outer != 0, max_group, slabs,
                    n2, n3, k2, k3);
}

extern "C" long long dft_rows_smem(int kind, int dtype, int outer, int group,
                                   int n2, int n3, int k2, int k3) {
  return row_layout(kind, dtype == 1 ? 2 : 4, outer != 0, group, n2, n3, k2,
                    k3).bytes +
         kSmemSlack;
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* dft_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
