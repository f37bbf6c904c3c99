// Helpers shared by the row DFT kernels (dft_rows.cu), the complex product
// (cgemm.cu), the tensor-core DFT chain (chain_tc.cuh, fused_wgrad.cu) and
// the partial-fusion core (fused_core.cu): padding and alignment, element
// conversions, cp.async copies into shared memory, products on the tensor
// cores, and the resident blocks of a persistent launch.
//
// Tensor-core products (mma.sync, f32 accumulate), one warp's tile of
// 16-row by 8-column pieces from operands in shared memory. bf16 runs the
// m16n8k16 bf16 shape as it is. f32 runs the m16n8k8 TF32 shape three
// times (3xTF32): each operand element a is split into hi, a with its low
// 13 mantissa bits cleared (a TF32 value), and the rest lo = a − hi
// (exact, at most 2^-10 of a), and acc += lo_a·hi_b + hi_a·lo_b +
// hi_a·hi_b, the small terms first. The tensor cores read a TF32
// operand's 19 high bits, so lo enters truncated, within 2^-20 of a.
// One TF32 pass keeps about three digits, short of the port's 2e-4 f32
// tolerance; three keep the product within a few 2^-20 (the dropped
// lo_a·lo_b and the truncations), on a par with f32 FFMA over these
// depths. Splitting by truncation takes one instruction; rounding hi to
// nearest (__float_to_tf32) takes four, and the launches ran slower with
// it on an H100. Three passes at 495 TFLOP/s are 165 TFLOP/s of
// f32-accurate work, 2.5× the CUDA cores' 67. The low parts live in
// registers only: shared memory holds each f32 operand once.
//
// Fragments are read with explicit shared-memory loads (ld.shared, and
// ldmatrix.trans for bf16 B) from per-lane offsets computed once: wmma's
// loads from a pointer the compiler cannot place in shared memory compile
// to generic 64-bit loads with their address arithmetic, which held the
// products to a small fraction of the tensor cores' rate. Compiled for the
// host (the tests' CPU emulation, CUDA_EMULATION), the loads read memory
// and the products call the emulation's warp-wide mma.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#ifdef CUDA_EMULATION
#include <mma.h>  // the emulated tensor-core products
#endif

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

namespace tc {

constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kTile = 16;           // rows of one tensor-core product

__host__ __device__ constexpr int pad_to(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr long long align128(long long v) {
  return (v + 127) / 128 * 128;
}

__host__ __device__ inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

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

// N bytes (4, 8 or 16) from device to shared memory, asynchronously
// (cp.async; a plain copy where the source is compiled for the host).
template <int N = 16>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async moves 4, 8 or 16 B");
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {  // around L1
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N)
                 : "memory");
  }
#else
  std::memcpy(dst, src, N);
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

// Wait until every committed copy of this thread has landed.
__device__ __forceinline__ void async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Copy `rows` rows of `len` elements (src rows `src_ld` apart) into dst
// rows `ld` apart, the block's `nthreads` threads in turn: 16-byte cp.async
// pieces when `vec` (len, src_ld and the addresses in whole pieces), else
// one element per thread and step.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long src_ld, int rows,
                                          int len, bool vec, int nthreads) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int per_row = len / kE;
    for (int c = threadIdx.x; c < rows * per_row; c += nthreads) {
      const int r = c / per_row, j = (c - r * per_row) * kE;
      copy_async(dst + r * ld + j, src + r * src_ld + j);
    }
  } else {
    for (int i = threadIdx.x; i < rows * len; i += nthreads) {
      const int r = i / len;
      dst[r * ld + i - r * len] = src[r * src_ld + i - r * len];
    }
  }
}

// The tensor cores' depth of one product: 16 bf16 or 8 TF32 elements.
template <typename T>
__host__ __device__ constexpr int depth() {
  return std::is_same<T, float>::value ? 8 : 16;
}

// Shared-memory loads: 32 bits at p, which points into shared memory.
__device__ __forceinline__ unsigned lds32(const void* p) {
#ifdef __CUDA_ARCH__
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
#else
  unsigned v;
  std::memcpy(&v, p, 4);
  return v;
#endif
}

// 16 bits at p, which points into shared memory, in the low half.
__device__ __forceinline__ unsigned lds16(const void* p) {
#ifdef __CUDA_ARCH__
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n"
               : "=h"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
#else
  unsigned short v;
  std::memcpy(&v, p, 2);
  return v;
#endif
}

// hi = v with its 13 low mantissa bits cleared (a TF32 value) and lo =
// v − hi (exact), as the bits the tensor cores read.
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi,
                                           unsigned& lo) {
  hi = v & ~0x1FFFu;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
}

// d += a·b, one m16n8k8 TF32 product (a: 4 registers, b: 2).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(CUDA_EMULATION)
  emulated_mma_tf32(d, a, b);
#endif
}

// d += a·b, one m16n8k16 bf16 product (a: 4 registers of 2, b: 2 of 2).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(CUDA_EMULATION)
  emulated_mma_bf16(d, a, b);
#endif
}

// The A fragment of the 16 × depth tile at p (row-major, rows ld apart),
// lane (g, t) = (lane / 4, lane % 4): TF32 (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); bf16 the pairs at columns 2t and 2t + 8 of rows g, g + 8.
template <typename T>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const T* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  constexpr int kStep = std::is_same<T, float>::value ? 1 : 2;
  const T* q = p + g * ld + kStep * t;
  a[0] = lds32(q);
  a[1] = lds32(q + 8 * ld);
  a[2] = lds32(q + 4 * kStep);
  a[3] = lds32(q + 8 * ld + 4 * kStep);
}

// The B fragment of the depth × 8 tile at p (row-major [k][n], rows ld
// apart): TF32 (t, g), (t + 4, g); bf16 the pairs (2t, 2t + 1) and
// (2t + 8, 2t + 9) of column g, by ldmatrix.trans (rows 16-byte aligned).
__device__ __forceinline__ void load_b(unsigned (&b)[2], const float* p,
                                       int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b[0] = lds32(p + t * ld + g);
  b[1] = lds32(p + (t + 4) * ld + g);
}
__device__ __forceinline__ void load_b(unsigned (&b)[2],
                                       const __nv_bfloat16* p, int ld) {
#ifdef __CUDA_ARCH__
  const unsigned row = static_cast<unsigned>(
      __cvta_generic_to_shared(p + (threadIdx.x & 15) * ld));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(row));
#else
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  unsigned short e[4];
  for (int i = 0; i < 4; ++i) {
    const int k = 2 * t + (i & 1) + 8 * (i >> 1);
    std::memcpy(&e[i], p + k * ld + g, 2);
  }
  b[0] = e[0] | static_cast<unsigned>(e[1]) << 16;
  b[1] = e[2] | static_cast<unsigned>(e[3]) << 16;
#endif
}

// The B fragment of the depth × 8 tile whose transpose is at p (row-major
// [n][k], rows ld apart: B column g is row g of p): TF32 (t, g), (t + 4,
// g); bf16 the pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of column g, each
// one 32-bit load.
template <typename T>
__device__ __forceinline__ void load_bt(unsigned (&b)[2], const T* p,
                                        int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  constexpr int kStep = std::is_same<T, float>::value ? 1 : 2;
  const T* q = p + g * ld + kStep * t;
  b[0] = lds32(q);
  b[1] = lds32(q + 4 * kStep);
}

// An operand fragment as the products take it: bf16 as loaded (lo
// unused); f32 split into hi (in place) and lo.
template <typename T, int N>
struct Frag {
  unsigned hi[N], lo[N];
};

template <typename T, int N>
__device__ __forceinline__ void split(Frag<T, N>& f) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < N; ++e) split_tf32(f.hi[e], f.hi[e], f.lo[e]);
  }
}

// d += a·b: one bf16 product, or f32 as three TF32 products, the small
// terms first.
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const Frag<T, 4>& a,
                                    const Frag<T, 2>& b) {
  if constexpr (std::is_same<T, float>::value) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  } else {
    mma_bf16(d, a.hi, b.hi);
  }
}

// acc[i][j] += A[16i.., 0..kp)·B[0..kp), 8j..]: one warp's 16kM × 8kN tile
// of C = A·B, A row-major (rows lda apart), B row-major [k][n] (rows ldb
// apart), both in shared memory; kp a multiple of the depth.
template <typename T, int kM, int kN>
__device__ __forceinline__ void warp_product(float (&acc)[kM][kN][4],
                                             const T* A, int lda, const T* B,
                                             int ldb, int kp) {
  for (int k = 0; k < kp; k += depth<T>()) {
    Frag<T, 4> a[kM];
    Frag<T, 2> b[kN];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      load_a(a[i].hi, A + 16 * i * lda + k, lda);
      split(a[i]);
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      load_b(b[j].hi, B + k * ldb + 8 * j, ldb);
      split(b[j]);
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) {
#pragma unroll
      for (int j = 0; j < kN; ++j) mma<T>(acc[i][j], a[i], b[j]);
    }
  }
}

// The warp's tile of C to shared memory (rows ldc apart), f32.
template <int kM, int kN>
__device__ __forceinline__ void store_acc(float* C, int ldc,
                                          const float (&acc)[kM][kN][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float* c = C + (16 * i + g) * ldc + 8 * j + 2 * t;
      c[0] = acc[i][j][0];
      c[1] = acc[i][j][1];
      c[8 * ldc] = acc[i][j][2];
      c[8 * ldc + 1] = acc[i][j][3];
    }
  }
}

// Resident blocks of `kernel` on the current card at `threads` threads and
// `smem` bytes (blocks a multiprocessor × multiprocessors), queried once
// per (kernel, card, threads, smem) and kept: the launches of a model
// repeat a handful of shapes. The first query of a (kernel, card) raises
// its dynamic shared-memory limit to kSmemLimit, so every later launch of
// it fits.
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   long long smem, int* blocks) {
  struct Entry {
    const void* kernel;
    int dev, threads;
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
    if (cache[i].smem == smem && cache[i].threads == threads) {
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
      &per_sm, kernel, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = std::max(per_sm, 1) * sms;
  if (used < 64) cache[used++] = {kernel, dev, threads, smem, *blocks};
  return cudaSuccess;
}

}  // namespace tc
