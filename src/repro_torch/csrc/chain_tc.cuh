// The truncated forward DFT chain of real channels on the tensor cores
// (sm_90a): the spectra A[c][k] (k = k_1·Kp + k', Kp = Π k_2..k_R, as
// fno::forward_chain lays them out) of `nch` channels src[c][s_1..s_R],
// channel after channel, streamed over chunks of s_1 rows:
//
//   stage A, axis s_R (real input):   T = x·[F_Rr | F_Ri], a real product
//            with T operands (bf16 runs bf16 products, f32 three TF32
//            passes; tc_common.cuh), the stacked factor resident;
//   stage B, axis s_2 (rank 3; complex): Z[s_1][(k_2, k_3)] = Σ_s2 T ⋆ F_2;
//   stage C, axis s_1 (complex): A[(k_2, k_3)][k_1] += Σ_s1 Z ⋆ F_1,
//            accumulated in registers over the channel's chunks.
//
// Every product runs on mma.sync with its operands in shared memory. The
// complex stages (B and C, on f32 intermediates: 3xTF32) take their input
// In with the real part at column m and the imaginary part at column
// off_i + m of each row s, and a factor whose rows s are [F_r | F_i]: one
// m16n8k8 step covers four complex terms, its depth running (re s0..s0+3,
// im s0..s0+3), so the factor needs no stacked [[F_r, F_i], [−F_i, F_r]]
// copy — the lane that feeds an imaginary input to a real output negates
// its F_i element. The factors are copied into shared memory once per
// chain (cp.async where their element type is the stage's; bf16 factors of
// the f32 stages are widened on the way), the chunks of x are
// double-buffered by cp.async, and stage B's output rows pass stage C in
// groups of four s_1 rows through a ring, so a chunk may hold any number
// of rows. A stage with fewer 16 × 8 tiles than warps splits each tile's
// depth over several warps, whose partials meet in a fixed order; a warp
// interleaves two depth steps, and f32's two small TF32 terms accumulate
// apart from the big one, so its products overlap. Tile and row indices
// are decoded by multiply-shift (Div): the chunks are small (one s_1 row
// at fno3d, where the spectra take 131 KB), so each stage's few products
// per warp sit between barriers and the decoding is on the critical path.
// At rank 1 the channels are the rows of one real product whose depth is
// the points, the factor's rows streamed beside x. Ragged extents are zero
// in shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fno_common.cuh"
#include "tc_common.cuh"

namespace chain {

constexpr int kWarps = fno::kThreads / 32;
constexpr int kMaxAcc = 4;  // accumulating tiles a warp holds in registers

// n / d and n % d for 0 ≤ n < 2^31 by a multiply-high and a shift (the
// divisors of a call are fixed before its loops; a division by a variable
// is a long chain of dependent instructions on the card).
struct Div {
  int d;
  unsigned m, s;
  __host__ __device__ explicit Div(int v) : d(v), m(0), s(0) {
    if (v > 1) {
      int l = 0;
      while ((1 << l) < v) ++l;  // ceil(log2 v)
      m = static_cast<unsigned>(((1ull << (31 + l)) + v - 1) / v);
      s = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n), m) >>
                                     s);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * d; }
};

// How many warps split the depth of each of `tiles` output tiles of a
// stage (of `steps` depth steps): 1 where every warp has a tile.
__host__ __device__ inline int depth_splits(int tiles, int steps) {
  if (tiles >= kWarps) return 1;
  const int s = kWarps / tiles;
  return s < steps ? s : steps;
}

// Shared-memory layout of the chain's work area (byte offsets from its
// base, regions 128-B aligned) and the padded extents of its products.
struct Layout {
  int nr;           // s_1 rows per chunk (rank 1: points per chunk)
  int xrows, ldx;   // an input buffer's rows (stage A's M) and ld
  int da;           // stage A's depth: n_R (rank 1: nr) padded
  int ha, ldfa;     // stage A's factor: half width (k_R padded to 8), ld
  int h2, ld2, d2;  // rank 3, F_2 rows: half width, ld, rows (n_2 to 4)
  int h1, ld1, d1;  // F_1 rows (rank ≥ 2): half width, ld, rows
  int mb, ldt;      // rank 3: stage B's M (nr·ha padded to 16), T's ld
  int mz, ldz, zcap;  // stage C's M, the ring's ld and rows
  long long fa, x0, x1, f1, z, f2, t, pb, bytes;
};

// The layout at rank R for elements of `esize` bytes, extents n[0..R) and
// modes k[0..R) (axis order 1..R), `nr` rows (points) a chunk and, at rank
// 1, `nch` channels a call. Mirrored by kernels/engine.py _chain_bytes.
__host__ __device__ inline Layout layout(int R, int esize, const int* n,
                                         const int* k, int nr, int nch) {
  using tc::align128;
  using tc::pad_to;
  const int dep = esize == 2 ? 16 : 8;   // stage A's tensor-core depth
  const int xpad = esize == 2 ? 8 : 4;   // conflict-free A fragments
  Layout L = {};
  L.nr = nr;
  L.ha = pad_to(k[R - 1], 8);
  L.ldfa = 2 * L.ha + 8;
  if (R == 1) {  // x [channels][points] and the factor rows, both streamed
    L.xrows = pad_to(nch, 16);
    L.da = pad_to(nr, dep);
    L.ldx = L.da + xpad;
    const long long xb = align128(1LL * L.xrows * L.ldx * esize);
    const long long fb = align128(1LL * L.da * L.ldfa * esize);
    L.x1 = xb;
    L.fa = 2 * xb;  // two buffers, fb apart
    L.bytes = 2 * xb + 2 * fb;
    return L;
  }
  L.da = pad_to(n[R - 1], dep);
  L.ldx = L.da + xpad;
  L.xrows = pad_to(R == 3 ? nr * n[1] : nr, 16);
  L.h1 = pad_to(k[0], 8);
  L.ld1 = 2 * L.h1 + 8;
  L.d1 = pad_to(n[0], 4);
  L.zcap = pad_to(nr + 3, 4);
  L.mz = pad_to((R == 3 ? k[1] : 1) * L.ha, 16);
  L.ldz = 2 * L.mz + 8;
  long long at = 0;
  L.fa = at;
  at = align128(at + 1LL * L.da * L.ldfa * esize);
  L.x0 = at;
  at = align128(at + 1LL * L.xrows * L.ldx * esize);
  L.x1 = at;
  at = align128(at + 1LL * L.xrows * L.ldx * esize);
  L.f1 = at;
  at = align128(at + 4LL * L.d1 * L.ld1);
  L.z = at;
  at = align128(at + 4LL * L.zcap * L.ldz);
  if (R == 3) {
    L.h2 = pad_to(k[1], 8);
    L.ld2 = 2 * L.h2 + 8;
    L.d2 = pad_to(n[1], 4);
    L.mb = pad_to(nr * L.ha, 16);
    L.ldt = 2 * L.mb + 8;
    L.f2 = at;
    at = align128(at + 4LL * L.d2 * L.ld2);
    L.t = at;
    at = align128(at + 4LL * L.d2 * L.ldt);
  }
  // The partial tiles of the warps that split a stage's depth (split_tiles).
  const int ta = (L.xrows / 16) * (2 * L.ha / 8);
  int parts = (depth_splits(ta, L.da / dep) - 1) * ta;
  if (R == 3) {
    const int tb = (L.mb / 16) * (2 * L.h2 / 8);
    const int pb = (depth_splits(tb, L.d2 / 4) - 1) * tb;
    parts = parts > pb ? parts : pb;
  }
  L.pb = at;
  at = align128(at + 512LL * parts);
  L.bytes = at;
  return L;
}

// Tiles (16 × 8) of stage C's accumulator (rank 1: of the one product),
// which the kMaxAcc tiles of kWarps warps must hold.
__host__ __device__ inline int acc_tiles(int R, const Layout& L) {
  return R == 1 ? (L.xrows / 16) * (2 * L.ha / 8)
                : (L.mz / 16) * (2 * L.h1 / 8);
}

// d[i] += a[i]·b[i] for N independent steps: bf16 one product each; f32
// three TF32 passes, the big one into d[i] and the two small ones into s[i]
// (the caller adds s to d once). The products are issued step-interleaved:
// the statements issue in program order, and a product waits for the one
// before it on the same accumulator.
template <typename T, int N>
__device__ __forceinline__ void mma_steps(float (&d)[N][4], float (&s)[N][4],
                                          const tc::Frag<T, 4> (&a)[N],
                                          const tc::Frag<T, 2> (&b)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) tc::mma_tf32(d[i], a[i].hi, b[i].hi);
#pragma unroll
    for (int i = 0; i < N; ++i) tc::mma_tf32(s[i], a[i].lo, b[i].hi);
#pragma unroll
    for (int i = 0; i < N; ++i) tc::mma_tf32(s[i], a[i].hi, b[i].lo);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) tc::mma_bf16(d[i], a[i].hi, b[i].hi);
  }
}

// The 16 × 8 tile d += A[16 × kp]·B[kp × 8] of a real product (A row-major,
// rows lda apart; B row-major [k][n], rows ldb apart, or with kBt its
// transpose [n][k]) over the depth steps k0, k0 + kstep, … below kp, two at
// a time in separate accumulators so that their products overlap; kp, k0
// and kstep multiples of the depth.
template <typename T, bool kBt = false>
__device__ __forceinline__ void tile_product(float (&d)[4], const T* A,
                                             int lda, const T* B, int ldb,
                                             int kp, int k0 = 0,
                                             int kstep = tc::depth<T>()) {
  float acc[2][4] = {}, sml[2][4] = {};
  auto frags = [&](int k, tc::Frag<T, 4>& a, tc::Frag<T, 2>& b) {
    tc::load_a(a.hi, A + k, lda);
    if constexpr (kBt) {
      tc::load_bt(b.hi, B + k, ldb);
    } else {
      tc::load_b(b.hi, B + k * ldb, ldb);
    }
  };
  int k = k0;
  for (; k + kstep < kp; k += 2 * kstep) {
    tc::Frag<T, 4> a[2];
    tc::Frag<T, 2> b[2];
    frags(k, a[0], b[0]);
    frags(k + kstep, a[1], b[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tc::split(a[i]);
      tc::split(b[i]);
    }
    mma_steps<T, 2>(acc, sml, a, b);
  }
  if (k < kp) {
    tc::Frag<T, 4> a[1];
    tc::Frag<T, 2> b[1];
    frags(k, a[0], b[0]);
    tc::split(a[0]);
    tc::split(b[0]);
    mma_steps<T, 1>(reinterpret_cast<float (&)[1][4]>(acc[0]),
                    reinterpret_cast<float (&)[1][4]>(sml[0]), a, b);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    d[e] += (sml[0][e] + acc[0][e]) + (sml[1][e] + acc[1][e]);
}

// The fragments of one depth step (four complex terms) of a complex
// stage's 16 × 8 tile, Σ_{s<4} In(s, m) ⋆ F(s, n) (real part for ho = 0,
// else imaginary), split for the products: in = &In[s0][m0] (real at
// column m, imaginary at off_i + m, rows ldi apart), f = &F[s0][n0]
// ([F_r | F_i], halves off_f apart, rows ldf apart). Depth index t is In's
// real part against F_r (ho 0) or F_i (ho 1), t + 4 its imaginary part
// against −F_i or F_r.
__device__ __forceinline__ void complex_frags(tc::Frag<float, 4>& a,
                                              tc::Frag<float, 2>& b,
                                              const float* in, int ldi,
                                              int off_i, const float* f,
                                              int ldf, int off_f, int ho) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = in + t * ldi + g;
  a.hi[0] = tc::lds32(p);
  a.hi[1] = tc::lds32(p + 8);
  a.hi[2] = tc::lds32(p + off_i);
  a.hi[3] = tc::lds32(p + off_i + 8);
  const float* q = f + t * ldf + g;
  if (ho == 0) {
    b.hi[0] = tc::lds32(q);
    b.hi[1] = tc::lds32(q + off_f) ^ 0x80000000u;  // −F_i
  } else {
    b.hi[0] = tc::lds32(q + off_f);
    b.hi[1] = tc::lds32(q);
  }
  tc::split(a);
  tc::split(b);
}

// v = one complex stage's 16 × 8 tile (ho 0: its real part, 1: its
// imaginary part) over the depth steps st = sp, sp + ss, … below `steps`,
// four complex terms a step: In's rows (the depth) ldi apart from `in`
// (real part at column m, imaginary at off_i + m), the factor's rows
// [F_r | F_i] ldf apart from f (halves off_f apart). Two steps are
// interleaved in separate accumulators, f32's small TF32 terms apart.
__device__ __forceinline__ void complex_tile(float (&v)[4], const float* in,
                                             int ldi, int off_i,
                                             const float* f, int ldf,
                                             int off_f, int ho, int steps,
                                             int sp = 0, int ss = 1) {
  float d[2][4] = {}, sm[2][4] = {};
  tc::Frag<float, 4> fa[2];
  tc::Frag<float, 2> fb[2];
  auto frags = [&](int st, int j) {
    complex_frags(fa[j], fb[j], in + 4 * st * ldi, ldi, off_i,
                  f + 4 * st * ldf, ldf, off_f, ho);
  };
  int st = sp;
  for (; st + ss < steps; st += 2 * ss) {
    frags(st, 0);
    frags(st + ss, 1);
    mma_steps<float, 2>(d, sm, fa, fb);
  }
  if (st < steps) {
    frags(st, 0);
    mma_steps<float, 1>(reinterpret_cast<float (&)[1][4]>(d[0]),
                        reinterpret_cast<float (&)[1][4]>(sm[0]),
                        reinterpret_cast<tc::Frag<float, 4> (&)[1]>(fa),
                        reinterpret_cast<tc::Frag<float, 2> (&)[1]>(fb));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (sm[0][e] + d[0][e]) + (sm[1][e] + d[1][e]);
}

// The f32 bits of an operand element in shared memory (bf16 widened,
// exact in TF32).
__device__ __forceinline__ unsigned bits(const float* p) {
  return tc::lds32(p);
}
__device__ __forceinline__ unsigned bits(const __nv_bfloat16* p) {
  return tc::lds16(p) << 16;
}

// A complex stage's 16 × 8 tile, Σ_s In(m, s) ⋆ F(s, n), runs four complex
// terms a depth step of m16n8k8: depth index t is In's real part of row s0
// + t, t + 4 its imaginary part, against F_r and −F_i (the real half of
// the tile, ho 0) or F_i and F_r (the imaginary half, ho 1), so the factor
// needs no stacked [[F_r, F_i], [−F_i, F_r]] copy. Operands are f32 or
// bf16 in shared memory, read as f32 bits, at any strides, with masked
// rows and columns and either low TF32 part (the partial-fusion core's
// stages). The chains' f32 stages keep complex_frags / complex_tile above:
// built from these loaders, the block and wgrad kernels compiled to other
// code (on an H100 the per-mode wgrad spilled 68 B and ran 3.8 % slower,
// the bf16 projection end 15 %).
//
// In's fragments along the depth: In(m, s) at p[m·sm + s·ss], its
// imaginary part offi further. The lanes' addresses are formed once; lanes
// of rows m ≥ mv read row 0 (every load is unconditional, so the loads of
// a step issue together) and zero it.
template <typename T>
struct AFrag {
  const T* q;
  const T* q8;
  int step, offi;
  bool v0, v8;
  __device__ __forceinline__ AFrag(const T* p, int sm, int ss, int offi_,
                                   int mv) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    v0 = g < mv;
    v8 = g + 8 < mv;
    q = p + t * ss + (v0 ? g * sm : 0);
    q8 = p + t * ss + (v8 ? (g + 8) * sm : 0);
    step = 4 * ss;
    offi = offi_;
  }
  __device__ __forceinline__ void load(unsigned (&a)[4], int st) const {
    const T* x = q + st * step;
    const T* x8 = q8 + st * step;
    const unsigned r0 = bits(x), r1 = bits(x8);
    const unsigned r2 = bits(x + offi), r3 = bits(x8 + offi);
    a[0] = v0 ? r0 : 0u;
    a[1] = v8 ? r1 : 0u;
    a[2] = v0 ? r2 : 0u;
    a[3] = v8 ? r3 : 0u;
  }
};

// The factor's fragments along the depth: F(s, n) at p[s·ss + n·sn], its
// imaginary part offi further; columns n ≥ nv read column 0 and zero it.
template <typename T>
struct BFrag {
  const T* q;
  int step, offi;
  bool v;
  __device__ __forceinline__ BFrag(const T* p, int ss, int sn, int offi_,
                                   int nv) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    v = g < nv;
    q = p + t * ss + (v ? g * sn : 0);
    step = 4 * ss;
    offi = offi_;
  }
  // Both halves: br forms the real part, bi the imaginary part.
  __device__ __forceinline__ void load(unsigned (&br)[2], unsigned (&bi)[2],
                                       int st) const {
    const T* x = q + st * step;
    const unsigned re0 = bits(x), im0 = bits(x + offi);
    const unsigned re = v ? re0 : 0u, im = v ? im0 : 0u;
    br[0] = re;
    br[1] = im ^ 0x80000000u;  // −F_i
    bi[0] = im;
    bi[1] = re;
  }
  __device__ __forceinline__ void load(unsigned (&b)[2], int st,
                                       int ho) const {
    unsigned br[2], bi[2];
    load(br, bi, st);
    b[0] = ho ? bi[0] : br[0];
    b[1] = ho ? bi[1] : br[1];
  }
};

// d += a·b for one step's raw fragments (f32 bits) on the tensor cores:
// the big TF32 pass into d, the small ones (an operand's low part, where it
// has one: kLoA, kLoB) into s, each operand split as the step issues.
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma_bits(float (&d)[4], float (&s)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kLoA) {
      tc::split_tf32(a[e], ah[e], al[e]);
    } else {
      ah[e] = a[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (kLoB) {
      tc::split_tf32(b[e], bh[e], bl[e]);
    } else {
      bh[e] = b[e];
    }
  }
  if (kLoA) tc::mma_tf32(s, al, bh);
  if (kLoB) tc::mma_tf32(s, ah, bl);
  tc::mma_tf32(d, ah, bh);
}

// v = one half (ho) of a complex stage's 16 × 8 tile over the depth steps
// st = sp, sp + ss, … below `steps`, kIn steps in flight in separate
// accumulators (a warp with one tile needs several chains to keep its
// tensor core busy), In's and F's low TF32 parts where kLoA, kLoB.
template <bool kLoA, bool kLoB, int kIn, typename TA, typename TB>
__device__ __forceinline__ void complex_tile(float (&v)[4],
                                             const AFrag<TA>& A,
                                             const BFrag<TB>& B, int ho,
                                             int steps, int sp = 0,
                                             int ss = 1) {
  float d[kIn][4] = {}, sm[kIn][4] = {};
  int st = sp;
  for (; st + (kIn - 1) * ss < steps; st += kIn * ss) {
    unsigned a[kIn][4], b[kIn][2];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      A.load(a[i], st + i * ss);
      B.load(b[i], st + i * ss, ho);
    }
#pragma unroll
    for (int i = 0; i < kIn; ++i)
      mma_bits<kLoA, kLoB>(d[i], sm[i], a[i], b[i]);
  }
  for (; st < steps; st += ss) {
    unsigned a[4], b[2];
    A.load(a, st);
    B.load(b, st, ho);
    mma_bits<kLoA, kLoB>(d[0], sm[0], a, b);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = 0.f;
#pragma unroll
    for (int i = 0; i < kIn; ++i) v[e] += sm[i][e] + d[i][e];
  }
}

// Both halves (vr, vi) of a complex stage's tile over `steps` depth steps
// from one In fragment a step, two steps in flight.
template <bool kLoA, bool kLoB, typename TA, typename TB>
__device__ __forceinline__ void complex_tile_both(float (&vr)[4],
                                                  float (&vi)[4],
                                                  const AFrag<TA>& A,
                                                  const BFrag<TB>& B,
                                                  int steps) {
  float dr[2][4] = {}, sr[2][4] = {}, di[2][4] = {}, si[2][4] = {};
  int st = 0;
  for (; st + 2 <= steps; st += 2) {
    unsigned a[2][4], br[2][2], bi[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      A.load(a[i], st + i);
      B.load(br[i], bi[i], st + i);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bits<kLoA, kLoB>(dr[i], sr[i], a[i], br[i]);
      mma_bits<kLoA, kLoB>(di[i], si[i], a[i], bi[i]);
    }
  }
  if (st < steps) {
    unsigned a[4], br[2], bi[2];
    A.load(a, st);
    B.load(br, bi, st);
    mma_bits<kLoA, kLoB>(dr[0], sr[0], a, br);
    mma_bits<kLoA, kLoB>(di[0], si[0], a, bi);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    vr[e] = (sr[0][e] + dr[0][e]) + (sr[1][e] + dr[1][e]);
    vi[e] = (si[0][e] + di[0][e]) + (si[1][e] + di[1][e]);
  }
}

// A stage's `tiles` output tiles over the block's warps: with s > 1
// (depth_splits), s warps split each tile's depth. part(tl, sp, v) forms
// split sp of tile tl into v; the split-0 warp adds the other splits' parts
// from pb in split order and calls put(tl, v). Every thread calls it; it
// ends synchronised.
template <class Part, class Put>
__device__ __forceinline__ void split_tiles(const Div& tiles, int s,
                                            float* pb, Part part, Put put) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float keep[4] = {};
  for (int w = warp; w < tiles.d * s; w += kWarps) {  // one a warp if s > 1
    const int sp = tiles.div(w), tl = w - sp * tiles.d;
    float v[4] = {};
    part(tl, sp, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (sp > 0) {
        pb[((sp - 1) * tiles.d + tl) * 128 + lane * 4 + e] = v[e];
      } else {
        keep[e] = v[e];
      }
    }
    if (s == 1) put(tl, keep);
  }
  if (s > 1) {
    __syncthreads();
    if (warp < tiles.d) {
      for (int q = 1; q < s; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep[e] += pb[((q - 1) * tiles.d + warp) * 128 + lane * 4 + e];
      }
      put(warp, keep);
    }
  }
  __syncthreads();
}

// Rows s < n of a factor pair [n][k] as f32 rows [F_r | F_i] (halves h
// apart, rows ld apart): cp.async for f32, widened loads for bf16.
template <typename T>
__device__ __forceinline__ void factor_rows(float* dst, int ld, int h,
                                            const T* fr, const T* fi, int n,
                                            int k) {
  if constexpr (std::is_same<T, float>::value) {
    const bool vec = k % 4 == 0 && tc::aligned16(fr) && tc::aligned16(fi);
    tc::load_tile(dst, ld, fr, k, n, k, vec, fno::kThreads);
    tc::load_tile(dst + h, ld, fi, k, n, k, vec, fno::kThreads);
  } else {
    for (int i = threadIdx.x; i < n * k; i += fno::kThreads) {
      dst[(i / k) * ld + i % k] = fno::ld(fr + i);
      dst[(i / k) * ld + h + i % k] = fno::ld(fi + i);
    }
  }
}

// Zero `words` 32-bit words at p.
__device__ __forceinline__ void zero_words(void* p, long long words) {
  float* f = static_cast<float*>(p);
  for (long long i = threadIdx.x; i < words; i += fno::kThreads) f[i] = 0.f;
}

// Rank 1: out[c][k] = Σ_s x[c][s]·F_1[s][k] for the nch channels at once,
// the points streamed in chunks of L.nr with the factor's rows beside them.
template <typename T>
__device__ void chain_rank1(const T* src, int nch, const fno::Geom& g,
                            const Layout L, const fno::Mats<T> m,
                            float* out_r, float* out_i, int ldo,
                            char* base) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  const long long fb = L.fa + (L.bytes - L.fa) / 2;
  T* xs[2] = {reinterpret_cast<T*>(base + L.x0),
              reinterpret_cast<T*>(base + L.x1)};
  T* fs[2] = {reinterpret_cast<T*>(base + L.fa),
              reinterpret_cast<T*>(base + fb)};
  __syncthreads();  // earlier users of the work area are done
  zero_words(base, L.bytes / 4);
  __syncthreads();
  if (nch <= 0) return;
  constexpr int kE = 16 / sizeof(T);
  const int n1 = g.n1, k1 = g.k1, np = L.nr;
  const int nchunks = (n1 + np - 1) / np;
  const bool vec_x = n1 % kE == 0 && tc::aligned16(src);
  const bool vec_f = k1 % kE == 0 && tc::aligned16(m.r[0]) &&
                     tc::aligned16(m.i[0]);
  const T zero = tc::from_f32<T>(0.f);
  auto issue = [&](int q) {
    const int p0 = q * np, nv = min(np, n1 - p0);
    T* x = xs[q & 1];
    T* f = fs[q & 1];
    const bool vx = vec_x && nv % kE == 0 && p0 % kE == 0;
    tc::load_tile(x, L.ldx, src + p0, n1, nch, nv, vx, fno::kThreads);
    tc::load_tile(f, L.ldfa, m.r[0] + static_cast<size_t>(p0) * k1, k1, nv,
                  k1, vec_f, fno::kThreads);
    tc::load_tile(f + L.ha, L.ldfa, m.i[0] + static_cast<size_t>(p0) * k1,
                  k1, nv, k1, vec_f, fno::kThreads);
    if (nv < np) {  // the ragged last chunk: points past n1 are zero
      for (int i = tid; i < nch * (np - nv); i += fno::kThreads)
        x[(i / (np - nv)) * L.ldx + nv + i % (np - nv)] = zero;
      for (int i = tid; i < (np - nv) * 2 * L.ha; i += fno::kThreads)
        f[(nv + i / (2 * L.ha)) * L.ldfa + i % (2 * L.ha)] = zero;
    }
  };
  const int nt = 2 * L.ha / 8, tiles = acc_tiles(1, L);
  float acc[kMaxAcc][4] = {};
  issue(0);
  tc::async_commit();
  for (int q = 0; q < nchunks; ++q) {
    tc::async_wait_all();
    __syncthreads();
    if (q + 1 < nchunks) issue(q + 1);
    tc::async_commit();
#pragma unroll
    for (int u = 0; u < kMaxAcc; ++u) {
      const int tl = warp + kWarps * u;
      if (tl < tiles) {
        tile_product<T>(acc[u], xs[q & 1] + 16 * (tl / nt) * L.ldx, L.ldx,
                        fs[q & 1] + 8 * (tl % nt), L.ldfa, L.da);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxAcc; ++u) {
    const int tl = warp + kWarps * u;
    if (tl >= tiles) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 16 * (tl / nt) + lg + 8 * (e >> 1);
      const int n = 8 * (tl % nt) + 2 * lt + (e & 1);
      const int ho = n >= L.ha, kk = n - ho * L.ha;
      if (c < nch && kk < k1) (ho ? out_i : out_r)[c * ldo + kk] = acc[u][e];
    }
  }
  __syncthreads();
}

// Ranks 2 and 3: the spectra of nch channels, one after another, the
// (channel, chunk) pairs pipelined as one stream.
template <int R, typename T>
__device__ void chain_outer(const T* src, int nch, const fno::Geom& g,
                            const Layout L, const fno::Mats<T> m,
                            float* out_r, float* out_i, int ldo,
                            char* base) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  T* fa = reinterpret_cast<T*>(base + L.fa);
  T* xs[2] = {reinterpret_cast<T*>(base + L.x0),
              reinterpret_cast<T*>(base + L.x1)};
  float* f1 = reinterpret_cast<float*>(base + L.f1);
  float* z = reinterpret_cast<float*>(base + L.z);
  float* f2 = reinterpret_cast<float*>(base + L.f2);
  float* tt = reinterpret_cast<float*>(base + L.t);
  const int nR = R == 3 ? g.n3 : g.n2, kR = R == 3 ? g.k3 : g.k2;
  const int kmid = R == 3 ? g.k2 : 1;     // modes of the middle axis
  const int rowlen = R == 3 ? g.n2 : 1;   // rows of n_R points a s_1 row
  __syncthreads();  // earlier users of the work area are done
  zero_words(base, L.bytes / 4);
  __syncthreads();
  if (nch <= 0) return;
  constexpr int kE = 16 / sizeof(T);
  // The factors, once for the chain: [F_Rr | F_Ri] in T, F_2 and F_1 rows
  // in f32 (zero past k and past n).
  const bool vec_fa = kR % kE == 0 && tc::aligned16(m.r[0]) &&
                      tc::aligned16(m.i[0]);
  tc::load_tile(fa, L.ldfa, m.r[0], kR, nR, kR, vec_fa, fno::kThreads);
  tc::load_tile(fa + L.ha, L.ldfa, m.i[0], kR, nR, kR, vec_fa,
                fno::kThreads);
  if constexpr (R == 3)
    factor_rows(f2, L.ld2, L.h2, m.r[1], m.i[1], g.n2, g.k2);
  factor_rows(f1, L.ld1, L.h1, m.r[R - 1], m.i[R - 1], g.n1, g.k1);

  const int nchunks = (g.n1 + L.nr - 1) / L.nr;
  const int total = nch * nchunks;
  const bool vec_x = nR % kE == 0 && tc::aligned16(src);
  const T zero = tc::from_f32<T>(0.f);
  const Div dchunks(nchunks), dpiece(vec_x ? nR / kE : nR);
  auto issue = [&](int q) {  // chunk q of the stream into buffer q & 1
    const int c = dchunks.div(q), c0 = (q - c * nchunks) * L.nr;
    const int rows = min(L.nr, g.n1 - c0) * rowlen;
    T* x = xs[q & 1];
    const T* from = src + static_cast<size_t>(c) * g.S +
                    static_cast<size_t>(c0) * g.P;
    // The rows, 16-byte pieces (or elements) a thread in turn.
    for (int i = tid; i < rows * dpiece.d; i += fno::kThreads) {
      const int r = dpiece.div(i), j = i - r * dpiece.d;
      if (vec_x) {
        tc::copy_async(x + r * L.ldx + j * kE, from + r * nR + j * kE);
      } else {
        x[r * L.ldx + j] = from[r * nR + j];
      }
    }
    for (int i = tid; i < (L.xrows - rows) * nR; i += fno::kThreads)
      x[(rows + i / nR) * L.ldx + i % nR] = zero;
  };
  constexpr int kDep = tc::depth<T>();
  // The tiles of each stage (16 rows of M by 8 columns of N) and their
  // divisors: stage A's N in nta pieces, B's (rank 3) in nt2 of two halves
  // of h2/8, C's in nt1 of two halves of h1/8.
  const Div nta(2 * L.ha / 8), tiles_a((L.xrows / 16) * nta.d);
  const int sa = depth_splits(tiles_a.d, L.da / kDep);
  const Div nt2(R == 3 ? 2 * L.h2 / 8 : 1), nh2(R == 3 ? L.h2 / 8 : 1);
  const Div tiles_b(R == 3 ? (L.mb / 16) * nt2.d : 1);
  const int steps_b = L.d2 / 4;
  const int sb = R == 3 ? depth_splits(tiles_b.d, steps_b) : 1;
  const Div nt1(2 * L.h1 / 8), nh1(L.h1 / 8);
  const int tiles_c = acc_tiles(R, L);
  const Div n2(g.n2), ha(L.ha), zcap(L.zcap);
  float* pb = reinterpret_cast<float*>(base + L.pb);
  float acc[kMaxAcc][4] = {};
  int filled = 0, used = 0;  // s_1 rows of the channel in the ring, taken
  issue(0);
  tc::async_commit();
  for (int q = 0; q < total; ++q) {
    if (q + 1 < total) issue(q + 1);
    tc::async_commit();
    tc::async_wait_one();
    __syncthreads();
    const int c = dchunks.div(q), j = q - c * nchunks;
    const int nv = min(L.nr, g.n1 - j * L.nr);
    // Stage A along s_R: rows (r, s_2) of the chunk against [F_Rr | F_Ri],
    // into T[s_2][(half, r, k_R)] (rank 3) or the ring row of s_1 row r.
    const T* x = xs[q & 1];
    split_tiles(
        tiles_a, sa, pb,
        [&](int tl, int sp, float (&v)[4]) {
          const int i = nta.div(tl);
          tile_product<T>(v, x + 16 * i * L.ldx, L.ldx,
                          fa + 8 * (tl - i * nta.d), L.ldfa, L.da, sp * kDep,
                          sa * kDep);
        },
        [&](int tl, const float (&v)[4]) {
          const int i = nta.div(tl);
          const int n0 = 8 * (tl - i * nta.d) + 2 * lt;
          const int half = n0 >= L.ha, col = n0 - half * L.ha;
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int row = 16 * i + lg + 4 * e;
            float* p;
            if constexpr (R == 3) {
              const int r = n2.div(row);
              if (r >= nv) continue;
              p = tt + (row - r * g.n2) * L.ldt + half * L.mb + r * L.ha +
                  col;
            } else {
              if (row >= nv) continue;
              p = z + zcap.mod(filled + row) * L.ldz + half * L.mz + col;
            }
            p[0] = v[e];
            p[1] = v[e + 1];
          }
        });
    if constexpr (R == 3) {
      // Stage B along s_2 (complex): Z[s_1][(k_2, k_3)] into the ring, four
      // s_2 rows a depth step.
      split_tiles(
          tiles_b, sb, pb,
          [&](int tl, int sp, float (&v)[4]) {
            const int i = nt2.div(tl), jn = tl - i * nt2.d;
            const int ho = nh2.div(jn), n0 = (jn - ho * nh2.d) * 8;
            complex_tile(v, tt + 16 * i, L.ldt, L.mb, f2 + n0, L.ld2, L.h2,
                         ho, steps_b, sp, sb);
          },
          [&](int tl, const float (&v)[4]) {
            const int i = nt2.div(tl), jn = tl - i * nt2.d;
            const int ho = nh2.div(jn), a0 = (jn - ho * nh2.d) * 8 + 2 * lt;
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const int row = 16 * i + lg + 4 * e;
              const int r = ha.div(row), c3 = row - r * L.ha;
              if (r >= nv) continue;
              float* zr = z + zcap.mod(filled + r) * L.ldz + ho * L.mz + c3;
              if (a0 < g.k2) zr[a0 * L.ha] = v[e];
              if (a0 + 1 < g.k2) zr[(a0 + 1) * L.ha] = v[e + 1];
            }
          });
    }
    filled += nv;
    const bool last = j == nchunks - 1;
    if (last && filled % 4 != 0) {  // the channel's last group, zero-padded
      const int extra = 4 - filled % 4;
      for (int i = tid; i < extra * 2 * L.mz; i += fno::kThreads) {
        z[zcap.mod(filled + i / (2 * L.mz)) * L.ldz + i % (2 * L.mz)] = 0.f;
      }
      filled += extra;
      __syncthreads();
    }
    // Stage C along s_1 (complex), four s_1 rows a step, into registers.
    for (; used + 4 <= filled; used += 4) {
      const float* in = z + zcap.mod(used) * L.ldz;
      const float* f = f1 + used * L.ld1;
#pragma unroll
      for (int u = 0; u < kMaxAcc; ++u) {
        const int tl = warp + kWarps * u;
        if (tl < tiles_c) {
          const int i = nt1.div(tl), jn = tl - i * nt1.d;
          const int ho = nh1.div(jn), n0 = (jn - ho * nh1.d) * 8;
          tc::Frag<float, 4> fa[1];
          tc::Frag<float, 2> fb[1];
          complex_frags(fa[0], fb[0], in + 16 * i, L.ldz, L.mz, f + n0,
                        L.ld1, L.h1, ho);
          float sm[1][4] = {};
          mma_steps<float, 1>(reinterpret_cast<float (&)[1][4]>(acc[u]), sm,
                              fa, fb);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] += sm[0][e];
        }
      }
    }
    if (last) {  // the channel's spectrum, then a fresh accumulator
#pragma unroll
      for (int u = 0; u < kMaxAcc; ++u) {
        const int tl = warp + kWarps * u;
        if (tl >= tiles_c) continue;
        const int i = nt1.div(tl), jn = tl - i * nt1.d;
        const int ho = nh1.div(jn), n0 = (jn - ho * nh1.d) * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + lg + 8 * (e >> 1);
          const int a2 = ha.div(row), c3 = row - a2 * L.ha;
          const int k1 = n0 + 2 * lt + (e & 1);
          if (a2 < kmid && c3 < kR && k1 < g.k1) {
            (ho ? out_i : out_r)[c * ldo + k1 * g.Kp + a2 * kR + c3] =
                acc[u][e];
          }
          acc[u][e] = 0.f;
        }
      }
      filled = used = 0;
    }
  }
  __syncthreads();
}

// The spectra out_{r,i}[c·ldo + k] of nch real channels src[c][s] (channel
// stride S), overwritten. `base` is the work area of L.bytes bytes in
// shared memory. Every thread of the block calls it; it ends synchronised.
template <int R, typename T>
__device__ void forward_chain(const T* src, int nch, const fno::Geom& g,
                              const Layout L, const fno::Mats<T> m,
                              float* out_r, float* out_i, int ldo,
                              char* base) {
  if constexpr (R == 1) {
    chain_rank1<T>(src, nch, g, L, m, out_r, out_i, ldo, base);
  } else {
    chain_outer<R, T>(src, nch, g, L, m, out_r, out_i, ldo, base);
  }
}


// The padded inverse DFT chain (the block kernel's phase 3) on the tensor
// cores: per chunk of nr s_1 rows from c0, the real field ys of `os` out
// channels from their spectra C (phase 2's CGEMM), axis s_1 first:
//
//   stage 1, axis s_1 (complex):  T1[o][r][k'] = Σ_k1 C[o][k1][k']·E_1[k1][c0+r]
//   stage 2, axis s_2 (rank 3):   T2[o][r][s2][k3] = Σ_k2 T1·E_2[k2][s2]
//   last stage, axis s_R (real):  ys = Re Σ_kR T·E_R
//
// (rank 1: stage 1 is the last; rank 2: stage 2). Each stage is one
// complex_tile product whose input holds the modes it sums as rows (the
// depth) and its M as columns, real and imaginary halves side by side, and
// whose factor rows [E_r | E_i] are in f32 in shared memory. Each stage
// writes its output as the next one's input, the next mode axis as rows;
// phase 2 writes C so: C[k1][o·Kp + k']. The last stage keeps the real part
// only (the lane feeding an imaginary input flips E_i's sign, as above), so
// the irDFT's depth runs [T_r | T_i] against [E_r; −E_i]. Every
// intermediate is f32, so every product is 3xTF32 (bf16 factors are widened
// on the way in). E_1's columns of a chunk are copied per chunk (in pieces
// of dp rows, stage 1 summing over the pieces, where its depth k_1 is more
// than shared memory holds); E_2 and E_3 are resident, except that a last
// factor wider than shared memory holds passes in pieces of `wl` columns,
// copied per chunk. Rows past the
// modes are zero in shared memory; columns past the extents, and a tile's
// rows past its stage's M, only feed outputs that are not stored.
struct InvLayout {
  int ri;           // s_1 rows a chunk
  int mc, ldc, dc;  // C: its M (os·Kp; padded to 16 at rank ≥ 2), ld, rows
  int h1, ld1, dp;  // E_1's chunk: half width (ri to 8), ld, rows a piece
  int h2, ld2, d2;  // E_2 (rank ≥ 2): half width (n_2, or wl, to 8), ld,
                    // rows (k_2 to 4)
  int h3, ld3, d3;  // E_3 (rank 3)
  int wl;           // columns of the last factor held at once
  bool pieces;      // the last factor passes in pieces of wl columns
  int m1, ldt1;     // T1 (rank ≥ 2, d2 rows): half width, ld
  int m2, ldt2;     // T2 (rank 3, d3 rows)
  long long cbytes;  // C's bytes (a guard past its last row)
  long long e1, e2, e3, t1, t2;  // byte offsets from the area's base
  long long fbytes, bytes;       // the factors' end, the stages' end
};

// The layout for extents n and modes k (axis order 1..R, unused = 1), os
// out channels, ri s_1 rows a chunk, wl columns of the last factor at once
// (rank ≥ 2; n_R padded to 8: resident) and dp rows of E_1 at once (a
// multiple of 4; k_1 padded to 4: all). Mirrored by kernels/engine.py
// _inv_bytes.
__host__ __device__ inline InvLayout inv_layout(int R, const int* n,
                                                const int* k, int os,
                                                int ri, int wl, int dp) {
  using tc::align128;
  using tc::pad_to;
  InvLayout L = {};
  L.ri = ri;
  // Rank 1: C's rows [C_r | C_i] of os channels each, unpadded; a tile
  // reads past a row into the next (or the guard), which only feeds M rows
  // past os.
  L.mc = R == 1 ? os : pad_to(os * k[1] * k[2], 16);
  L.ldc = 2 * L.mc + (R == 1 ? 0 : 8);
  L.dc = pad_to(k[0], 4);
  L.cbytes = 4LL * (1LL * L.dc * L.ldc + 32);
  L.h1 = pad_to(ri, 8);
  L.ld1 = 2 * L.h1 + 8;
  L.dp = dp < L.dc ? dp : L.dc;
  long long at = align128(4LL * L.dp * L.ld1);
  const int last = pad_to(n[R - 1], 8);
  L.wl = R == 1 ? 0 : (wl < last ? wl : last);
  L.pieces = R > 1 && L.wl < last;
  if (R >= 2) {
    L.h2 = R == 2 ? L.wl : pad_to(n[1], 8);
    L.ld2 = 2 * L.h2 + 8;
    L.d2 = pad_to(k[1], 4);
    L.e2 = at;
    at = align128(at + 4LL * L.d2 * L.ld2);
  }
  if (R == 3) {
    L.h3 = L.wl;
    L.ld3 = 2 * L.h3 + 8;
    L.d3 = pad_to(k[2], 4);
    L.e3 = at;
    at = align128(at + 4LL * L.d3 * L.ld3);
  }
  L.fbytes = at;
  if (R >= 2) {
    L.m1 = pad_to(os * ri * k[2], 16);
    L.ldt1 = 2 * L.m1 + 8;
    L.t1 = at;
    at = align128(at + 4LL * L.d2 * L.ldt1);
  }
  if (R == 3) {
    L.m2 = pad_to(os * ri * n[1], 16);
    L.ldt2 = 2 * L.m2 + 8;
    L.t2 = at;
    at = align128(at + 4LL * L.d3 * L.ldt2);
  }
  L.bytes = at;
  return L;
}

// Columns j0..j0 + w of the first `rows` rows of a factor pair [rows][n] as
// f32 rows [F_r | F_i] (halves h apart, rows ld apart), zero past n.
template <typename T>
__device__ __forceinline__ void factor_cols(float* dst, int ld, int h,
                                            const T* fr, const T* fi,
                                            int rows, int n, int j0, int w) {
  const Div dw(w);
  for (int i = threadIdx.x; i < rows * w; i += fno::kThreads) {
    const int r = dw.div(i), c = i - r * w, j = j0 + c;
    const bool in = j < n;
    dst[r * ld + c] = in ? fno::ld(fr + static_cast<size_t>(r) * n + j) : 0.f;
    dst[r * ld + h + c] =
        in ? fno::ld(fi + static_cast<size_t>(r) * n + j) : 0.f;
  }
}

// Zeroes the area at `base` (L.bytes) and copies the resident inverse
// factors into it as f32 rows [E_r | E_i] (cp.async for f32: the caller
// waits, and syncs, before the first chunk). Every thread of the block
// calls it.
template <int R, typename T>
__device__ void inverse_factors(const InvLayout& L, char* base,
                                const fno::Mats<T>& e, const fno::Geom& g) {
  zero_words(base, L.bytes / 4);
  __syncthreads();
  auto at = [&](long long off) {
    return reinterpret_cast<float*>(base + off);
  };
  if constexpr (R >= 2) {
    if (R == 3 || !L.pieces)
      factor_rows(at(L.e2), L.ld2, L.h2, e.r[1], e.i[1], g.k2, g.n2);
  }
  if constexpr (R == 3) {
    if (!L.pieces)
      factor_rows(at(L.e3), L.ld3, L.h3, e.r[2], e.i[2], g.k3, g.n3);
  }
  tc::async_commit();
}

// One stage of the inverse chain: mt × nt tiles (of 16 M rows by 8
// columns) in `halves` (1: the real part only), one a warp in turn, each
// put(row, column, half, value) per element. Ends synchronised.
template <class Put>
__device__ __forceinline__ void inverse_stage(int mt, int nt, int halves,
                                              const float* in, int ldi,
                                              int off_i, const float* f,
                                              int ldf, int off_f, int steps,
                                              Put put) {
  const int warp = threadIdx.x >> 5;
  const int lg = (threadIdx.x & 31) >> 2, lt = threadIdx.x & 3;
  const Div dn(nt), dh(halves);
  for (int tl = warp; tl < mt * nt * halves; tl += kWarps) {
    const int rest = dn.div(tl), jn = tl - rest * nt;
    const int i = dh.div(rest), ho = rest - i * halves;
    float v[4];
    complex_tile(v, in + 16 * i, ldi, off_i, f + 8 * jn, ldf, off_f, ho,
                 steps);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      put(16 * i + lg + 8 * (e >> 1), 8 * jn + 2 * lt + (e & 1), ho, v[e]);
  }
  __syncthreads();
}

// The last stage, the real irDFT along s_R of In (rows the modes k_R,
// halves off_i apart) against the factor at f (rows ldf apart, halves
// h apart) into ys[m·n_R + j] for m < mv: in one pass where the factor is
// resident, else per piece of L.wl columns copied first. Ends synchronised.
template <typename T>
__device__ __forceinline__ void inverse_last(const InvLayout& L,
                                             const float* in, int ldi,
                                             int off_i, float* f, int ldf,
                                             int h, int d, const T* er,
                                             const T* ei, int kR, int nR,
                                             int mv, float* ys) {
  for (int j0 = 0; j0 < nR; j0 += L.wl) {
    if (L.pieces) {
      factor_cols(f, ldf, h, er, ei, kR, nR, j0, L.wl);
      __syncthreads();
    }
    const int w = L.pieces ? L.wl : h;
    inverse_stage((mv + 15) / 16, w / 8, 1, in, ldi, off_i, f, ldf, h, d / 4,
                  [&](int m, int j, int, float v) {
                    if (m < mv && j0 + j < nR) ys[m * nR + j0 + j] = v;
                  });
    if (!L.pieces) break;
  }
}

// One chunk: ys[(o·nr + r)·P + p] for o < os, r < nr (rows c0..c0 + nr of
// s_1) from C (rows L.ldc apart, the imaginary half at L.mc), the inverse
// factors e and the area at `base`. Every thread of the block calls it; it
// ends synchronised.
template <int R, typename T>
__device__ void inverse_chunk(const float* C, const InvLayout& L, char* base,
                              const fno::Mats<T>& e, const fno::Geom& g,
                              int os, int nr, int c0, float* ys) {
  auto at = [&](long long off) {
    return reinterpret_cast<float*>(base + off);
  };
  const int kp = g.Kp, nt1 = (nr + 7) / 8;
  const int mv1 = os * kp;  // stage 1's valid M
  // Stage 1 along s_1: C against this chunk's columns of E_1, dp rows of
  // E_1 at a time (its rows past k_1 zero), the pieces summed in order.
  float* e1 = at(L.e1);
  float* t1 = at(L.t1);
  const Div dkp(kp), dk3(g.k3);
  for (int s0 = 0; s0 < L.dc; s0 += L.dp) {
    const int dn = min(L.dp, L.dc - s0), kn = max(0, min(dn, g.k1 - s0));
    const size_t e0 = static_cast<size_t>(s0) * g.n1;
    factor_cols(e1, L.ld1, L.h1, e.r[0] + e0, e.i[0] + e0, kn, g.n1, c0,
                L.h1);
    for (int i = threadIdx.x; i < (dn - kn) * L.ld1; i += fno::kThreads)
      e1[kn * L.ld1 + i] = 0.f;
    __syncthreads();
    const float* cs = C + static_cast<size_t>(s0) * L.ldc;
    const bool first = s0 == 0;
    if constexpr (R == 1) {
      inverse_stage((mv1 + 15) / 16, nt1, 1, cs, L.ldc, L.mc, e1, L.ld1,
                    L.h1, dn / 4, [&](int m, int r, int, float v) {
                      if (m < mv1 && r < nr) {
                        float& y = ys[m * nr + r];
                        y = first ? v : y + v;
                      }
                    });
    } else {
      inverse_stage(L.mc / 16, nt1, 2, cs, L.ldc, L.mc, e1, L.ld1, L.h1,
                    dn / 4, [&](int m, int r, int ho, float v) {
                      if (m >= mv1 || r >= nr) return;
                      const int o = dkp.div(m), rem = m - o * kp;
                      const int a2 = dk3.div(rem), a3 = rem - a2 * g.k3;
                      float& t = t1[a2 * L.ldt1 + ho * L.m1 +
                                    (o * nr + r) * g.k3 + a3];
                      t = first ? v : t + v;
                    });
    }
  }
  if constexpr (R > 1) {
    if constexpr (R == 2) {
      // The real irDFT along s_2: ys[(o·nr + r)·n2 + s2].
      inverse_last(L, t1, L.ldt1, L.m1, at(L.e2), L.ld2, L.h2, L.d2,
                   e.r[1], e.i[1], g.k2, g.n2, os * nr, ys);
    } else {
      // Stage 2 along s_2 (complex) into T2[k3][((o·nr + r)·n2 + s2)].
      float* t2 = at(L.t2);
      const int mv = os * nr * g.k3;
      inverse_stage((mv + 15) / 16, L.h2 / 8, 2, t1, L.ldt1, L.m1,
                    at(L.e2), L.ld2, L.h2, L.d2 / 4,
                    [&](int m, int j, int ho, float v) {
                      if (m >= mv || j >= g.n2) return;
                      const int q = dk3.div(m), a3 = m - q * g.k3;
                      t2[a3 * L.ldt2 + ho * L.m2 + q * g.n2 + j] = v;
                    });
      // The real irDFT along s_3: ys[((o·nr + r)·n2 + s2)·n3 + s3].
      inverse_last(L, t2, L.ldt2, L.m2, at(L.e3), L.ld3, L.h3, L.d3,
                   e.r[2], e.i[2], g.k3, g.n3, os * nr * g.n2, ys);
    }
  }
}

}  // namespace chain
