// Partial-fusion core for NVIDIA Hopper (sm_90a): the GEMM-adjacent stages
// of the paper's partial fusion in one launch, on a spectrum whose outer
// axes (s_2..s_R) were already transformed by the row kernels:
//
//   A[h,k_1]   = Σ_{i<s_1} z[b,h,i,p] · f[i,k_1]   truncated cDFT along s_1
//   C[o,k_1]   = Σ_h (wr + i·wi)[o,h(,k_1,p)] · A[h,k_1]   CGEMM over hidden
//   y[b,p,o,j] = Σ_{k_1} C[o,k_1] · g[k_1,j]       padded icDFT along s_1
//
// z is the complex pair [B, H, s_1, P] with P = Π(K_R..K_2) flattened, so one
// kernel serves every rank; y is the pair [B, P, O, s_1], the reference's
// layout ([B, K_R..K_2, O, s_1]) with either weights. Replaces the TPU
// kernel repro/kernels/engine.py::fused_fnond_core_call (_make_core_kernel)
// with shared weights [O,H] or per-mode weights [O,H,K_1,K_2..K_R] (whose
// per-mode output layout [K_R..K_2,B,O,s_1] the port does not copy: the
// caller's permute is the same for both). Element type float or
// __nv_bfloat16 for z, the weights, the factors and y; the spectra A and C
// stay f32 in shared memory and every stage accumulates in f32.
//
// What bounds it on an H100. At fno2d (B=8, H=O=64, s_1=128, P=32,
// K_1=32, shared W) it moves 33.6 MB in f32 (10 µs at 3.35 TB/s); its three
// stages are 1.3 GFLOP, 8 µs as 3xTF32 on the tensor cores. At fno2d-large
// (H=O=128, per-mode W) the weights alone are 134 MB a launch in f32: 40
// µs, against 3.2 GFLOP (19 µs). Bytes bound the function.
//
// Design. One thread-block cluster of `cl` blocks per tile: a group of up
// to 8 samples (the per-mode weights' reuse: every sample of the group
// meets a mode's W in one product, so a launch reads per-mode W once per
// group) and `np` adjacent spectrum columns p (so each (o, h, k_1) of W and
// each (b, h, i) of z is a contiguous run of np elements). Rank r of the
// cluster owns hidden channels [r·hs, r·hs + hs) and out channels
// [r·os, r·os + os), as the block kernel's clusters split them:
//
//   phase 1: the forward stage of its hidden channels, a complex product
//            [s_1 rows of z] ⋆ [F_r | F_i] on the tensor cores, z's rows and
//            F's rows streamed together by cp.async in chunks of `ri` rows
//            (double-buffered), the spectra A accumulated in registers;
//   phase 2: the CGEMM of its out channels over every hidden channel,
//            chunk by chunk of `kc` modes k_1: the chunk's A of every rank
//            gathered through distributed shared memory (16-byte loads),
//            then complex products on the tensor cores; per-mode W is
//            streamed (rank r reads only its os rows, double-buffered by
//            cp.async), shared W was staged once;
//   phase 3: the inverse stage of its out channels, C ⋆ [G_r | G_i] with
//            G's columns streamed in chunks of `wj` points, each output
//            tile stored from registers into y[b, p, o, :] rows.
//
// Every product is chain_tc.cuh's complex m16n8k8 step: depth 8 = four
// complex terms (real parts, then imaginary parts) against the factor's
// [real | imaginary] rows with the imaginary lane's sign flipped, so no
// stacked [[F_r, F_i], [−F_i, F_r]] copy exists. f32 operands run three
// TF32 passes (3xTF32, tc_common.cuh); a bf16 operand widened to f32 is
// exact in TF32, so its low pass is dropped: bf16 z against bf16 F runs
// one pass (the products a bf16 mma.sync would form), the CGEMM and the
// inverse stage two (A and C are f32). Operands stay in their element type
// in shared memory and are widened as fragments are loaded. Each block
// passes over F and G once, so streaming them costs what resident factors
// would, at any s_1 and K_1. Ragged edges are zero in shared memory.
//
// Where it stands (PERF.md §6): 5–14× its bound on an H100. Each block runs
// its phases in order with few warps, so a phase's loads or products are
// not hidden by another's; at fno2d-large the per-mode W stream moves
// 8-byte runs (four column tiles share each 32-byte sector), and 16 tiles
// of clusters of 16, seven at once, run in three waves.
#include <cooperative_groups.h>

#include "chain_tc.cuh"

namespace cg = cooperative_groups;

// Loop bound of phase i (1..9): 1 the forward stage, 2 the CGEMM (with the
// per-mode W stream and the gather of A), 3 the inverse stage and the write
// of y; within them 4 the gather of A, 5 the per-mode W stream, 6 the
// copies of z into shared memory, 7 the stores of y, 8 the CGEMM's
// products, 9 the forward stage's products. Built with
// -DFUSED_CORE_ELIDE=<mask>, the phases whose bit (1 << i) is set run no
// iteration: the output is then wrong and only the time counts
// (launch/block_phases.py --kernel core).
#ifndef FUSED_CORE_ELIDE
#define FUSED_CORE_ELIDE 0
#endif
#define PHASE_BOUND(i, n) (((FUSED_CORE_ELIDE >> (i)) & 1) ? 0 : (n))

// Built with -DFUSED_CORE_CLOCKS, thread 0 of each of the first
// kClockBlocks blocks stamps the card's nanosecond clock at the phase
// boundaries below (after a block barrier), read back by
// fused_core_clocks (launch/block_phases.py --clocks); the stamps cost a
// barrier each, so only this build has them.
#ifdef FUSED_CORE_CLOCKS
constexpr int kClockBlocks = 4096;
constexpr int kClocks = 8;  // stamps a block
__device__ unsigned long long g_core_clocks[kClockBlocks * kClocks];
__device__ __forceinline__ void core_clock(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long ns = 0;
#ifdef __CUDA_ARCH__
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
#endif
    const unsigned blk =
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (blk < kClockBlocks) g_core_clocks[blk * kClocks + i] = ns;
  }
}
#define CORE_CLOCK(i) core_clock(i)
#else
#define CORE_CLOCK(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 4;          // phase 1's accumulating tile pairs a warp
                                  // holds (real and imaginary halves)
constexpr int kMaxCluster = 16;   // Hopper's non-portable cluster size
constexpr int kTargetBlocks = 256;  // blocks a launch aims at (132 SMs)
// Shared memory of a block that leaves room for a second one on an SM
// (228 KB an SM, 1 KB of it reserved a block).
constexpr int kHalfSmem = 115712;
constexpr int kMaxGridYZ = 65535;  // a grid's extent along y and along z

using tc::align128;
using tc::pad_to;

// Row lengths (elements of esize bytes) whose fragment loads are free of
// bank conflicts: ld8 for rows read 8 lanes along a row (ld·esize/4 ≡ 8
// words mod 32), ld4 for rows read 8 lanes down a column (≡ 4 words).
__host__ __device__ inline int ld_words(int n, int esize, int words) {
  const int unit = 128 / esize, off = 4 * words / esize;
  return n <= off ? off : off + (n - off + unit - 1) / unit * unit;
}
__host__ __device__ inline int ld8(int n, int esize) {
  return ld_words(n, esize, 8);
}
__host__ __device__ inline int ld4(int n, int esize) {
  return ld_words(n, esize, 4);
}

// The launch: its plan and shared-memory layout (byte offsets, regions
// 128-B aligned). dims: {B, H, O, n1, K1, P, per_mode, K2}.
struct Layout {
  int ok;                            // fits a block's shared memory
  int cl, hs, os, hsp, nb, np, kc, ri, wj;  // the plan
  int groups, ptiles;                // tiles: sample groups × column tiles
  int m1, h1, ldz, ldf, tiles1;      // phase 1: z's M, F's half, lds, tiles
  int na, lda;                       // A: n = (k1·nb + b)·np + p, per plane
  int k1p, nchunk, nc, ncp, hr, ldall;  // phase 2's chunks of kc modes k_1
  int wrows, ldw;                    // W: per-mode rows (k1l, hrow); shared o
  int mc, kr, ldc;                   // C: m = (b·np + p)·os + o; rows k_1
  int ldg;                           // a G chunk's rows
  long long a, c, w0, wstride, u, zstride, fz, all, g0, g1, bytes;
  long long w_bytes;                 // W bytes a launch reads
};

__host__ __device__ inline Layout layout(const int* d, int esize, int cl,
                                         int np, int nb, int kc, int ri,
                                         int wj) {
  const int B = d[0], H = d[1], O = d[2], K1 = d[4], P = d[5];
  const bool pm = d[6] != 0;
  Layout L = {};
  L.cl = cl;
  L.hs = (H + cl - 1) / cl;
  L.os = (O + cl - 1) / cl;
  L.hsp = pad_to(L.hs, 4);
  L.nb = nb;
  L.np = np;
  L.kc = kc;
  L.ri = ri;
  L.wj = wj;
  L.groups = (B + nb - 1) / nb;
  L.ptiles = (P + np - 1) / np;
  L.m1 = pad_to(nb * L.hs * np, 16);
  L.h1 = pad_to(K1, 8);
  L.ldz = ld8(2 * L.m1, esize);
  L.ldf = ld8(2 * L.h1, esize);
  L.tiles1 = (L.m1 / 16) * (L.h1 / 8);
  L.k1p = pad_to(K1, kc);
  L.nchunk = L.k1p / kc;
  L.na = pad_to(L.k1p * nb * np, 4);
  L.lda = ld8(2 * L.na, 4);
  L.nc = kc * nb * np;
  L.ncp = pad_to(L.nc, 8);
  L.hr = cl * L.hsp;
  L.ldall = ld8(2 * L.ncp, 4);
  L.mc = pad_to(nb * np * L.os, 16);
  L.kr = pad_to(K1, 4);
  L.ldc = ld8(2 * L.mc, 4);
  L.ldg = ld8(2 * wj, esize);
  long long at = 0;
  L.a = at;
  at = align128(at + 4LL * L.hsp * L.lda);
  L.c = at;
  at = align128(at + 4LL * L.kr * L.ldc);
  L.w0 = at;
  if (pm) {  // two chunks, double-buffered
    L.wrows = kc * L.hr;
    L.ldw = ld8(2 * L.os * np, esize);
    L.wstride = align128(1LL * esize * L.wrows * L.ldw);
    at += 2 * L.wstride;
  } else {  // staged once
    L.wrows = pad_to(L.os, 16);
    L.ldw = ld4(L.hr, esize);
    L.wstride = align128(2LL * esize * L.wrows * L.ldw);
    at += L.wstride;
  }
  L.u = at;
  // Buffer s of phase 1: z's chunk at u + s·zstride, F's chunk fz after it.
  L.fz = align128(1LL * esize * ri * L.ldz);
  L.zstride = align128(L.fz + 1LL * esize * ri * L.ldf);
  long long end = at + 2 * L.zstride;
  L.all = at;
  if (cl > 1) {
    const long long e2 = align128(L.all + 4LL * L.hr * L.ldall);
    end = end > e2 ? end : e2;
  }
  L.g0 = at;
  L.g1 = align128(L.g0 + 1LL * esize * L.kr * L.ldg);
  const long long e3 = align128(L.g1 + 1LL * esize * L.kr * L.ldg);
  L.bytes = end > e3 ? end : e3;
  const long long planes = 2LL * esize;
  L.w_bytes = pm ? planes * L.groups * O * H * K1 * P
                 : planes * L.groups * L.ptiles * O * H;
  // The grid (cl, ptiles, groups) within the card's limits on y and z.
  L.ok = L.bytes <= tc::kSmemLimit && L.tiles1 <= kWarps * kMaxT &&
         L.ptiles <= kMaxGridYZ && L.groups <= kMaxGridYZ;
  return L;
}

// The plan: force = {cl, np, nb, kc, ri, wj}, 0 for the planner's choice.
// Per-mode W takes groups of min(B, 8) samples (W read once a group) and 2
// columns a tile; shared W one sample and the columns of a 16-byte run of
// z (4 f32, 8 bf16), halved down to 2 where the launch would have fewer
// than kTargetBlocks tiles; then the cluster doubles until it has that
// many blocks (larger clusters ran slower on an H100: each block gathers
// more of A remotely and passes over F and G whole); then fewer columns,
// smaller chunks of modes, z rows (16 first in f32, 32 in bf16) and G
// columns until the layout fits a block, for shared W first within room
// for two blocks an SM. ok = 0 where nothing fits.
__host__ __device__ inline Layout plan(const int* d, int esize,
                                       const int* force) {
  const int B = d[0], H = d[1], O = d[2], K1 = d[4], P = d[5];
  const bool pm = d[6] != 0;
  const int nb = force[2] ? force[2] : (pm ? (B < 8 ? B : 8) : 1);
  const int np_want = pm ? 2 : 16 / esize;  // shared: 16-byte runs of z
  int np0 = force[1] ? force[1] : (np_want < P ? np_want : P);
  const int groups = (B + nb - 1) / nb;
  int clmax = 1;
  while (clmax * 2 <= kMaxCluster && clmax * 2 <= H && clmax * 2 <= O)
    clmax *= 2;
  int cl0 = force[0];
  if (cl0 == 0) {
    cl0 = 1;
    while (!pm && !force[1] && np0 > 2 &&
           1LL * groups * ((P + np0 - 1) / np0) < kTargetBlocks)
      np0 /= 2;
    const long long tiles = 1LL * groups * ((P + np0 - 1) / np0);
    while (cl0 < clmax && cl0 * tiles < kTargetBlocks) cl0 *= 2;
  }
  const int rows[2][4] = {{16, 32, 8, 4}, {32, 16, 8, 4}};  // f32, bf16
  const int cols[3] = {32, 16, 8};
  Layout L = {};
  for (int cl = cl0; cl <= (force[0] ? cl0 : clmax); cl *= 2) {
    for (int np = np0; np >= 1; np = force[1] ? 0 : np / 2) {
      const int os = (O + cl - 1) / cl, mt = (os + 15) / 16;
      int kc = force[3];
      if (kc == 0) {  // a chunk's tiles for every warp
        const int per = pm ? 2 * np * mt : nb * np * mt;
        const int want = pm ? kWarps : 4 * kWarps;
        kc = (want + per - 1) / per;
        kc = kc < K1 ? kc : K1;
      }
      for (; kc >= 1; kc = force[3] ? 0 : kc / 2) {
        // Shared W: first the layouts that leave room for two blocks an
        // SM (they ran faster on an H100), then any that fits.
        for (int pass = pm ? 1 : 0; pass < 2; ++pass) {
          for (int i = 0; i < 4; ++i) {
            const int ri = force[4] ? force[4] : rows[esize == 2][i];
            for (int j = 0; j < 3; ++j) {
              const int wj = force[5] ? force[5] : cols[j];
              L = layout(d, esize, cl, np, nb, kc, ri, wj);
              if (L.ok && (pass == 1 || L.bytes <= kHalfSmem)) return L;
              if (force[5]) break;
            }
            if (force[4]) break;
          }
        }
      }
    }
  }
  return L;
}

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T zero() {
  return tc::from_f32<T>(0.f);
}

// A run of n elements into shared memory: one cp.async where `vec` (the
// run whole, its bytes 4, 8 or 16 and both ends aligned to them), else
// element by element, zero past nv.
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int n, int nv,
                                         bool vec) {
  if (vec) {
    const int bytes = n * static_cast<int>(sizeof(T));
    if (bytes == 16) {
      tc::copy_async<16>(dst, src);
    } else if (bytes == 8) {
      tc::copy_async<8>(dst, src);
    } else {
      tc::copy_async<4>(dst, src);
    }
  } else {
    for (int p = 0; p < n; ++p) dst[p] = p < nv ? src[p] : zero<T>();
  }
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether runs of n elements a P-long row starting at multiples of n can go
// by cp.async (4, 8 or 16 bytes, both planes aligned).
template <typename T>
__device__ __forceinline__ bool runs_vec(int n, int P, const T* r,
                                         const T* i) {
  const int bytes = n * static_cast<int>(sizeof(T));
  return (bytes == 4 || bytes == 8 || bytes == 16) && P % n == 0 &&
         aligned(r, bytes) && aligned(i, bytes);
}

using chain::AFrag;
using chain::BFrag;

// Two adjacent outputs p[0], p[1] (the second only where `two`).
__device__ __forceinline__ void store2(float* p, float v0, float v1,
                                       bool two) {
  if (two && aligned(p, 8)) {
    *reinterpret_cast<float2*>(p) = float2{v0, v1};
  } else {
    p[0] = v0;
    if (two) p[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1,
                                       bool two) {
  if (two && aligned(p, 4)) {
    *reinterpret_cast<unsigned*>(p) =
        static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v0))) |
        static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v1)))
            << 16;
  } else {
    p[0] = __float2bfloat16(v0);
    if (two) p[1] = __float2bfloat16(v1);
  }
}

template <typename T>
struct Args {
  const T* zr;  // [B, H, n1, P]
  const T* zi;
  const T* wr;  // [O, H] or [O, H, K1, K2..KR]
  const T* wi;
  const T* fr;  // [n1, K1]
  const T* fi;
  const T* gr;  // [K1, n1]
  const T* gi;
  T* yr;        // [B, P, O, n1]
  T* yi;
  int B, H, O, n1, K1, P;
  int K2;       // per-mode: K_2, which decodes p = (k_R..k_2)
  Layout L;
};

// This block's tile and slices.
struct Tile {
  int rank, b0, nbv, p0, pv, h0, nh, o0, no;
};

// Chunk q of phase 1 into its buffer (q & 1): z's rows c0..c0 + ri of my
// samples, hidden channels and columns, runs of np [real | imaginary], and
// F's rows, zero past the edges.
template <typename T>
__device__ __forceinline__ void issue_z(const Args<T>& a, const Tile& t,
                                        char* base, int q) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, n1 = a.n1, K1 = a.K1, np = L.np, hs = L.hs;
  const int c0 = q * L.ri, nv = min(L.ri, n1 - c0);
  T* z = reinterpret_cast<T*>(base + L.u + (q & 1) * L.zstride);
  T* f = reinterpret_cast<T*>(reinterpret_cast<char*>(z) + L.fz);
  const bool zvec = t.pv == np && runs_vec<T>(np, a.P, a.zr, a.zi);
  const chain::Div dri(L.ri), dhs(hs);
  const int runs = L.nb * hs * L.ri;  // (b, hl, r) runs of a plane
  for (int i = tid; i < PHASE_BOUND(6, 2 * runs); i += kThreads) {
    const int pl = i >= runs, j = i - pl * runs;
    const int bh = dri.div(j), r = j - bh * L.ri;
    const int b = dhs.div(bh), hl = bh - b * hs;
    T* dst = z + r * L.ldz + pl * L.m1 + bh * np;
    if (r < nv && b < t.nbv && hl < t.nh) {
      const size_t at =
          ((static_cast<size_t>(t.b0 + b) * a.H + t.h0 + hl) * n1 + c0 + r) *
              a.P + t.p0;
      copy_run(dst, (pl ? a.zi : a.zr) + at, np, t.pv, zvec);
    } else {
      for (int p = 0; p < np; ++p) dst[p] = zero<T>();
    }
  }
  constexpr int kE = 16 / sizeof(T);
  const bool fvec = K1 % kE == 0 && tc::aligned16(a.fr) && tc::aligned16(a.fi);
  tc::load_tile(f, L.ldf, a.fr + static_cast<size_t>(c0) * K1, K1, nv, K1,
                fvec, kThreads);
  tc::load_tile(f + L.h1, L.ldf, a.fi + static_cast<size_t>(c0) * K1, K1, nv,
                K1, fvec, kThreads);
  for (int i = tid; i < (L.ri - nv) * 2 * L.h1; i += kThreads)
    f[(nv + i / (2 * L.h1)) * L.ldf + i % (2 * L.h1)] = zero<T>();
}

// Per-mode W of CGEMM chunk c into its ring buffer: rows (k1l, hrow =
// q·hsp + hl), each [real | imaginary] of my os out channels' runs of np
// columns, zero past the edges.
template <typename T>
__device__ __forceinline__ void issue_w(const Args<T>& a, const Tile& t,
                                        char* base, int c) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, H = a.H, K1 = a.K1, P = a.P, np = L.np;
  const int os = L.os, hs = L.hs, hsp = L.hsp, hr = L.hr;
  T* w = reinterpret_cast<T*>(base + L.w0 + (c & 1) * L.wstride);
  const chain::Div dhsp(hsp), dhr(hr), dos(os);
  const bool contig = a.K2 == P;  // rank 2: columns p adjacent in W too
  const bool wvec = contig && t.pv == np && runs_vec<T>(np, P, a.wr, a.wi);
  const int runs = PHASE_BOUND(5, L.kc * hr * 2 * os);
  for (int i = tid; i < runs; i += kThreads) {
    const int rest = dos.div(i), o = i - rest * os;
    const int row = rest >> 1, pl = rest & 1;
    const int k1l = dhr.div(row), hrow = row - k1l * hr;
    const int q = dhsp.div(hrow), hl = hrow - q * hsp;
    const int h = q * hs + hl, k1 = c * L.kc + k1l;
    T* dst = w + row * L.ldw + pl * os * np + o * np;
    if (o < t.no && hl < hs && h < H && k1 < K1) {
      const T* src = (pl ? a.wi : a.wr) +
                     ((static_cast<size_t>(t.o0 + o) * H + h) * K1 + k1) * P;
      if (contig) {
        copy_run(dst, src + t.p0, np, t.pv, wvec);
      } else {  // W's (k_2..k_R) order: pm = k_2·(P / K_2) + (k_R..k_3)
        for (int p = 0; p < np; ++p) {
          const int pp = t.p0 + p;
          dst[p] = p < t.pv
                       ? src[(pp % a.K2) * (P / a.K2) + pp / a.K2]
                       : zero<T>();
        }
      }
    } else {
      for (int p = 0; p < np; ++p) dst[p] = zero<T>();
    }
  }
}

// G's columns j·wj.. of every mode k_1 into buffer j & 1; with j = 0 also
// both buffers' rows past K_1 (the inverse stage's depth) zeroed.
template <typename T>
__device__ __forceinline__ void issue_g(const Args<T>& a, char* base, int j) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, n1 = a.n1, K1 = a.K1, wj = L.wj;
  T* g = reinterpret_cast<T*>(base + (j & 1 ? L.g1 : L.g0));
  if (j == 0) {
    const int pad = (L.kr - K1) * L.ldg;
    for (int i = tid; i < 2 * pad; i += kThreads) {
      T* gs = reinterpret_cast<T*>(base + (i < pad ? L.g0 : L.g1));
      gs[K1 * L.ldg + i % pad] = zero<T>();
    }
  }
  constexpr int kE = 16 / sizeof(T);
  const int j0 = j * wj, jv = min(wj, n1 - j0);
  const bool vec = n1 % kE == 0 && jv % kE == 0 && tc::aligned16(a.gr) &&
                   tc::aligned16(a.gi);
  tc::load_tile(g, L.ldg, a.gr + j0, n1, K1, jv, vec, kThreads);
  tc::load_tile(g + wj, L.ldg, a.gi + j0, n1, K1, jv, vec, kThreads);
}

// Phase 1: A[hl][(k1·nb + b)·np + p] (real plane, then imaginary at na) of
// my hidden channels, the samples of my group and my columns. A tile is 16
// rows m = (b·hs + hl)·np + p by 8 modes k_1, both halves; warp w holds
// tiles [w·kT, w·kT + kT) in registers over the chunks.
template <typename T, int kT>
__device__ void forward_stage(const Args<T>& a, const Tile& t, char* base,
                              float* A) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  const int n1 = a.n1, K1 = a.K1, np = L.np, hs = L.hs;
  const int nchunk = (n1 + L.ri - 1) / L.ri;
  const chain::Div dhs(hs);
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int nt = L.h1 / 8, first = warp * kT;
  // Whether my tiles lie in one row block of z (one A fragment a step).
  const bool one_row = first % nt + kT <= nt;
  float acc[kT][2][4] = {}, sml[kT][2][4] = {};
  for (int q = 0; q < PHASE_BOUND(1, nchunk); ++q) {  // chunk 0 in flight
    if (q + 1 < nchunk) issue_z<T>(a, t, base, q + 1);
    tc::async_commit();
    tc::async_wait_one();
    __syncthreads();
    const int steps = (min(L.ri, n1 - q * L.ri) + 3) / 4;
    const T* z = reinterpret_cast<const T*>(base + L.u + (q & 1) * L.zstride);
    const T* f = reinterpret_cast<const T*>(reinterpret_cast<const char*>(z) +
                                            L.fz);
    for (int st = 0; st < PHASE_BOUND(9, steps); ++st) {
      unsigned fa[kT][4], br[kT][2], bi[kT][2];
      if (one_row) {
        AFrag<T>(z + 16 * (first / nt), 1, L.ldz, L.m1, 16).load(fa[0], st);
#pragma unroll
        for (int u = 1; u < kT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) fa[u][e] = fa[0][e];
        }
      } else {
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          const int tl = min(first + u, L.tiles1 - 1);
          AFrag<T>(z + 16 * (tl / nt), 1, L.ldz, L.m1, 16).load(fa[u], st);
        }
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        const int tl = min(first + u, L.tiles1 - 1);
        BFrag<T>(f + 8 * (tl % nt), L.ldf, 1, L.h1, 8).load(br[u], bi[u], st);
      }
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        chain::mma_bits<kF32, kF32>(acc[u][0], sml[u][0], fa[u], br[u]);
        chain::mma_bits<kF32, kF32>(acc[u][1], sml[u][1], fa[u], bi[u]);
      }
    }
    __syncthreads();
  }
  tc::async_wait_all();
  const chain::Div dnp(np);
#pragma unroll
  for (int u = 0; u < kT; ++u) {
    const int tl = first + u;
    if (tl >= L.tiles1) continue;
    const int mi = tl / nt, n0 = (tl - mi * nt) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mi + lg + 8 * (e >> 1), k1 = n0 + 2 * lt + (e & 1);
      const int bh = dnp.div(m), p = m - bh * np;
      const int b = dhs.div(bh), hl = bh - b * hs;
      if (b < t.nbv && hl < t.nh && p < t.pv && k1 < K1) {
        float* at = A + hl * L.lda + (k1 * L.nb + b) * np + p;
        at[0] = sml[u][0][e] + acc[u][0][e];
        at[L.na] = sml[u][1][e] + acc[u][1][e];
      }
    }
  }
  __syncthreads();
}

// Phase 2: C[k1][(b·np + p)·os + o] (real plane, then imaginary at mc) of my
// out channels, over every hidden channel of the cluster.
template <typename T, bool kPerMode>
__device__ void cgemm_stage(const Args<T>& a, const Tile& t, char* base,
                            float* A, float* C,
                            const cg::cluster_group& cluster) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  const int K1 = a.K1, np = L.np, nb = L.nb, os = L.os;
  const int hsp = L.hsp, hr = L.hr, cl = L.cl;
  // The operands' low TF32 parts: f32 W has one (bf16 W is exact in
  // TF32), A always.
  constexpr bool kWLo = std::is_same<T, float>::value, kALo = true;
  float* All = reinterpret_cast<float*>(base + L.all);
  auto wbuf = [&](int c) {
    return reinterpret_cast<const T*>(base + L.w0 + (c & 1) * L.wstride);
  };
  const int mt = (os + 15) / 16, steps = hr / 4;
  const chain::Div dhsp(hsp), dmt(mt), dnp(np), dnbnp(nb * np);
  // The chunk's A of every rank into All[hrow][0..nc) (imaginary at ncp),
  // 16-byte pieces: the next chunk's first kG pieces a thread are loaded
  // into registers before this chunk's products and stored after them.
  constexpr int kG = kPerMode ? 8 : 4;
  const bool avec = L.nc % 4 == 0 && L.na % 4 == 0;
  const int per = avec ? L.nc / 4 : L.nc;  // pieces of a row's plane
  const int pieces = cl > 1 ? PHASE_BOUND(4, hr * 2 * per) : 0;
  auto piece_src = [&](int c, int i) {
    const int row = i / per, j = i - row * per;
    const int hrow = row >> 1, pl = row & 1;
    const int q = dhsp.div(hrow), hl = hrow - q * hsp;
    return cluster.map_shared_rank(A, q) + hl * L.lda + pl * L.na +
           c * L.nc + (avec ? 4 * j : j);
  };
  auto piece_dst = [&](int i) {
    const int row = i / per, j = i - row * per;
    return All + (row >> 1) * L.ldall + (row & 1) * L.ncp + (avec ? 4 * j : j);
  };
  auto piece = [&](const float* src) {
    return avec ? *reinterpret_cast<const float4*>(src)
                : float4{src[0], 0.f, 0.f, 0.f};
  };
  auto put = [&](float* dst, const float4& v) {
    if (avec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
    }
  };
  float4 pre[kG];
  auto fetch = [&](int c) {
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      const int i = tid + s * kThreads;
      if (i < pieces) pre[s] = piece(piece_src(c, i));
    }
  };
  auto land = [&](int c) {  // the registers, then the pieces past them
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      const int i = tid + s * kThreads;
      if (i < pieces) put(piece_dst(i), pre[s]);
    }
    for (int i = tid + kG * kThreads; i < pieces; i += kThreads)
      put(piece_dst(i), piece(piece_src(c, i)));
  };
  const T* W = wbuf(0);
  const int nchunk = PHASE_BOUND(2, L.nchunk);
  if (nchunk > 0) fetch(0);  // W's chunk 0 is in flight
  for (int c = 0; c < nchunk; ++c) {
    if constexpr (kPerMode) {
      if (c + 1 < nchunk) issue_w<T>(a, t, base, c + 1);
      tc::async_commit();
      W = wbuf(c);
    }
    land(c);
    tc::async_wait_one();  // chunk c has landed
    __syncthreads();
    if (c + 1 < nchunk) fetch(c + 1);
    const float* src = cl > 1 ? All : A + c * L.nc;
    const int ldb = cl > 1 ? L.ldall : L.lda;
    const int plane = cl > 1 ? L.ncp : L.na;
    if constexpr (kPerMode) {
      // A tile: one mode (k1l, p), one half, 16 out channels × 8 samples.
      const int tiles = PHASE_BOUND(8, L.kc * np * 2 * mt);
      for (int tl = warp; tl < tiles; tl += kWarps) {
        const int r = dmt.div(tl), mi = tl - r * mt;
        const int ho = r & 1, mode = r >> 1;
        const int k1l = dnp.div(mode), p = mode - k1l * np;
        const int k1 = c * L.kc + k1l;
        if (k1 >= K1 || p >= t.pv) continue;
        float v[4];
        chain::complex_tile<kWLo, kALo, 4>(
            v,
            AFrag<T>(W + k1l * hr * L.ldw + 16 * mi * np + p, np, L.ldw,
                     os * np, os - 16 * mi),
            BFrag<float>(src + k1l * nb * np + p, ldb, np, plane, nb), ho,
            steps);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 16 * mi + lg + 8 * (e >> 1), b = 2 * lt + (e & 1);
          if (o < os && b < nb)
            C[k1 * L.ldc + ho * L.mc + (b * np + p) * os + o] = v[e];
        }
      }
    } else {
      // A tile: 16 out channels × 8 columns n = (k1l·nb + b)·np + p, one
      // half.
      const int ntc = L.ncp / 8, tiles = PHASE_BOUND(8, mt * ntc * 2);
      for (int tl = warp; tl < tiles; tl += kWarps) {
        const int r = dmt.div(tl), mi = tl - r * mt;
        const int ho = r & 1, jn = r >> 1;
        float v[4];
        chain::complex_tile<kWLo, kALo, 4>(
            v,
            AFrag<T>(W + 16 * mi * L.ldw, L.ldw, 1, L.wrows * L.ldw,
                     os - 16 * mi),
            BFrag<float>(src + 8 * jn, ldb, 1, plane, 8), ho, steps);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 16 * mi + lg + 8 * (e >> 1);
          const int n = 8 * jn + 2 * lt + (e & 1);
          const int k1l = dnbnp.div(n), rem = n - k1l * nb * np;
          const int b = dnp.div(rem), p = rem - b * np;
          const int k1 = c * L.kc + k1l;
          if (o < os && n < L.nc && k1 < K1)
            C[k1 * L.ldc + ho * L.mc + (b * np + p) * os + o] = v[e];
        }
      }
    }
    __syncthreads();
  }
  tc::async_wait_all();
}

// Phase 3: y[b0 + b, p0 + p, o0 + o, :] of my out channels from C.
template <typename T>
__device__ void inverse_stage(const Args<T>& a, const Tile& t, char* base,
                              const float* C) {
  const Layout& L = a.L;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  const int n1 = a.n1, np = L.np, os = L.os, wj = L.wj;
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int nj = (n1 + wj - 1) / wj, mtc = L.mc / 16;
  const int tiles = mtc * (wj / 8), steps = L.kr / 4;
  const chain::Div dmtc(mtc), dos(os), dnp(np);
  const bool put = PHASE_BOUND(7, 1);
  for (int j = 0; j < PHASE_BOUND(3, nj); ++j) {  // chunk 0 in flight
    if (j + 1 < nj) issue_g<T>(a, base, j + 1);
    tc::async_commit();
    tc::async_wait_one();
    __syncthreads();
    const T* g = reinterpret_cast<const T*>(base + (j & 1 ? L.g1 : L.g0));
    // A tile: 16 rows m = (b·np + p)·os + o by 8 points, both halves.
    for (int tl = warp; tl < tiles; tl += kWarps) {
      const int jn = dmtc.div(tl), mi = tl - jn * mtc;
      float v[2][4];
      chain::complex_tile_both<true, kF32>(
          v[0], v[1], AFrag<float>(C + 16 * mi, 1, L.ldc, L.mc, 16),
          BFrag<T>(g + 8 * jn, L.ldg, 1, wj, 8), steps);
      const int jj = j * wj + 8 * jn + 2 * lt;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int m = 16 * mi + lg + 4 * e;
        const int bp = dos.div(m), o = m - bp * os;
        const int b = dnp.div(bp), p = bp - b * np;
        if (put && b < t.nbv && p < t.pv && o < t.no && jj < n1) {
          const size_t row =
              (static_cast<size_t>(t.b0 + b) * a.P + t.p0 + p) * a.O + t.o0 + o;
          store2(a.yr + row * n1 + jj, v[0][e], v[0][e + 1], jj + 1 < n1);
          store2(a.yi + row * n1 + jj, v[1][e], v[1][e + 1], jj + 1 < n1);
        }
      }
    }
    __syncthreads();
  }
  tc::async_wait_all();
}

// Shared W: two blocks a multiprocessor (128 registers a thread); per-mode
// W: one (its shared memory), so its registers are not capped.
template <typename T, bool kPerMode>
__global__ void __launch_bounds__(kThreads, kPerMode ? 1 : 2)
    fused_core_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const Layout& L = a.L;
  Tile t;
  t.rank = static_cast<int>(cluster.block_rank());
  const int pt = static_cast<int>(blockIdx.y);
  const int grp = static_cast<int>(blockIdx.z);
  t.b0 = grp * L.nb;
  t.nbv = min(L.nb, a.B - t.b0);
  t.p0 = pt * L.np;
  t.pv = min(L.np, a.P - t.p0);
  t.h0 = t.rank * L.hs;
  t.nh = max(0, min(L.hs, a.H - t.h0));
  t.o0 = t.rank * L.os;
  t.no = max(0, min(L.os, a.O - t.o0));
  CORE_CLOCK(0);
  float* A = reinterpret_cast<float*>(base + L.a);
  float* C = reinterpret_cast<float*>(base + L.c);
  // The first chunks of phase 2's W stream and of phase 1's z and F.
  if constexpr (kPerMode) {
    if (PHASE_BOUND(2, 1)) issue_w<T>(a, t, base, 0);
  }
  tc::async_commit();
  issue_z<T>(a, t, base, 0);
  tc::async_commit();
  if constexpr (!kPerMode) {
    // Shared W: my out channels' rows [W_r | W_i] over hrow = q·hsp + hl,
    // runs of hs channels by cp.async, zero past the edges.
    T* W = reinterpret_cast<T*>(base + L.w0);
    const int plane = L.wrows * L.ldw;
    for (int i = threadIdx.x; i < 2 * plane; i += kThreads) {
      const int j = i % plane, o = j / L.ldw, hrow = j - o * L.ldw;
      const int q = hrow / L.hsp, hl = hrow - q * L.hsp;
      if (o >= t.no || q >= L.cl || hl >= min(L.hs, a.H - q * L.hs))
        W[i] = zero<T>();
    }
    constexpr int kE = 16 / sizeof(T);
    for (int q = 0; q < L.cl; ++q) {
      const int len = min(L.hs, a.H - q * L.hs);
      if (len <= 0) break;
      const bool vec = len % kE == 0 && L.hs % kE == 0 && a.H % kE == 0 &&
                       tc::aligned16(a.wr) && tc::aligned16(a.wi);
      const size_t at = static_cast<size_t>(t.o0) * a.H + q * L.hs;
      tc::load_tile(W + q * L.hsp, L.ldw, a.wr + at, a.H, t.no, len, vec,
                    kThreads);
      tc::load_tile(W + plane + q * L.hsp, L.ldw, a.wi + at, a.H, t.no, len,
                    vec, kThreads);
    }
    tc::async_commit();
  }
  // The depth's padded rows of A (hidden channels past mine) and of C
  // (modes past K_1) are zero; the stages write every other entry they
  // read, or one that feeds only outputs never stored.
  for (int i = threadIdx.x; i < (L.hsp - t.nh) * L.lda; i += kThreads)
    A[t.nh * L.lda + i] = 0.f;
  for (int i = threadIdx.x; i < (L.kr - a.K1) * L.ldc; i += kThreads)
    C[a.K1 * L.ldc + i] = 0.f;
  __syncthreads();
  CORE_CLOCK(1);
  switch ((L.tiles1 + kWarps - 1) / kWarps) {  // phase 1's tiles a warp
    case 1:
      forward_stage<T, 1>(a, t, base, A);
      break;
    case 2:
      forward_stage<T, 2>(a, t, base, A);
      break;
    case 3:
      forward_stage<T, 3>(a, t, base, A);
      break;
    default:
      forward_stage<T, kMaxT>(a, t, base, A);
  }
  // A cluster barrier (a block barrier in a cluster of one).
  auto csync = [&]() {
    if (L.cl > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  CORE_CLOCK(2);
  csync();  // every rank's A is complete
  CORE_CLOCK(3);
  cgemm_stage<T, kPerMode>(a, t, base, A, C, cluster);
  issue_g<T>(a, base, 0);  // over phase 2's dead buffers
  tc::async_commit();
  CORE_CLOCK(4);
  csync();  // no rank reads my A any more
  CORE_CLOCK(5);
  inverse_stage<T>(a, t, base, C);
  CORE_CLOCK(6);
}

// The launch of plan L: grid (cl, ptiles, groups), clusters of cl along
// x (a cluster of one: a plain launch), the plan's shared memory; `attr`
// must outlive `cfg`.
template <typename T>
cudaError_t configure(const Layout& L, int per_mode, void* stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      void (**kernel)(const Args<T>)) {
  if (!L.ok) return cudaErrorInvalidValue;
  *kernel = per_mode ? fused_core_kernel<T, true>
                     : fused_core_kernel<T, false>;
  const cudaError_t err = fno::configure(
      *kernel, dim3(L.cl, L.ptiles, L.groups), kThreads, L.cl,
      static_cast<int>(L.bytes), static_cast<cudaStream_t>(stream), cfg,
      attr);
  if (L.cl == 1) cfg->numAttrs = 0;
  return err;
}

// The layout of plan {cl, np, nb, kc, ri, wj} at dims, not ok where a
// field is out of range.
inline Layout plan_layout(const int* dims, int esize, const int* pl) {
  for (int i = 0; i < 6; ++i) {
    if (pl[i] < 1) return Layout{};
  }
  if (pl[0] > kMaxCluster) return Layout{};
  return layout(dims, esize, pl[0], pl[1], pl[2], pl[3], pl[4], pl[5]);
}

template <typename T>
int launch(const void* const* ptrs, void* yr, void* yi, const int* dims,
           const int* pl, void* stream) {
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
  a.B = dims[0];
  a.H = dims[1];
  a.O = dims[2];
  a.n1 = dims[3];
  a.K1 = dims[4];
  a.P = dims[5];
  const int per_mode = dims[6];
  a.K2 = dims[7];
  if (a.B < 1 || a.H < 1 || a.O < 1 || a.n1 < 1 || a.K1 < 1 || a.P < 1 ||
      a.K2 < 1 || a.P % a.K2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.L = plan_layout(dims, sizeof(T), pl);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  void (*kernel)(const Args<T>) = nullptr;
  const cudaError_t err =
      configure<T>(a.L, per_mode, stream, &cfg, &attr, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaError_t run = cudaLaunchKernelEx(&cfg, kernel, a);
  if (run != cudaSuccess) return static_cast<int>(run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(const int* dims, const int* pl, int* n) {
  const Layout L = plan_layout(dims, sizeof(T), pl);
  if (!L.ok) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Args<T>) = dims[6] ? fused_core_kernel<T, true>
                                          : fused_core_kernel<T, false>;
  return static_cast<int>(fno::max_clusters(
      kernel, L.cl, static_cast<int>(L.bytes), n, kThreads));
}

}  // namespace

// The launch plan, the one source of the layout: dtype 0 = float32, 1 =
// bfloat16; dims {B, H, O, n1, K1, P, per_mode, K2}; force {cl, np, nb, kc,
// ri, wj} (0: the planner's choice). out: {cl, hs, os, nb, np, kc, ri, wj,
// groups, ptiles, smem, w_bytes}; the launch takes its plan {cl, np, nb,
// kc, ri, wj}. Returns 1 where the plan fits a block and the grid, else 0
// (out then holds the last layout tried).
extern "C" int fused_core_plan(int dtype, const int* dims, const int* force,
                               long long* out) {
  const Layout L = plan(dims, dtype == 1 ? 2 : 4, force);
  const long long v[] = {L.cl, L.hs, L.os,     L.nb,     L.np,    L.kc,
                         L.ri, L.wj, L.groups, L.ptiles, L.bytes, L.w_bytes};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return L.ok;
}

// How many clusters of plan pl's launch (as fused_core's) the card runs at
// once (*n). Returns the cudaError_t of the query.
extern "C" int fused_core_max_clusters(int dtype, const int* dims,
                                       const int* pl, int* n) {
  if (dtype == 0) return max_clusters<float>(dims, pl, n);
  if (dtype == 1) return max_clusters<__nv_bfloat16>(dims, pl, n);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (z, the
// weights, the factors and y). ptrs: device pointers {zr, zi, wr, wi, fr,
// fi, gr, gi}; yr, yi: the outputs [B, P, O, n1]. dims as
// fused_core_plan's (per_mode = 1 takes wr, wi as [O, H, K1, K2..KR],
// contiguous); pl: the plan {cl, np, nb, kc, ri, wj} that fused_core_plan
// gave for these dims. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fused_core(int dtype, const void* const* ptrs, void* yr,
                          void* yi, const int* dims, const int* pl,
                          void* stream) {
  if (dtype == 0) {
    return launch<float>(ptrs, yr, yi, dims, pl, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(ptrs, yr, yi, dims, pl, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef FUSED_CORE_CLOCKS
// The stamps of the last launch: kClocks a block for the first n blocks
// (grid order (z·ptiles + y)·cl + x) into out. Returns the cudaError_t of the copy.
extern "C" int fused_core_clocks(unsigned long long* out, int n) {
  const int blocks = n < kClockBlocks ? n : kClockBlocks;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_core_clocks, sizeof(unsigned long long) * kClocks * blocks));
}
#endif

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* fused_core_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
