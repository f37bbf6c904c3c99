// Fused FNO block for NVIDIA Hopper (sm_90a): one launch computes
//
//   z[b,o,s] = Re iDFT_pad( Σ_h DFT_trunc(x[b,h])·(wr + i·wi)[o,h(,k)] )[s]
//              + Σ_h wb[o,h]·x[b,h,s] + bias[o]
//
// and writes one of three epilogues of it (`act`):
//   0 gelu      y  = gelu_tanh(z)                  the block forward;
//   1 gelu_vjp  gz = gy·gelu_tanh'(z)              the backward's recompute:
//               z is formed again from x and never stored;
//   2 linear    y  = z (bias optional)             with the adjoint operand
//               bundle, [H,O]-transposed weights and wbᵀ this is the
//               backward's dx = spectral_adjoint(gz) + wbᵀ·gz; with
//               no wb and no bias, the bare spectral layer.
//
// With the fused model ends (act gelu with wb and bias), the first block of
// a model takes the raw input and the last one emits the model's output:
//   lift  x[b,h] = l2[h,:]·gelu_tanh(l1·x_in[b] + b1) + b2[h], rounded to
//         the element type, x_in [B,C_in,n_1..n_R];
//   proj  y_out[b,c] = p2[c,:]·gelu_tanh(p1·y[b] + pb1) + pb2[c] on the
//         activated block output y (f32), y_out [B,C_out,n_1..n_R].
//
// Replaces the TPU kernel repro/kernels/engine.py::fused_fnond_call
// (_make_fwd_kernel, engine.py:161-427) in those modes and its lift/proj
// ends (has_lift / has_proj), with shared weights W[o,h] or per-mode
// weights W[o,h,k_1..k_R] (the classic FNO layout), optional bypass and
// bias epilogue. Spatial rank
// R ∈ {1,2,3}; element type float or __nv_bfloat16 for x, gy, the weights
// and the DFT operands; every sum accumulates in f32; the output is written
// once, at the element type or (out_f32) in f32.
//
// What bounds it on an H100. At fno2d (B=8, H=O=64, 128×128, 32×32 modes)
// the block needs ~1.9 GFLOP when its transforms are FFTs (2.5·N·log2 N per
// channel each way) beside the CGEMM and the bypass, against ~67 MB of x and
// y in f32: the bytes bound it (~20 µs at 3.35 TB/s; 3xTF32 on the tensor
// cores does f32-accurate work at 165 TFLOP/s). This kernel computes the
// truncated transforms as dense DFT products, ~4.6 GFLOP: both chains run
// on the tensor cores (mma.sync, chain_tc.cuh; f32 as 3xTF32), so their
// time goes to barriers, fragment loads and the few tiles of a chunk;
// wgmma and TMA are later work.
//
// Design. The TPU kernel walks a sequential grid over hidden tiles and carries
// the spectral accumulator of a (batch, out) tile in 16 MiB of VMEM. Hopper
// blocks run in parallel and get at most 227 KB of shared memory, so:
//   * one thread-block CLUSTER of CL blocks serves one sample b (CL = 16
//     when the card holds the whole batch's 16-block clusters at once, else
//     the portable 8; the wrapper asks the card and picks);
//   * phase 1 — block r runs the truncated forward DFT chain for its slice of
//     hidden channels, streaming x over s_1 chunks, and keeps the spectra
//     A[h, k_1..k_R] (complex, f32) in its own shared memory. The chain is
//     chain_tc.cuh's on the tensor cores, or (the plan's "chain", where its
//     resident factors do not fit, and with the lift) fno_common.cuh's on
//     the CUDA cores; its work area lies over C and the tail, dead until
//     phase 2;
//   * phase 2 — after a cluster barrier, block r forms the CGEMM
//     C[o,k] = Σ_h W[o,h(,k)]·A[h,k] for its slice of out channels, reading
//     the other blocks' spectra through distributed shared memory: the
//     spectrum never touches device memory, and no block recomputes
//     another's DFTs. Shared weights sit in shared memory; per-mode weights
//     (at fno2d-large 8 MB per out slice in f32) cannot, so each thread
//     streams its modes' weights from device memory, neighbouring threads
//     on neighbouring modes (coalesced). Every cluster reads all of W, so a
//     batch of B reads it B times: 1.07 GB per launch at fno2d-large B=8.
//     W is read through element strides of its out and hidden axes, so dx
//     takes the [H,O(,K)] swap as a view, without a copy;
//   * phase 3 — per s_1 chunk, the padded inverse chain on the tensor cores
//     (chain_tc.cuh inverse_chunk: s_1 first, the real irDFT on s_R last,
//     its factors resident) into ys, which lies over the dead spectra A
//     where it fits (so a chunk takes as many s_1 rows as shared memory
//     holds); then the epilogue split by points (split_epilogue): block r
//     forms all O channels at 1/CL of the chunk's points, the bypass
//     Σ_h wb·x reading each x element once a cluster (it was read by every
//     block, 16 × x from L2), the other blocks' ys through distributed
//     shared memory, + bias, the activation and a single write. With the
//     ends each block keeps its own channels (the projection gathers them).
// Occupancy is low at small batches (B·CL blocks of 132 SMs). Ragged extents
// are masked here: the TPU's lane padding is not ported.
//
// Tiles (kTiled). Where a cluster cannot hold every hidden channel's
// spectra or every out channel (more than CL·kMaxOut), the plan takes the
// TPU kernel's two tiling axes: the hidden k-loop (phases 1 and 2 run once
// per chunk of hc channels a block; C accumulates across the chunks and
// stays resident, so phase 1's work area moves past C, onto the tail, and
// phase 3's factors are copied after the last chunk) and out tiles (grid
// z: each cluster owns CL·os out channels of a sample and forms their
// epilogue, recomputing the forward spectra once a tile). The ends take no
// tiled plan: the projection contracts every out channel.
//
// The ends (kEnds). The TPU kernel holds the lift's inner activation of a
// whole sample in VMEM across its hidden loop; here both MLPs are
// channel-pointwise, so each needs only the s_1 chunk at hand, and the lifted
// or projected activations never reach device memory. Every block of the
// cluster would need every point's inner activation (L·(C_in + 1) MACs and
// L tanh a point) if it formed its own channels, CL times the work; instead
// the cluster splits each chunk's points into pieces of CL·ep, block r takes
// ep of them, and the results are exchanged through distributed shared
// memory:
//   * lift, phase 1 — per chunk of rows_f s_1 rows and piece, block r forms
//     the inner activation of its points [L][ep] and from it the lifted
//     hidden state of ALL H channels there (a small GEMM with l2, rounded
//     to the element type as the staged lift emits it), the cluster syncs,
//     each block gathers its own hs channels at every point of the piece,
//     and the cluster syncs again before the next piece; then the chain runs
//     on the gathered chunk;
//   * lift, phase 3 — the bypass Σ_h wb·x needs all H lifted channels at a
//     point: per inverse chunk and piece, after the inverse chain, block r
//     lifts its points again and forms the bypass of ALL O out channels
//     there (a GEMM with wb), and each block adds its os channels' bypass
//     into ys, gathered as in phase 1;
//   * proj, phase 3 — block r writes its activated out channels back into
//     ys, the cluster syncs, and per piece each block gathers all O
//     channels of its ep points and runs the projection MLP on them (two
//     small GEMMs, the hidden units [Lp][ep] in shared memory); the
//     cluster syncs again before the next chunk overwrites ys.
// The small GEMMs hold a 4×4 register tile a thread, so each weight or
// activation load feeds four FMAs.
#include <cooperative_groups.h>

#include "fno_common.cuh"  // first: a test may stand a copy in for it
#include "chain_tc.cuh"

namespace cg = cooperative_groups;
using fno::kThreads;
using fno::ld;

namespace {

constexpr int kMaxOut = 8;  // out channels per block (registers in phase 2/3)
constexpr int kPts = 2;     // points per thread in the ends' bypass epilogue
constexpr int kOG = 32;     // out channels a thread forms at once in the
                            // split epilogue (registers)

enum Act { kGelu = 0, kGeluVjp = 1, kLinear = 2 };

// Loop bound of phase i (1..7) below: 1 forward chain, 2 CGEMM, 3 inverse
// chain and epilogue, 4 the lift (its pieces in phases 1 and 3), 5 the
// projection; within phase 3, 6 the inverse chain alone and 7 the bypass's
// loop over the hidden channels. Built with -DFUSED_BLOCK_ELIDE=<mask>, the
// phases whose bit (1 << i) is set run no iteration: the output is then
// wrong and only the time counts (launch/block_phases.py).
#ifndef FUSED_BLOCK_ELIDE
#define FUSED_BLOCK_ELIDE 0
#endif
#define PHASE_BOUND(i, n) (((FUSED_BLOCK_ELIDE >> (i)) & 1) ? 0 : (n))

// Shared-memory layout (byte offsets, regions 128-B aligned): my rows of
// the shared weights, and with the ends of wb and the bias, from 0; the
// spectra A [2][hc][K] of a hidden chunk; C [dc][ldc] (phase 2's CGEMM
// result as the inverse chain reads it, C[k1][o·Kp + k']); the tail.
// Phase 1's work area starts at C (over C and the tail: C is written only
// after the cluster barrier that ends phase 1), or, with the hidden k-loop
// (kloop: C accumulates over the chunks and stays resident), at the tail,
// whose factors are copied only after the last chunk's phase 1; phase 3
// keeps C, and its factors and stages in the tail, where the ends' scratch
// lies over them (a launch with the ends copies the factors again each
// chunk), and ys [os][ri·P] over A when it fits there (A is dead after the
// barrier that ends phase 2), else after them.
struct BLayout {
  long long a, c, t, ys;  // A, C, the tail, ys
  long long w1;           // phase 1's work area
  long long p1, p3;       // the ends of phases 1 and 3
  long long bytes;
  chain::Layout chain;    // phase 1 on the tensor cores
  chain::InvLayout inv;   // phase 3's factors and stages, from t
};

// Mirrored by kernels/engine.py _block_layout. hc: hidden channels a block
// holds at once (its whole slice hs, or with kloop a chunk of it); wl, dp:
// columns of the last inverse factor and rows of the first held at once;
// fma: phase 1 on the CUDA cores (fno::forward_chain); lift (> 0, the
// lift's width) runs it on the lifted chunk; lp, cout: the projection's
// width and channels (0: none); ep: points a block takes of a piece of the
// ends.
__host__ __device__ inline BLayout block_layout(int R, int esize, int H,
                                                int O, const int* n,
                                                const int* k, int hc, int os,
                                                int rows_f, int rows_i,
                                                int wl, int dp, bool fma,
                                                bool per_mode, int lift,
                                                int lp, int cout, int ep,
                                                bool kloop) {
  using tc::align128;
  BLayout B = {};
  const long long K = 1LL * k[0] * k[1] * k[2];
  const long long P = 1LL * n[1] * n[2];
  const bool ends = lift > 0 || lp > 0;  // wb's rows and the bias too
  B.a = align128(4LL * ((per_mode ? 0 : 2) * os * H +
                        (ends ? os * H + kMaxOut : 0)));
  B.c = align128(B.a + 8LL * hc * K);
  B.inv = chain::inv_layout(R, n, k, os, rows_i, wl, dp);
  B.t = align128(B.c + B.inv.cbytes);
  long long p1;
  if (lift > 0) {  // hbuf [hs][rf·P], then the chain's or the piece's
    const long long chain = fno::chain_work(R, n, k, rows_f) - rows_f * P;
    const long long piece = 1LL * (lift + H) * ep;
    p1 = 4 * (hc * rows_f * P + (chain > piece ? chain : piece));
  } else if (fma) {
    p1 = 4 * fno::chain_work(R, n, k, rows_f);
  } else {
    B.chain = chain::layout(R, esize, n, k, rows_f, hc);
    p1 = B.chain.bytes;
  }
  B.w1 = kloop ? B.t : B.c;
  B.p1 = B.w1 + p1;
  // The factors and stages; over the stages the split epilogue's wb
  // columns [H][kOG], or over them all the ends' scratch.
  long long tail = B.inv.bytes;
  const long long lifted = 4LL * ((lift > O ? lift : O) + H) * ep;
  const long long projected = 4LL * (O + lp + cout) * ep;
  const long long split = B.inv.fbytes + 4LL * H * kOG;
  if (lift == 0 && lp == 0 && split > tail) tail = split;
  if (lift > 0 && lifted > tail) tail = lifted;
  if (lp > 0 && projected > tail) tail = projected;
  long long end = align128(B.t + tail);
  const long long ysb = 4LL * os * rows_i * P;
  if (ysb <= 8LL * hc * K) {
    B.ys = B.a;
  } else {
    B.ys = end;
    end = align128(end + ysb);
  }
  B.p3 = end;
  B.bytes = B.p1 > B.p3 ? B.p1 : B.p3;
  return B;
}

template <typename T>
struct Args {
  const T* x;     // [B, H, n_1..n_R]
  const T* wr;    // [O, H] shared, or [O, H, K] per-mode, at the strides
  const T* wi;    // below over O and H (modes contiguous)
  const T* wb;    // [O, H], or null: no bypass (the bare spectral layer)
  const T* bias;  // [O], or null: no bias
  const T* gy;    // [B, O, n_1..n_R] for act=gelu_vjp, else null
  fno::Mats<T> f;  // forward stage i (axis R-i): [n, k]
  fno::Mats<T> e;  // inverse stage i (axis 1+i): [k, n]
  void* y;        // [B, O, n_1..n_R], float if out_f32 else T
  int act, out_f32;
  int H, O;
  int n[3], k[3];  // extents and modes, axis order 1..R (unused = 1)
  int hs, os;      // hidden / out channels per block of the cluster
  int hc;          // hidden channels a block's chunk (kTiled; else hs)
  int rows_f, rows_i;  // s_1 rows per forward / inverse chunk
  int fma;         // phase 1 on the CUDA cores (else the tensor cores)
  BLayout lay;
  long long w_so, w_sh;  // W's element strides of o and h
  // Fused model ends (kEnds only), null where that end is absent. With the
  // lift, x is the raw input [B, cin, n_1..n_R].
  const T* l1w;  // [L, cin]
  const T* l1b;  // [L]
  const T* l2w;  // [H, L]
  const T* l2b;  // [H]
  const T* p1w;  // [Lp, O]
  const T* p1b;  // [Lp]
  const T* p2w;  // [cout, Lp]
  const T* p2b;  // [cout]; y is then [B, cout, n_1..n_R]
  int cin, L, Lp, cout;
  int ep;  // points a block takes of each piece of a chunk
};

// The lift's inner activation gelu_tanh(l1[l,:]·x_in + b1[l]) at the point
// xp (channel stride S).
template <typename T>
__device__ __forceinline__ float lift_inner(const Args<T>& a, int l,
                                            const T* xp, int S) {
  float s = ld(a.l1b + l);
  for (int c = 0; c < a.cin; ++c)
    s = fmaf(ld(a.l1w + l * a.cin + c), ld(xp + static_cast<size_t>(c) * S),
             s);
  return fno::gelu_tanh(s);
}

enum Epi { kStore, kBias, kBiasRound, kBiasGelu };
constexpr int kKU = 4;  // steps of k whose loads a small GEMM sends at once
constexpr int kGU = 4;  // remote loads a thread of a gather sends at once

// out[m·ldo + n] = epi(Σ_{k<K} A[m·lda + k]·B[k·ldb + n]) for m < M, n < N:
// A in device memory (T, read through the read-only cache), B and out in
// shared memory. Each thread holds a 4×4 tile, rows m0..m0+3 and columns
// nb + j·tn, so one load of A or B feeds four FMAs and neighbouring threads
// read neighbouring columns of B; the loads of kKU steps of k are sent
// together, as these GEMMs are small and run on few threads, bound by load
// latency. epi: kStore s; kBias s + bias[m]; kBiasRound s + bias[m]
// rounded to T; kBiasGelu gelu_tanh(s + bias[m]). Ends synchronised.
template <typename T, int kEpi>
__device__ void tile_gemm(const T* A, int lda, const float* B, int ldb,
                          int M, int N, int K, const T* bias, float* out,
                          int ldo) {
  const int tn = (N + 3) / 4, tm = (M + 3) / 4;
  for (int t = threadIdx.x; t < tm * tn; t += kThreads) {
    const int nb = t % tn, m0 = t / tn * 4;
    int m[4], n[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = min(m0 + i, M - 1);
      n[i] = min(nb + i * tn, N - 1);
    }
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kKU) {
      float av[kKU][4], bv[kKU][4];
#pragma unroll
      for (int u = 0; u < kKU; ++u) {
        const int k = min(k0 + u, K - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[u][i] = k0 + u < K ? ld(A + static_cast<size_t>(m[i]) * lda + k)
                                : 0.f;
          bv[u][i] = B[k * ldb + n[i]];
        }
      }
#pragma unroll
      for (int u = 0; u < kKU; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[u][i], bv[u][j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + i >= M) break;
      const float bm = kEpi == kStore ? 0.f : ld(bias + m0 + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + j * tn >= N) break;
        float v = acc[i][j] + bm;
        if (kEpi == kBiasRound) v = fno::round_to<T>(v);
        if (kEpi == kBiasGelu) v = fno::gelu_tanh(v);
        out[(m0 + i) * ldo + nb + j * tn] = v;
      }
    }
  }
  __syncthreads();
}

// The lift at np points of a chunk (xp: the raw input of this sample at the
// first of them, channel stride S): act [L][ep] = gelu_tanh(l1·x + b1), then
// h [H][ep] = l2·act + b2 rounded to T, the lifted hidden state of all H
// channels there. Ends synchronised.
template <typename T>
__device__ void lift_points(const Args<T>& a, const T* xp, int S, int np,
                            float* act, float* h) {
  for (int i = threadIdx.x; i < a.L * np; i += kThreads) {
    const int l = i / np, q = i % np;
    act[l * a.ep + q] = lift_inner(a, l, xp + q, S);
  }
  __syncthreads();
  tile_gemm<T, kBiasRound>(a.l2w, a.L, act, a.ep, a.H, np, a.L, a.l2b, h,
                           a.ep);
}

// Gathers rows r0..r0+nrow of every block's [rows][ep] piece buffer `src`
// (at one offset in each block's shared memory) into dst[r·ldd + p] for the
// piece's np points p (block j holds points j·ep..), or with kAdd adds them
// there, kGU remote loads in flight a thread. The caller syncs the cluster
// before and after.
template <bool kAdd>
__device__ __forceinline__ void gather_piece(cg::cluster_group cl_g,
                                             float* src, int r0, int nrow,
                                             int ep, int np, float* dst,
                                             int ldd) {
  const int n = nrow * np;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kGU) {
    float v[kGU];
#pragma unroll
    for (int u = 0; u < kGU; ++u) {
      const int i = min(i0 + u * kThreads, n - 1);
      const int r = i / np, p = i % np;
      v[u] = cl_g.map_shared_rank(src, p / ep)[(r0 + r) * ep + p % ep];
    }
#pragma unroll
    for (int u = 0; u < kGU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        float& d = dst[i / np * ldd + i % np];
        d = kAdd ? d + v[u] : v[u];
      }
    }
  }
}

// The epilogue of a launch without the ends, split over the cluster by
// points: once every block has its os channels of the chunk in its ys,
// block r takes 1/CL of the chunk's npts points (from `base` of the
// sample's S) and forms all O channels there: the bypass Σ_h wb[o][h]·x[h]
// (x read by one block of the cluster, coalesced; wb's columns of kOG out
// channels at a time staged transposed in wg [H][kOG], one float4 load
// feeding four FMAs), the owning block's ys through distributed shared
// memory, + bias, the activation and one coalesced write. The cluster
// syncs before and after: no block overwrites its ys while another reads
// it. Not inlined, with its operands by value: its kOG accumulators would
// otherwise share the kernel's 128 registers with the chains' live state
// and spill.
template <typename T, bool kBypass>
__device__ FNO_NOINLINE void split_epilogue(
    const T* x, const T* wb, const T* bias, const T* gy, void* y, int act,
    int out_f32, int H, int O, int os, float* ys, float* wg, int base,
    int npts, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, cl = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (npts + cl - 1) / cl;
  const int q0 = min(npts, rank * per), q1 = min(npts, q0 + per);
  const chain::Div dos(os);
  cluster.sync();  // every block's channels of the chunk are in its ys
  for (int og = 0; og < O; og += kOG) {
    const int ng = min(kOG, O - og);
    if (kBypass) {
      for (int i = tid; i < H * kOG; i += kThreads) {
        const int h = i / kOG, j = i - h * kOG;
        wg[i] = j < ng ? ld(wb + static_cast<size_t>(og + j) * H + h) : 0.f;
      }
      __syncthreads();
    }
    for (int p = q0 + tid; p < q1; p += kThreads) {
      float acc[kOG];
#pragma unroll
      for (int j = 0; j < kOG; ++j) acc[j] = 0.f;
      if (kBypass) {
        for (int h = 0; h < PHASE_BOUND(7, H); ++h) {
          const float xv = ld(x + static_cast<size_t>(h) * S + base + p);
          const float4* w4 = reinterpret_cast<const float4*>(wg + h * kOG);
#pragma unroll
          for (int j = 0; j < kOG / 4; ++j) {
            const float4 w = w4[j];
            acc[4 * j] = fmaf(w.x, xv, acc[4 * j]);
            acc[4 * j + 1] = fmaf(w.y, xv, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(w.z, xv, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(w.w, xv, acc[4 * j + 3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kOG; ++j) {
        if (j >= ng) break;
        const int o = og + j, q = dos.div(o);
        // The output and gy share one (o, point) index of the sample.
        const size_t at = static_cast<size_t>(o) * S + base + p;
        const float z =
            (cluster.map_shared_rank(ys, q)[(o - q * os) * npts + p] +
             acc[j]) +
            (bias ? ld(bias + o) : 0.f);
        float v = z;
        if (act == kGelu) {
          v = fno::gelu_tanh(z);
        } else if (act == kGeluVjp) {
          v = ld(gy + at) * fno::dgelu_tanh(z);
        }
        if (out_f32) {
          static_cast<float*>(y)[at] = v;
        } else {
          fno::st(static_cast<T*>(y) + at, v);
        }
      }
    }
    __syncthreads();  // the next group's columns of wb go over these
  }
  cluster.sync();  // every block has read the chunk's ys
}

// The tiled instances' body (kTiled): the hidden k-loop and out tiles (see
// "Tiles" above), without the ends. A function of its own that the kernel
// calls in place of its body, so that the untiled instances keep their
// code: folded into the body, the switch cost them 11–37 % on the H100
// (register allocation; turns against the code before it).
template <int R, typename T, bool kBypass, bool kPerMode>
__device__ __forceinline__ void tiled_block(const Args<T>& a, float* smem) {
  char* base = reinterpret_cast<char*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(gridDim.x);  // the cluster spans grid x
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, os = a.os, hc = a.hc;
  const fno::Geom g = fno::make_geom<R>(a.n, a.k);
  const int n1 = g.n1, k1 = g.k1;
  const int P = g.P, Kp = g.Kp, K = g.K, S = g.S;
  // The out tile's first channel and channels; my out slice of it.
  const int ob = static_cast<int>(blockIdx.z) * cl * os;
  const int on = min(cl * os, O - ob);
  const int o0 = ob + rank * os, no = max(0, min(os, O - o0));
  const BLayout& L = a.lay;
  float* Wr = smem;
  float* Wi = Wr + (kPerMode ? 0 : os * H);
  float* Ar = reinterpret_cast<float*>(base + L.a);
  float* Ai = Ar + hc * K;
  float* Cr = reinterpret_cast<float*>(base + L.c);
  float* Ci = Cr + L.inv.mc;
  for (int i = tid; i < (kPerMode ? 0 : no * H); i += kThreads) {
    const size_t at = (o0 + i / H) * a.w_so + i % H * a.w_sh;
    Wr[i] = ld(a.wr + at);
    Wi[i] = ld(a.wi + at);
  }

  // The hidden k-loop: chunk j holds channels hb + r·hc.. of block r.
  // Phase 1's work area lies past C, which accumulates across the chunks;
  // phase 3's factors go into the tail after the last chunk.
  const int chunks = (H + cl * hc - 1) / (cl * hc);
  for (int j = 0; j < chunks; ++j) {
    const int hb = j * cl * hc;
    const int h0 = hb + rank * hc, nh = max(0, min(hc, H - h0));
    for (int i = tid; i < hc * K; i += kThreads) Ar[i] = Ai[i] = 0.f;
    __syncthreads();
    const T* xh = a.x + (static_cast<size_t>(b) * H + h0) * S;
    if (a.fma) {
      fno::forward_chain<R, T>(xh, PHASE_BOUND(1, nh), g, a.rows_f, a.f, Ar,
                               Ai, K, reinterpret_cast<float*>(base + L.w1));
    } else {
      chain::forward_chain<R, T>(xh, PHASE_BOUND(1, nh), g, L.chain, a.f, Ar,
                                 Ai, K, base + L.w1);
    }
    if (j == chunks - 1)
      chain::inverse_factors<R, T>(L.inv, base + L.t, a.e, g);
    cluster.sync();
    // Phase 2 over the chunk's channels, added to the earlier chunks' sums
    // in C (the first chunk writes them).
    for (int i = tid; i < (L.inv.dc - k1) * L.inv.ldc; i += kThreads)
      Cr[k1 * L.inv.ldc + i] = 0.f;
    for (int kk = tid; kk < PHASE_BOUND(2, K); kk += kThreads) {
      const size_t wbase = static_cast<size_t>(o0) * a.w_so + kk;
      const int c1 = kk / Kp, at = c1 * L.inv.ldc + kk - c1 * Kp;
      float cr[kMaxOut], ci[kMaxOut];
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        const bool acc = j > 0 && o < os;  // C holds the sums so far
        cr[o] = acc ? Cr[at + o * Kp] : 0.f;
        ci[o] = acc ? Ci[at + o * Kp] : 0.f;
      }
      for (int src = 0; src < cl; ++src) {
        const float* rAr = cluster.map_shared_rank(Ar, src);
        const float* rAi = cluster.map_shared_rank(Ai, src);
        const int hsrc = hb + src * hc;
        const int nhs = max(0, min(hc, H - hsrc));
        for (int hh = 0; hh < nhs; ++hh) {
          const float ar = rAr[hh * K + kk];
          const float ai = rAi[hh * K + kk];
          const int h = hsrc + hh;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < no) {
              float wr, wi;
              if (kPerMode) {
                const size_t w = wbase + o * a.w_so + h * a.w_sh;
                wr = ld(a.wr + w);
                wi = ld(a.wi + w);
              } else {
                wr = Wr[o * H + h];
                wi = Wi[o * H + h];
              }
              cr[o] = fmaf(wr, ar, fmaf(-wi, ai, cr[o]));
              ci[o] = fmaf(wr, ai, fmaf(wi, ar, ci[o]));
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < os) {
          Cr[at + o * Kp] = o < no ? cr[o] : 0.f;
          Ci[at + o * Kp] = o < no ? ci[o] : 0.f;
        }
      }
    }
    cluster.sync();  // no block reuses its spectra while another reads them
  }

  // Phase 3 as the untiled kernel's without the ends, the epilogue over
  // the out tile's channels: its rows of wb, the bias, gy and y.
  const int ri = a.rows_i;
  float* ys = reinterpret_cast<float*>(base + L.ys);  // [os][nr·P]
  const size_t sb = static_cast<size_t>(b) * S;  // the sample's offsets
  const size_t so = sb * O + static_cast<size_t>(ob) * S;
  for (int c0 = 0; c0 < PHASE_BOUND(3, n1); c0 += ri) {
    const int nr = min(ri, n1 - c0);
    tc::async_wait_all();
    __syncthreads();  // the inverse factors have landed
    if (PHASE_BOUND(6, 1))
      chain::inverse_chunk<R, T>(Cr, L.inv, base + L.t, a.e, g, os, nr, c0,
                                 ys);
    split_epilogue<T, kBypass>(
        a.x + sb * H, kBypass ? a.wb + static_cast<size_t>(ob) * H : a.wb,
        a.bias ? a.bias + ob : nullptr, a.gy ? a.gy + so : nullptr,
        a.out_f32 ? static_cast<void*>(static_cast<float*>(a.y) + so)
                  : static_cast<void*>(static_cast<T*>(a.y) + so),
        a.act, a.out_f32, H, on, os, ys,
        reinterpret_cast<float*>(base + L.t + L.inv.fbytes), c0 * P,
        nr * P, S);
  }
}

// kBypass=false (wb null) compiles the bare spectral layer: no wb loads and
// no bypass loop, while the bypass path keeps its code unchanged.
// kPerMode=true reads per-mode weights from device memory in phase 2;
// kPerMode=false stages the shared weights' rows in shared memory.
// kEnds=true (with kBypass only) compiles the fused model ends; which ends
// run is read from the operands, once per chunk. kTiled=true (never with
// kEnds) runs tiled_block instead.
template <int R, typename T, bool kBypass, bool kPerMode, bool kEnds,
          bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  static_assert(!(kEnds && kTiled), "the ends contract the whole out axis");
  if constexpr (kTiled) {
    tiled_block<R, T, kBypass, kPerMode>(a, smem);
    return;
  }
  char* base = reinterpret_cast<char*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(gridDim.x);  // the cluster spans grid x
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, hs = a.hs, os = a.os;
  const fno::Geom g = fno::make_geom<R>(a.n, a.k);
  const int n1 = g.n1, k1 = g.k1;
  const int P = g.P, Kp = g.Kp, K = g.K, S = g.S;
  const int h0 = rank * hs, nh = max(0, min(hs, H - h0));
  const int o0 = rank * os, no = max(0, min(os, O - o0));
  const bool lifted = kEnds && a.l1w != nullptr;
  const bool projected = kEnds && a.p1w != nullptr;
  const int ep = a.ep;

  // Shared memory (BLayout): my rows of the shared weights (and with the
  // ends of wb, and the bias), the spectra A of my hidden slice, the CGEMM
  // result C of my out slice, then the tail.
  const BLayout& L = a.lay;
  float* Wr = smem;
  float* Wi = Wr + (kPerMode ? 0 : os * H);
  float* Wb = Wi + (kPerMode ? 0 : os * H);
  float* Bs = Wb + os * H;
  float* Ar = reinterpret_cast<float*>(base + L.a);
  float* Ai = Ar + hs * K;
  float* Cr = reinterpret_cast<float*>(base + L.c);
  float* Ci = Cr + L.inv.mc;
  float* work = Cr;  // phase 1's work area, over C and the tail

  for (int i = tid; i < ((kPerMode && !kEnds) ? 0 : no * H); i += kThreads) {
    const int o = o0 + i / H, h = i % H;
    if (!kPerMode) {
      const size_t at = o * a.w_so + h * a.w_sh;
      Wr[i] = ld(a.wr + at);
      Wi[i] = ld(a.wi + at);
    }
    if (kEnds) Wb[i] = ld(a.wb + o * H + h);
  }
  for (int i = tid; i < (kEnds ? no : 0); i += kThreads)
    Bs[i] = ld(a.bias + o0 + i);
  for (int i = tid; i < hs * K; i += kThreads) Ar[i] = Ai[i] = 0.f;
  __syncthreads();

  // Phase 1: truncated forward DFT chain of my hidden channels (axis s_R
  // first), streamed over chunks of s_1 rows; the s_1 stage accumulates.
  const T* xin = a.x + static_cast<size_t>(b) * a.cin * S;  // with the lift
  if (lifted) {
    // Per chunk, my hidden channels in hbuf [hs][rf·P], gathered piece by
    // piece from the blocks that lifted them; then the chain on them.
    const int rf = a.rows_f;
    float* hbuf = work;
    float* act = hbuf + hs * rf * P;  // [L][ep], then h [H][ep]
    float* hp = act + a.L * ep;
    for (int c0 = 0; c0 < n1; c0 += rf) {
      const int nr = min(rf, n1 - c0);
      for (int p0 = 0; p0 < PHASE_BOUND(4, nr * P); p0 += cl * ep) {
        const int np = min(cl * ep, nr * P - p0);
        const int mine = max(0, min(ep, np - rank * ep));
        lift_points(a, xin + c0 * P + p0 + rank * ep, S, mine, act, hp);
        cluster.sync();  // every block's points are lifted
        gather_piece<false>(cluster, hp, h0, nh, ep, np, hbuf + p0, rf * P);
        cluster.sync();  // no block overwrites hp while another reads it
      }
      for (int c = 0; c < PHASE_BOUND(1, nh); ++c)
        fno::chain_chunk<R, T>(hbuf + c * rf * P, nr, c0, g, rf, a.f,
                               Ar + c * K, Ai + c * K, act);
    }
  } else if (a.fma) {
    fno::forward_chain<R, T>(a.x + (static_cast<size_t>(b) * H + h0) * S,
                             PHASE_BOUND(1, nh), g, a.rows_f, a.f, Ar, Ai, K,
                             work);
  } else {
    chain::forward_chain<R, T>(a.x + (static_cast<size_t>(b) * H + h0) * S,
                               PHASE_BOUND(1, nh), g, L.chain, a.f, Ar, Ai,
                               K, base + L.c);
  }
  // Phase 3's factors into the tail, zeroed with its stages: their copies
  // land while the CGEMM runs.
  chain::inverse_factors<R, T>(L.inv, base + L.t, a.e, g);
  cluster.sync();

  // Phase 2: CGEMM over the whole hidden axis, reading every block's spectra
  // through distributed shared memory, into C[k_1][o·Kp + k'] (the rows of
  // C past k_1 zero, and its columns of channels past mine: the inverse
  // chain's depth and M). Per-mode: W[o0 + o, h, kk] at wbase + o·w_so +
  // h·w_sh.
  for (int i = tid; i < (L.inv.dc - k1) * L.inv.ldc; i += kThreads)
    Cr[k1 * L.inv.ldc + i] = 0.f;
  for (int kk = tid; kk < PHASE_BOUND(2, K); kk += kThreads) {
    const size_t wbase = static_cast<size_t>(o0) * a.w_so + kk;
    float cr[kMaxOut], ci[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) cr[o] = ci[o] = 0.f;
    for (int src = 0; src < cl; ++src) {
      const float* rAr = cluster.map_shared_rank(Ar, src);
      const float* rAi = cluster.map_shared_rank(Ai, src);
      const int hb = src * hs;
      const int nhs = max(0, min(hs, H - hb));
      for (int hh = 0; hh < nhs; ++hh) {
        const float ar = rAr[hh * K + kk];
        const float ai = rAi[hh * K + kk];
        const int h = hb + hh;
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < no) {
            float wr, wi;
            if (kPerMode) {
              const size_t at = wbase + o * a.w_so + h * a.w_sh;
              wr = ld(a.wr + at);
              wi = ld(a.wi + at);
            } else {
              wr = Wr[o * H + h];
              wi = Wi[o * H + h];
            }
            cr[o] = fmaf(wr, ar, fmaf(-wi, ai, cr[o]));
            ci[o] = fmaf(wr, ai, fmaf(wi, ar, ci[o]));
          }
        }
      }
    }
    const int c1 = kk / Kp, at = c1 * L.inv.ldc + kk - c1 * Kp;
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < os) {
        Cr[at + o * Kp] = o < no ? cr[o] : 0.f;
        Ci[at + o * Kp] = o < no ? ci[o] : 0.f;
      }
    }
  }
  // No block may leave, or reuse its spectra, while another still reads them.
  cluster.sync();

  // Phase 3: per s_1 chunk, the padded inverse chain (s_1 first, real irDFT
  // on s_R last) into ys[o][r·P + p], then bypass + bias + epilogue and one
  // write. The ends' scratch lies over the inverse chain's factors and
  // stages: with the ends, each chunk copies the factors again.
  const int ri = a.rows_i;
  float* ys = reinterpret_cast<float*>(base + L.ys);  // [os][nr·P]
  float* scratch = reinterpret_cast<float*>(base + L.t);
  for (int c0 = 0; c0 < PHASE_BOUND(3, n1); c0 += ri) {
    const int nr = min(ri, n1 - c0);
    const int npts = nr * P;
    if (c0 > 0 && (lifted || projected))
      chain::inverse_factors<R, T>(L.inv, base + L.t, a.e, g);
    tc::async_wait_all();
    __syncthreads();  // the inverse factors have landed
    if (PHASE_BOUND(6, 1))
      chain::inverse_chunk<R, T>(Cr, L.inv, base + L.t, a.e, g, os, nr, c0,
                                 ys);
    if (lifted) {
      // Per piece: lift my points and form the bypass of all O channels
      // there, wb·h, in act's place; then add my channels' bypass into ys.
      float* act = scratch;  // [max(L, O)][ep], then h [H][ep]
      float* hp = act + max(a.L, O) * ep;
      for (int p0 = 0; p0 < PHASE_BOUND(4, npts); p0 += cl * ep) {
        const int np = min(cl * ep, npts - p0);
        const int mine = max(0, min(ep, np - rank * ep));
        lift_points(a, xin + c0 * P + p0 + rank * ep, S, mine, act, hp);
        tile_gemm<T, kStore>(a.wb, H, hp, ep, O, mine, H, nullptr, act, ep);
        cluster.sync();
        gather_piece<true>(cluster, act, o0, no, ep, np, ys + p0, npts);
        cluster.sync();
      }
    }
    if constexpr (!kEnds) {
      const size_t sb = static_cast<size_t>(b) * S;  // the sample's offsets
      split_epilogue<T, kBypass>(
          a.x + sb * H, a.wb, a.bias, a.gy ? a.gy + sb * O : nullptr,
          a.out_f32 ? static_cast<void*>(static_cast<float*>(a.y) + sb * O)
                    : static_cast<void*>(static_cast<T*>(a.y) + sb * O),
          a.act, a.out_f32, H, O, os, ys,
          reinterpret_cast<float*>(base + L.t + L.inv.fbytes), c0 * P, npts,
          S);
      continue;
    }
    // With the ends, each block's own channels. Bypass: each thread takes
    // kPts points so every wb[o, h] it loads feeds kPts FMAs; x is read
    // once per (h, point), coalesced. With the lift it was added into ys
    // above.
    const T* xb = a.x + static_cast<size_t>(b) * H * S + c0 * P;
    const int nbyp = kBypass && !lifted ? H : 0;
    for (int p0 = tid; p0 < npts; p0 += kThreads * kPts) {
      int pt[kPts];
      float bx[kPts][kMaxOut];
#pragma unroll
      for (int u = 0; u < kPts; ++u) {
        pt[u] = min(p0 + u * kThreads, npts - 1);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) bx[u][o] = 0.f;
      }
      for (int h = 0; h < PHASE_BOUND(7, nbyp); ++h) {
        float xv[kPts];
#pragma unroll
        for (int u = 0; u < kPts; ++u)
          xv[u] = ld(xb + static_cast<size_t>(h) * S + pt[u]);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < no) {
            const float w = Wb[o * H + h];
#pragma unroll
            for (int u = 0; u < kPts; ++u) bx[u][o] = fmaf(w, xv[u], bx[u][o]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPts; ++u) {
        if (p0 + u * kThreads >= npts) break;
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < no) {
            // The output and gy share one (b, o, point) index.
            const size_t at = (static_cast<size_t>(b) * O + o0 + o) * S +
                              c0 * P + pt[u];
            const float z = (ys[o * npts + pt[u]] + bx[u][o]) + Bs[o];
            float v = z;
            if (a.act == kGelu) {
              v = fno::gelu_tanh(z);
            } else if (a.act == kGeluVjp) {
              v = ld(a.gy + at) * fno::dgelu_tanh(z);
            }
            if (projected) {  // the projection reads it from ys
              ys[o * npts + pt[u]] = v;
            } else if (a.out_f32) {
              static_cast<float*>(a.y)[at] = v;
            } else {
              fno::st(static_cast<T*>(a.y) + at, v);
            }
          }
        }
      }
    }
    if (projected) {
      // Per piece, all O activated channels of my points in zs [O][ep],
      // the hidden units gelu(p1·z + b1) [Lp][ep], then p2·… + b2.
      cluster.sync();  // every block's activated channels are in its ys
      float* zs = scratch;
      float* hid = zs + O * ep;
      float* yo = hid + a.Lp * ep;  // [cout][ep]
      for (int p0 = 0; p0 < PHASE_BOUND(5, npts); p0 += cl * ep) {
        const int np = min(cl * ep, npts - p0);
        const int mine = max(0, min(ep, np - rank * ep));
        const int pm = p0 + rank * ep;  // my first point of the piece
        for (int i0 = tid; i0 < O * mine; i0 += kThreads * kGU) {
          float v[kGU];
#pragma unroll
          for (int u = 0; u < kGU; ++u) {
            const int i = min(i0 + u * kThreads, O * mine - 1);
            const int o = i / mine;
            v[u] = cluster.map_shared_rank(ys, o / os)[(o % os) * npts + pm +
                                                        i % mine];
          }
#pragma unroll
          for (int u = 0; u < kGU; ++u) {
            const int i = i0 + u * kThreads;
            if (i < O * mine) zs[i / mine * ep + i % mine] = v[u];
          }
        }
        __syncthreads();
        tile_gemm<T, kBiasGelu>(a.p1w, O, zs, ep, a.Lp, mine, O, a.p1b, hid,
                                ep);
        tile_gemm<T, kBias>(a.p2w, a.Lp, hid, ep, a.cout, mine, a.Lp, a.p2b,
                            yo, ep);
        for (int i = tid; i < a.cout * mine; i += kThreads) {
          const int c = i / mine, q = i % mine;
          const size_t at = (static_cast<size_t>(b) * a.cout + c) * S +
                            c0 * P + pm + q;
          if (a.out_f32) {
            static_cast<float*>(a.y)[at] = yo[c * ep + q];
          } else {
            fno::st(static_cast<T*>(a.y) + at, yo[c * ep + q]);
          }
        }
        __syncthreads();
      }
      cluster.sync();  // no block overwrites ys while another reads it
    }
    __syncthreads();
  }
}

// One cluster of cl blocks per (sample, out tile): grid (cl, batch, ot).
template <int R, typename T, bool kBypass, bool kPerMode, bool kEnds,
          bool kTiled>
cudaError_t launch_kernel(const Args<T>& a, int batch, int ot, int cl,
                          int smem_bytes, cudaStream_t stream) {
  auto* kernel = fused_block_kernel<R, T, kBypass, kPerMode, kEnds, kTiled>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fno::configure(kernel, dim3(cl, batch, ot), kThreads, cl,
                                   smem_bytes, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, typename T, bool kPerMode, bool kTiled>
cudaError_t launch_mode(const Args<T>& a, int batch, int ot, int cl,
                        int smem_bytes, cudaStream_t stream) {
  if (!a.wb) {
    return launch_kernel<R, T, false, kPerMode, false, kTiled>(
        a, batch, ot, cl, smem_bytes, stream);
  }
  if constexpr (!kTiled) {
    if (a.l1w || a.p1w) {
      return launch_kernel<R, T, true, kPerMode, true, false>(
          a, batch, ot, cl, smem_bytes, stream);
    }
  }
  return launch_kernel<R, T, true, kPerMode, false, kTiled>(
      a, batch, ot, cl, smem_bytes, stream);
}

template <int R, typename T>
cudaError_t launch(const Args<T>& a, int per_mode, int tiled, int batch,
                   int ot, int cl, int smem_bytes, cudaStream_t stream) {
  if (tiled) {
    return per_mode ? launch_mode<R, T, true, true>(a, batch, ot, cl,
                                                    smem_bytes, stream)
                    : launch_mode<R, T, false, true>(a, batch, ot, cl,
                                                     smem_bytes, stream);
  }
  return per_mode ? launch_mode<R, T, true, false>(a, batch, ot, cl,
                                                   smem_bytes, stream)
                  : launch_mode<R, T, false, false>(a, batch, ot, cl,
                                                    smem_bytes, stream);
}

template <typename T>
int max_clusters_for(int rank, int cl, int smem_bytes, int* n) {
  switch (rank) {
    case 1: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<1, T, true, false, false, false>, cl,
        smem_bytes,
        n));
    case 2: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<2, T, true, false, false, false>, cl,
        smem_bytes,
        n));
    case 3: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<3, T, true, false, false, false>, cl,
        smem_bytes,
        n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout of a launch from its C arguments (dims, plan, wl as the entry
// below takes them) and the ends' widths (0 where an end is absent).
BLayout layout_of(int rank, int esize, const int* dims, const int* plan,
                  const int* wl, int lift, int lp, int cout) {
  int n[3], k[3];
  for (int i = 0; i < 3; ++i) {
    n[i] = i < rank ? dims[3 + i] : 1;
    k[i] = i < rank ? dims[6 + i] : 1;
  }
  return block_layout(rank, esize, dims[1], dims[2], n, k, plan[10], plan[2],
                      plan[3], plan[4], plan[8], plan[9],
                      plan[7] != 0 || lift > 0,
                      wl[0] != 0, lift, lp, cout, plan[6],
                      plan[10] < plan[1]);
}

template <typename T>
int dispatch(int rank, int act, int out_f32, const void* x, const void* wr,
             const void* wi, const void* wb, const void* bias, const void* gy,
             const void* const* mats, void* y, const int* dims,
             const int* plan, const int* wl, const void* const* ends,
             const int* edims, void* stream) {
  Args<T> a = {};
  a.x = static_cast<const T*>(x);
  a.wr = static_cast<const T*>(wr);
  a.wi = static_cast<const T*>(wi);
  a.wb = static_cast<const T*>(wb);
  a.bias = static_cast<const T*>(bias);
  a.gy = static_cast<const T*>(gy);
  for (int i = 0; i < rank; ++i) {
    a.f.r[i] = static_cast<const T*>(mats[2 * i]);
    a.f.i[i] = static_cast<const T*>(mats[2 * i + 1]);
    a.e.r[i] = static_cast<const T*>(mats[2 * rank + 2 * i]);
    a.e.i[i] = static_cast<const T*>(mats[2 * rank + 2 * i + 1]);
  }
  a.y = y;
  a.act = act;
  a.out_f32 = out_f32;
  const int batch = dims[0];
  a.H = dims[1];
  a.O = dims[2];
  for (int i = 0; i < 3; ++i) {
    a.n[i] = i < rank ? dims[3 + i] : 1;
    a.k[i] = i < rank ? dims[6 + i] : 1;
  }
  const int cl = plan[0];
  a.hs = plan[1];
  a.os = plan[2];
  a.rows_f = plan[3];
  a.rows_i = plan[4];
  const int smem_bytes = plan[5];
  a.ep = plan[6];
  a.fma = plan[7];
  a.hc = plan[10];
  const int ot = plan[11];
  // Tiled: a hidden k-loop (hc < hs) or out tiles (ot > 1), each tile
  // holding some out channels.
  const int tiled = a.hc < a.hs || ot > 1;
  const int per_mode = wl[0];
  a.w_so = wl[1];
  a.w_sh = wl[2];
  if (ends) {
    const T** e[8] = {&a.l1w, &a.l1b, &a.l2w, &a.l2b,
                      &a.p1w, &a.p1b, &a.p2w, &a.p2b};
    for (int i = 0; i < 8; ++i) *e[i] = static_cast<const T*>(ends[i]);
    a.cin = edims[0];
    a.L = edims[1];
    a.Lp = edims[2];
    a.cout = edims[3];
  }
  if (a.os > kMaxOut || act < kGelu || act > kLinear ||
      (act == kGeluVjp) != (gy != nullptr) || a.rows_f < 1 || a.rows_i < 1 ||
      (rank > 1 && (plan[8] < 8 || plan[8] % 8 != 0)) || plan[9] < 4 ||
      plan[9] % 4 != 0 || a.hc < 1 || a.hc > a.hs || ot < 1 ||
      1LL * ot * cl * a.os < a.O || 1LL * (ot - 1) * cl * a.os >= a.O) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.l1w || a.p1w) {  // the ends: a block forward, each end whole, and
                         // the projection contracts every out channel
    const bool lift_ok = !a.l1w || (a.l1b && a.l2w && a.l2b && a.cin > 0 &&
                                    a.L > 0);
    const bool proj_ok = !a.p1w || (a.p1b && a.p2w && a.p2b && a.Lp > 0 &&
                                    a.cout > 0);
    if (!wb || !bias || act != kGelu || !lift_ok || !proj_ok || a.ep < 1 ||
        tiled)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.lay = layout_of(rank, static_cast<int>(sizeof(T)), dims, plan, wl,
                  a.l1w ? a.L : 0, a.p1w ? a.Lp : 0, a.p1w ? a.cout : 0);
  if (a.lay.bytes > smem_bytes ||
      (!a.fma && !a.l1w &&
       chain::acc_tiles(rank, a.lay.chain) > chain::kWarps * chain::kMaxAcc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank) {
    case 1: return static_cast<int>(
        launch<1, T>(a, per_mode, tiled, batch, ot, cl, smem_bytes, s));
    case 2: return static_cast<int>(
        launch<2, T>(a, per_mode, tiled, batch, ot, cl, smem_bytes, s));
    case 3: return static_cast<int>(
        launch<3, T>(a, per_mode, tiled, batch, ot, cl, smem_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (x, gy,
// weights, operands). act: 0 gelu, 1 gelu_vjp (gy required), 2 linear.
// out_f32: write y in float32 whatever dtype is. wb, bias and gy may be
// null (no wb: the bare spectral layer, no bypass).
// mats: 4·rank device pointers (forward re/im per stage, then inverse).
// dims: {B, H, O, n_1, n_2, n_3, k_1, k_2, k_3}.
// plan: {cluster, hidden/block, out/block, rows_f, rows_i, smem bytes,
// points a block takes of a piece (the ends only), phase 1's chain (0 the
// tensor cores, 1 the CUDA cores; a launch with the lift takes 1), columns
// of the last inverse factor held at once (rank ≥ 2; n_R padded to 8: all
// of it, resident), rows of the first at once (k_1 padded to 4: all),
// hidden channels a block's chunk (hidden/block: no k-loop), out tiles
// (clusters a sample, each out/block · cluster channels; 1: untiled)}; a
// tiled plan (a k-loop or out tiles) takes no ends.
// wl: {per_mode, stride of o, stride of h}: wr, wi are [O, H] (per_mode =
// 0) or [O, H, K] with the modes contiguous, at these element strides.
// ends: null, or the model ends' 8 device pointers {l1w [L,cin], l1b [L],
// l2w [H,L], l2b [H], p1w [Lp,O], p1b [Lp], p2w [cout,Lp], p2b [cout]},
// each end's four null where that end is absent (act gelu, wb and bias
// required); with the lift x is [B, cin, n…], with the projection y is
// [B, cout, n…]. edims: {cin, L, Lp, cout}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_block_forward(int dtype, int rank, int act, int out_f32,
                                   const void* x, const void* wr,
                                   const void* wi, const void* wb,
                                   const void* bias, const void* gy,
                                   const void* const* mats, void* y,
                                   const int* dims, const int* plan,
                                   const int* wl, const void* const* ends,
                                   const int* edims, void* stream) {
  if (dtype == 0) {
    return dispatch<float>(rank, act, out_f32, x, wr, wi, wb, bias, gy, mats,
                           y, dims, plan, wl, ends, edims, stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(rank, act, out_f32, x, wr, wi, wb, bias,
                                   gy, mats, y, dims, plan, wl, ends, edims,
                                   stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a launch with these dims, plan and wl (as
// above) and edims ({cin, L, Lp, cout}, or null without the ends) needs:
// the wrapper's plan (kernels/engine.py _block_layout) mirrors it.
extern "C" long long fused_block_smem(int dtype, int rank, const int* dims,
                                      const int* plan, const int* wl,
                                      const int* edims) {
  const int lift = edims ? edims[1] : 0;
  const int lp = edims ? edims[2] : 0;
  return layout_of(rank, dtype == 1 ? 2 : 4, dims, plan, wl, lift, lp,
                   lp > 0 ? edims[3] : 0)
      .bytes;
}

// Writes to *n how many clusters of `cl` blocks (with `smem_bytes` of shared
// memory each) the card can run at once; returns the cudaError_t.
extern "C" int fused_block_max_clusters(int dtype, int rank, int cl,
                                        int smem_bytes, int* n) {
  if (dtype == 0) return max_clusters_for<float>(rank, cl, smem_bytes, n);
  if (dtype == 1) {
    return max_clusters_for<__nv_bfloat16>(rank, cl, smem_bytes, n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* fused_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
