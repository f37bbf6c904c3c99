// Fused weight gradient of the FNO block for NVIDIA Hopper (sm_90a): from
// the block input x [B,H,s…] and the pre-activation cotangent gz [B,O,s…],
// one launch emits
//
//   dW  [O,H] = conj( Σ_{b,k} Ĝ[b,o,k]·A[b,h,k] )  (dwr, dwi: real part as
//               is, imaginary part negated) for shared weights, or
//   dW  [O,H,K] = conj( Σ_b Ĝ[b,o,k]·A[b,h,k] )  for per-mode weights (the
//               parameter layout [O,H,k_1..k_R]),
//   dW_b[O,H] = Σ_{b,s} gz[b,o,s]·x[b,h,s],
//   dbias[O]  = Σ_{b,s} gz[b,o,s],
//
// where A = the truncated forward DFT chain of x and Ĝ = the adjoint-forward
// chain of gz (the transposed inverse transforms), both formed here and
// never written to device memory. Without the bypass (kBypass=false, the
// bare spectral layer's backward) only dW is formed: phase 3 below, its
// partials and its outputs are compiled away. Replaces the TPU kernel
// repro/kernels/engine.py::fused_fnond_wgrad_call (_make_wgrad_kernel,
// engine.py:561-699) with shared or per-mode weights, with_bypass True or
// False. Element type float or __nv_bfloat16 for x, gz and the operands;
// every sum accumulates in f32 and the outputs are f32 (the reference emits
// them at the param dtype, f32 under both precision presets).
//
// What bounds it on an H100. At fno3d (B=8, H=O=32, 64³, 16³ modes) the
// launch reads x and gz once, 537 MB in f32 (0.16 ms at 3.35 TB/s), against
// a real FFT of every channel, the spectral reduction and the dW_b product
// (4.3 GFLOP): the bytes bound it. The chains as dense DFT stages do 14
// GFLOP, which three TF32 passes on the tensor cores hide under the bytes.
//
// Design. A thread-block CLUSTER of CL blocks per sample b, block r holding
// hidden slice r and out slice r of the spectra in shared memory (rows
// padded to K+1 floats), then:
//   * phase 1 — block r runs the forward chain of its x channels into A and
//     the adjoint-forward chain of its gz channels into Ĝ (chain_tc.cuh: the
//     DFT stages as products on the tensor cores, the factors resident, the
//     chunks of s_1 rows double-buffered by cp.async). Where the resident
//     factors or the accumulator tiles do not fit, the plan's "chain" is the
//     CUDA cores' (fno::forward_chain: chunks of s_1 rows, the factors read
//     through L1), a template parameter, so the tensor cores' instances hold
//     none of its code;
//   * phase 2 — after a cluster barrier, block r forms the per-sample dW of
//     its out slice against EVERY hidden channel on the CUDA cores, reading
//     the other blocks' A through distributed shared memory (per-mode W: it
//     writes the sample's spectra to the workspace instead);
//   * phase 3 — block r takes 1/CL of the sample's points and forms the
//     partial [O × (H+1)] product gz·[x | 1]ᵀ of every channel pair on the
//     tensor cores (A = gz, B = xᵀ, depth the points; a row of ones beside
//     x makes its last column dbias), the tiles of gz and x streamed through
//     a cp.async double buffer, so each sample's x and gz are read once
//     here; the CL partials are then summed in rank order through
//     distributed shared memory, block r for its out slice;
//   * phase 4 — the batch reduction runs in the same launch and is
//     deterministic: each block writes its per-sample partials to a
//     workspace, fences, and takes a ticket on its rank's counter; the last
//     of the B blocks of rank r to arrive sums the B partials of out slice
//     r in sample order and writes the outputs. The wrapper zeroes the
//     counters for each launch.
//   * per-mode weights: per-sample dW partials would take B·2·O·H·K floats
//     (1.07 GB at fno2d-large B=8), so the last block of rank r forms
//     dW[o,h,k] of out slice r from the workspace's spectra, summing the
//     samples in order (it reads every rank's A, so each cluster syncs after
//     writing). It stages Ĝ of the whole batch over a chunk of modes in
//     shared memory; each thread takes kHP hidden channels of one mode, so
//     every staged Ĝ value feeds kHP complex multiply-adds.
//   * tiles (kTiled), for shapes whose spectra or dW_b product do not fit a
//     cluster: the reference's grid (o/bo, h/bh, b/bb). A launch runs a
//     cluster per (sample, out tile, hidden tile) (grid z: out tile ·
//     hidden tiles + hidden tile); the cluster of out tile t and hidden
//     tile u holds Ĝ of out channels t·cl·os.. and A of hidden channels
//     u·cl·hc.., forms their dW and the [O_t × H_u] block of dW_b, and its
//     blocks take their own tickets (rank, t, u): every tile's batch
//     reduction writes a disjoint block of the outputs, dbias from hidden
//     tile 0 only. Ĝ is formed once per hidden tile and A once per out
//     tile, as the reference's grid forms them.
#include <cooperative_groups.h>

#include "chain_tc.cuh"

namespace cg = cooperative_groups;
using fno::kThreads;

namespace {

constexpr int kMaxOut = 8;  // out channels per block (registers)
constexpr int kHP = 2;      // hidden channels per thread, per-mode reduction
constexpr int kQ = 8;       // samples whose loads it issues together
constexpr int kMaxPT = 9;   // phase 3 tiles a warp holds in registers
constexpr int kFlag = 128;  // bytes before the spectra: the last-block flag
constexpr int kWarps = kThreads / 32;

// Loop bound of phase i (1..4) above. Built with -DFUSED_WGRAD_ELIDE=<mask>,
// the phases whose bit (1 << i) is set run no iteration: the output is then
// wrong and only the time counts (launch/block_phases.py).
#ifndef FUSED_WGRAD_ELIDE
#define FUSED_WGRAD_ELIDE 0
#endif
#define PHASE_BOUND(i, n) (((FUSED_WGRAD_ELIDE >> (i)) & 1) ? 0 : (n))

// Shared-memory layout (byte offsets, regions 128-B aligned): the flag,
// the spectra from kFlag, then phase 1's work area (the chains). Phase 3
// and the per-mode batch reduction reuse all of it from kFlag: gz and x
// buffers [om][ldp] and [hn][ldp] twice, then the partial [O][H+1] and,
// where warps split the depth, their tiles.
struct WLayout {
  long long work;      // the chain's work area
  int fma, rows;       // phase 1 on the CUDA cores; its s_1 rows a chunk
  chain::Layout chain;
  int om, hn, ldp;     // phase 3: gz rows (O padded to 16), x rows and the
                       // ones row (H + 1 padded to 8), leading dimension
  int tiles, splits;   // phase 3's 16 × 8 tiles and depth splits a tile
  long long g0, g1, x0, x1, part, spl, bytes;
};

// Mirrored by kernels/engine.py _wgrad_bytes. H, O: the hidden and out
// channels of a cluster's tile (untiled: all); hs, os: a block's.
__host__ __device__ inline WLayout wgrad_layout(int R, int esize, int H,
                                                int O, const int* n,
                                                const int* k, int hs, int os,
                                                int rows, int cols,
                                                bool bypass, bool fma) {
  using tc::align128;
  using tc::pad_to;
  WLayout W = {};
  int K = 1;
  for (int i = 0; i < R; ++i) K *= k[i];
  W.work = align128(kFlag + 4LL * 2 * (hs + os) * (K + 1));
  W.fma = fma;
  W.rows = rows;
  long long bytes = W.work;
  if (fma) {
    bytes += 4 * fno::chain_work(R, n, k, rows);
  } else {
    W.chain = chain::layout(R, esize, n, k, rows, hs > os ? hs : os);
    bytes += W.chain.bytes;
  }
  W.om = pad_to(O, 16);
  W.hn = pad_to(H + 1, 8);
  W.ldp = cols + (esize == 2 ? 8 : 4);
  W.tiles = (W.om / 16) * (W.hn / 8);
  W.splits = W.tiles >= kWarps ? 1 : kWarps / W.tiles;
  W.g0 = kFlag;
  W.g1 = align128(W.g0 + 1LL * W.om * W.ldp * esize);
  W.x0 = align128(W.g1 + 1LL * W.om * W.ldp * esize);
  W.x1 = align128(W.x0 + 1LL * W.hn * W.ldp * esize);
  W.part = kFlag;
  W.spl = align128(W.part + 4LL * O * (H + 1));
  if (bypass) {
    long long p3 = align128(W.x1 + 1LL * W.hn * W.ldp * esize);
    const long long p4 =
        W.spl + (W.splits > 1 ? 4LL * W.splits * W.tiles * 128 : 0);
    p3 = p3 > p4 ? p3 : p4;
    bytes = bytes > p3 ? bytes : p3;
  }
  W.bytes = bytes;
  return W;
}

template <typename T>
struct Args {
  const T* x;       // [B, H, n_1..n_R]
  const T* gz;      // [B, O, n_1..n_R]
  fno::Mats<T> fx;  // forward chain of x, stage i (axis R-i): [n, k]
  fno::Mats<T> fg;  // adjoint-forward chain of gz, stage i: [n, k]
  float* ws;        // per sample: the dW partials [2][O][H] (shared W), the
                    // dW_b and dbias partials [O][H], [O] (with the
                    // bypass), then the spectra A [2][H][K], Ĝ [2][O][K]
                    // (per-mode W)
  unsigned* tickets;  // [cluster], zero at launch
  float* dwr;       // [O, H], or [O, H, K] per-mode
  float* dwi;       // same
  float* dwb;       // [O, H], null without the bypass
  float* dbias;     // [O], null without the bypass
  int H, O;
  int n[3], k[3];   // extents and modes, axis order 1..R (unused = 1)
  int hs, os;       // hidden / out channels per block of the cluster
  int hc, ht;       // kTiled: hidden channels a block, hidden tiles
  int cols;         // points per chunk of phase 3
  int kc;           // per-mode: modes per chunk of the batch reduction
  WLayout L;
};

// Phase 3: the block's partial [O × (H+1)] = gz·[x | 1]ᵀ of one sample (x
// [H][S], gz [O][S]) over the block's share of the points into `part`
// (rows H+1 apart). Ends synchronised.
template <typename T>
__device__ void bypass_partial(const T* xsrc, const T* gsrc, int H, int O,
                               int S, int cp, const WLayout L, int rank,
                               int cl, char* base, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lg = (tid & 31) >> 2, lt = tid & 3;
  const int ldp = L.ldp;
  T* gb[2] = {reinterpret_cast<T*>(base + L.g0),
              reinterpret_cast<T*>(base + L.g1)};
  T* xb[2] = {reinterpret_cast<T*>(base + L.x0),
              reinterpret_cast<T*>(base + L.x1)};
  const int nq = (S + cp - 1) / cp;
  const int q0 = static_cast<int>(1LL * rank * nq / cl);
  const int q1 = q0 + PHASE_BOUND(
      3, static_cast<int>(1LL * (rank + 1) * nq / cl) - q0);
  __syncthreads();  // phases 1 and 2 are done with this shared memory
  chain::zero_words(base + L.g0, (L.x1 + 1LL * L.hn * ldp * sizeof(T) -
                                  L.g0) / 4);
  __syncthreads();
  const T one = tc::from_f32<T>(1.f), zero = tc::from_f32<T>(0.f);
  for (int j = tid; j < 2 * cp; j += kThreads) xb[j / cp][H * ldp + j % cp] = one;
  constexpr int kE = 16 / sizeof(T);
  const bool vec = S % kE == 0 && tc::aligned16(xsrc) &&
                   tc::aligned16(gsrc);
  // Chunk q's rows of gz, then of x, into buffer buf: 16-byte pieces, or
  // elements where the rows are not in whole pieces or the chunk is the
  // ragged last one (its points past S zero).
  const chain::Div pieces(cp / kE), points(cp);
  auto issue = [&](int q, int buf) {
    const int p0 = q * cp, nv = min(cp, S - p0);
    auto row = [&](int r, const T*& from) {
      from = (r < O ? gsrc + static_cast<size_t>(r) * S
                    : xsrc + static_cast<size_t>(r - O) * S) + p0;
      return r < O ? gb[buf] + r * ldp : xb[buf] + (r - O) * ldp;
    };
    if (vec && nv == cp) {
      for (int i = tid; i < (O + H) * pieces.d; i += kThreads) {
        const int r = pieces.div(i), j = (i - r * pieces.d) * kE;
        const T* from;
        T* to = row(r, from);
        tc::copy_async(to + j, from + j);
      }
    } else {
      for (int i = tid; i < (O + H) * cp; i += kThreads) {
        const int r = points.div(i), j = i - r * cp;
        const T* from;
        T* to = row(r, from);
        to[j] = j < nv ? from[j] : zero;
      }
    }
  };
  const chain::Div nt(L.hn / 8);
  const int tiles = L.tiles, splits = L.splits;
  const int per = splits > 1 ? 1 : (tiles + kWarps - 1) / kWarps;
  const int split = splits > 1 ? warp / tiles : 0;
  const bool active = split < splits;
  constexpr int kDepth = tc::depth<T>();
  float acc[kMaxPT][4] = {};
  if (q0 < q1) issue(q0, 0);
  tc::async_commit();
  for (int q = q0; q < q1; ++q) {
    tc::async_wait_all();
    __syncthreads();
    if (q + 1 < q1) issue(q + 1, (q + 1 - q0) & 1);
    tc::async_commit();
    const T* gq = gb[(q - q0) & 1];
    const T* xq = xb[(q - q0) & 1];
#pragma unroll
    for (int u = 0; u < kMaxPT; ++u) {
      const int tl = splits > 1 ? warp % tiles : warp + kWarps * u;
      if (!active || u >= per || tl >= tiles) continue;
      const int i = nt.div(tl);
      chain::tile_product<T, true>(acc[u], gq + 16 * i * ldp, ldp,
                                   xq + 8 * (tl - i * nt.d) * ldp, ldp, cp,
                                   split * kDepth, splits * kDepth);
    }
  }
  __syncthreads();  // the buffers are free for the partial
  const int ldq = H + 1;
  float* spl = reinterpret_cast<float*>(base + L.spl);
  auto put = [&](int tl, int e, float v) {
    const int row = 16 * nt.div(tl) + lg + 8 * (e >> 1);
    const int col = 8 * nt.mod(tl) + 2 * lt + (e & 1);
    if (row < O && col < ldq) part[row * ldq + col] = v;
  };
  if (splits == 1) {
#pragma unroll
    for (int u = 0; u < kMaxPT; ++u) {
      const int tl = warp + kWarps * u;
      if (u >= per || tl >= tiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) put(tl, e, acc[u][e]);
    }
  } else {
    if (active) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        spl[((split * tiles + warp % tiles) * 32 + (tid & 31)) * 4 + e] =
            acc[0][e];
    }
    __syncthreads();
    for (int i = tid; i < tiles * 128; i += kThreads) {
      float s = 0.f;
      for (int q = 0; q < splits; ++q) s += spl[q * tiles * 128 + i];
      const int tl = i / 128, lane = (i / 4) % 32, e = i % 4;
      const int row = 16 * nt.div(tl) + lane / 4 + 8 * (e >> 1);
      const int col = 8 * nt.mod(tl) + 2 * (lane % 4) + (e & 1);
      if (row < O && col < ldq) part[row * ldq + col] = s;
    }
  }
  __syncthreads();
}

// kBypass=false compiles phase 3 (dW_b, dbias) away: the bare spectral
// layer's backward. kPerMode=true forms dW per mode in the batch
// reduction; kPerMode=false sums the modes in phase 2. kFma=true runs
// phase 1 on the CUDA cores' chain, kFma=false on the tensor cores'.
// kTiled=true runs a cluster per (sample, out tile, hidden tile).
template <int R, typename T, bool kBypass, bool kPerMode, bool kFma,
          bool kTiled>
__global__ void __launch_bounds__(kThreads)
fused_wgrad_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  char* base = reinterpret_cast<char*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = static_cast<int>(gridDim.x);
  const int b = blockIdx.y;
  const int nb = static_cast<int>(gridDim.y);
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, os = a.os;
  const WLayout L = a.L;
  const fno::Geom g = fno::make_geom<R>(a.n, a.k);
  const int K = g.K, S = g.S, ldk = K + 1;
  // The cluster's tile (untiled: every channel): z, its out and hidden
  // tiles, their first channels and channels; a block's hidden channels.
  const int hs = kTiled ? a.hc : a.hs;
  const int z = kTiled ? static_cast<int>(blockIdx.z) : 0;
  const int th = kTiled ? z % a.ht : 0;
  const int ob = kTiled ? z / a.ht * cl * os : 0;
  const int hb = kTiled ? th * cl * hs : 0;
  const int Ot = kTiled ? min(cl * os, O - ob) : O;
  const int Ht = kTiled ? min(cl * hs, H - hb) : H;
  const int h0 = hb + rank * hs, nh = max(0, min(hs, H - h0));
  const int o0 = ob + rank * os, no = max(0, min(os, O - o0));
  // Floats of one sample's workspace: the dW partials, the dW_b and dbias
  // partials (at nd), then the per-mode spectra (at np_), a slot of SH
  // hidden and SO out channels' spectra a tile.
  const int SH = kTiled ? cl * hs : H, SO = kTiled ? cl * os : O;
  const int nd = kPerMode ? 0 : 2 * O * H;
  const int np_ = nd + (kBypass ? O * H + O : 0);
  const int slot = 2 * (SH + SO) * K;
  const int wsn =
      np_ + (kPerMode ? (kTiled ? static_cast<int>(gridDim.z) : 1) * slot
                      : 0);
  float* wsb = a.ws + static_cast<size_t>(b) * wsn;
  float* wsp = wsb + np_ + static_cast<size_t>(z) * slot;  // my tile's

  // Shared memory: the last-block flag; from kFlag the spectra A of my
  // hidden slice and Ĝ of my out slice; then the work area.
  int* last = reinterpret_cast<int*>(base);
  float* Ar = reinterpret_cast<float*>(base + kFlag);
  float* Ai = Ar + hs * ldk;
  float* Gr = Ai + hs * ldk;
  float* Gi = Gr + os * ldk;
  float* work = reinterpret_cast<float*>(base + L.work);

  // Phase 1: A of my hidden channels, Ĝ of my out channels.
  const T* xs = a.x + (static_cast<size_t>(b) * H + h0) * S;
  const T* gs = a.gz + (static_cast<size_t>(b) * O + o0) * S;
  if constexpr (kFma) {  // the CUDA cores' chain accumulates: zero them
    for (int i = tid; i < 2 * (hs + os) * ldk; i += kThreads) Ar[i] = 0.f;
    __syncthreads();
    fno::forward_chain<R, T>(xs, PHASE_BOUND(1, nh), g, L.rows, a.fx, Ar, Ai,
                             ldk, work);
    fno::forward_chain<R, T>(gs, PHASE_BOUND(1, no), g, L.rows, a.fg, Gr, Gi,
                             ldk, work);
  } else {
    chain::forward_chain<R, T>(xs, PHASE_BOUND(1, nh), g, L.chain, a.fx, Ar,
                               Ai, ldk, base + L.work);
    chain::forward_chain<R, T>(gs, PHASE_BOUND(1, no), g, L.chain, a.fg, Gr,
                               Gi, ldk, base + L.work);
  }
  cluster.sync();

  if constexpr (kPerMode) {
    // Phase 2, per-mode: this sample's spectra of my channels to the
    // workspace, for the batch reduction.
    for (int i = tid; i < PHASE_BOUND(2, nh * K); i += kThreads) {
      const int c = i / K, kk = i % K;
      const size_t at = static_cast<size_t>(h0 - hb + c) * K + kk;
      wsp[at] = Ar[c * ldk + kk];
      wsp[static_cast<size_t>(SH) * K + at] = Ai[c * ldk + kk];
    }
    for (int i = tid; i < PHASE_BOUND(2, no * K); i += kThreads) {
      const int c = i / K, kk = i % K;
      const size_t at = static_cast<size_t>(2 * SH + o0 - ob + c) * K + kk;
      wsp[at] = Gr[c * ldk + kk];
      wsp[static_cast<size_t>(SO) * K + at] = Gi[c * ldk + kk];
    }
    // The batch reduction of rank r reads every rank's A: each sample's
    // blocks have all written theirs before any of them takes a ticket.
    __threadfence();
    cluster.sync();
  } else {
    // Phase 2: dW[o,h] of this sample for my out slice and every h of the
    // tile (h: its index there). Warp w takes the hidden channels h ≡ w
    // (mod kWarps), its lanes the modes k ≡ lane (mod 32) of that row of A
    // (read from its block through distributed shared memory, 128 bytes a
    // load) for all my o; the lanes' sums meet by shuffles in a fixed order.
    const int lane = tid & 31;
    for (int h = tid >> 5; h < Ht; h += kWarps) {
      const float* rAr = cluster.map_shared_rank(Ar, h / hs) + h % hs * ldk;
      const float* rAi = cluster.map_shared_rank(Ai, h / hs) + h % hs * ldk;
      float accr[kMaxOut], acci[kMaxOut];
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) accr[o] = acci[o] = 0.f;
#pragma unroll 4
      for (int kk = lane; kk < PHASE_BOUND(2, K); kk += 32) {
        const float ar = rAr[kk], ai = rAi[kk];
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < no) {
            const float gr = Gr[o * ldk + kk], gi = Gi[o * ldk + kk];
            accr[o] = fmaf(gr, ar, fmaf(-gi, ai, accr[o]));
            acci[o] = fmaf(gr, ai, fmaf(gi, ar, acci[o]));
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
#pragma unroll
        for (int m = 16; m >= 1; m /= 2) {
          accr[o] += __shfl_xor_sync(0xffffffffu, accr[o], m);
          acci[o] += __shfl_xor_sync(0xffffffffu, acci[o], m);
        }
        if (lane == 0 && o < no) {
          wsb[(o0 + o) * H + hb + h] = accr[o];
          wsb[O * H + (o0 + o) * H + hb + h] = -acci[o];  // conj
        }
      }
    }
    // Every block has read what it needs of the others' A: none may leave,
    // or reuse its spectra, before this barrier.
    cluster.sync();
  }

  // Phase 3: dW_b[o,h] and dbias[o] of this sample: each block's partial
  // over its points, then my out slice summed over the ranks in order.
  if constexpr (kBypass) {
    float* part = reinterpret_cast<float*>(base + L.part);
    bypass_partial<T>(a.x + (static_cast<size_t>(b) * H + hb) * S,
                      a.gz + (static_cast<size_t>(b) * O + ob) * S, Ht, Ot,
                      S, a.cols, L, rank, cl, base, part);
    cluster.sync();  // every rank's partial is in place
    const int ldq = Ht + 1;
    for (int i = tid; i < no * ldq; i += kThreads) {
      const int o = o0 + i / ldq, hc = i % ldq, at = (o - ob) * ldq + hc;
      float s = 0.f;
      for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(part, q)[at];
      if (hc < Ht) {
        wsb[nd + o * H + hb + hc] = s;
      } else {
        wsb[nd + O * H + o] = s;
      }
    }
    cluster.sync();  // no block reuses its partial while others read it
  }

  // Phase 4, the batch reduction: the last of the B blocks of my rank (and
  // tile) sums the partials of out slice `rank` in sample order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *last = atomicAdd(a.tickets + (kTiled ? z * cl + rank : rank), 1u) ==
            nb - 1u;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if constexpr (!kPerMode || kBypass) {  // the [O,H] sums
    for (int i = tid; i < PHASE_BOUND(4, no * Ht); i += kThreads) {
      const int at = (o0 + i / Ht) * H + hb + i % Ht;
      float sr = 0.f, si = 0.f, sb = 0.f;
      for (int q = 0; q < nb; ++q) {
        const float* p = a.ws + static_cast<size_t>(q) * wsn;
        if (!kPerMode) {
          sr += __ldcg(p + at);
          si += __ldcg(p + O * H + at);
        }
        if (kBypass) sb += __ldcg(p + nd + at);
      }
      if (!kPerMode) {
        a.dwr[at] = sr;
        a.dwi[at] = si;
      }
      if (kBypass) a.dwb[at] = sb;
    }
  }
  if constexpr (kBypass) {
    for (int o = tid; o < PHASE_BOUND(4, th == 0 ? no : 0); o += kThreads) {
      float s = 0.f;
      for (int q = 0; q < nb; ++q)
        s += __ldcg(a.ws + static_cast<size_t>(q) * wsn + nd + O * H + o0 +
                    o);
      a.dbias[o0 + o] = s;
    }
  }
  if constexpr (kPerMode) {
    // dW[o,h,k] = conj(Σ_b Ĝ[b,o,k]·A[b,h,k]) for my out slice, over chunks
    // of kc modes: Ĝ of the whole batch staged as gs[b][2][os][kc], A read
    // from the workspace (coalesced over k), samples summed in order.
    const int kc = a.kc;
    // The offset of my tile's spectra in a sample.
    const size_t spo = np_ + static_cast<size_t>(z) * slot;
    float* gs = reinterpret_cast<float*>(base + kFlag);
    const int hg = (Ht + kHP - 1) / kHP;
    for (int k0 = 0; k0 < PHASE_BOUND(4, K); k0 += kc) {
      const int nk = min(kc, K - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < nb * 2 * no * nk; i += kThreads) {
        const int kk = i % nk, o = i / nk % no, c = i / nk / no % 2;
        const int q = i / nk / no / 2;
        const float* gp =
            a.ws + static_cast<size_t>(q) * wsn + spo +
            static_cast<size_t>(2 * SH + c * SO + o0 - ob + o) * K;
        gs[((q * 2 + c) * os + o) * kc + kk] = __ldcg(gp + k0 + kk);
      }
      __syncthreads();
      for (int idx = tid; idx < hg * nk; idx += kThreads) {
        const int kk = idx % nk, hq = idx / nk * kHP;
        float accr[kHP][kMaxOut], acci[kHP][kMaxOut];
#pragma unroll
        for (int u = 0; u < kHP; ++u) {
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) accr[u][o] = acci[u][o] = 0.f;
        }
        // kQ samples at a time: their A loads are all issued before the
        // multiply-adds, so the L2 latency is paid once per kQ samples.
        for (int q0 = 0; q0 < nb; q0 += kQ) {
          float ar[kQ][kHP], ai[kQ][kHP];
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const int q = min(q0 + j, nb - 1);
            const float* sp = a.ws + static_cast<size_t>(q) * wsn + spo +
                              k0 + kk;
#pragma unroll
            for (int u = 0; u < kHP; ++u) {
              const size_t h = min(hq + u, Ht - 1);
              ar[j][u] = __ldcg(sp + h * K);
              ai[j][u] = __ldcg(sp + (SH + h) * K);
            }
          }
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            if (q0 + j >= nb) break;
            const float* gq = gs + ((q0 + j) * 2 * os) * kc + kk;
#pragma unroll
            for (int o = 0; o < kMaxOut; ++o) {
              if (o < no) {
                const float gr = gq[o * kc], gi = gq[(os + o) * kc];
#pragma unroll
                for (int u = 0; u < kHP; ++u) {
                  accr[u][o] =
                      fmaf(gr, ar[j][u], fmaf(-gi, ai[j][u], accr[u][o]));
                  acci[u][o] =
                      fmaf(gr, ai[j][u], fmaf(gi, ar[j][u], acci[u][o]));
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kHP; ++u) {
          if (hq + u >= Ht) break;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < no) {
              const size_t at =
                  (static_cast<size_t>(o0 + o) * H + hb + hq + u) * K + k0 +
                  kk;
              a.dwr[at] = accr[u][o];
              a.dwi[at] = -acci[u][o];  // conj
            }
          }
        }
      }
    }
  }
}

// One cluster of cl blocks per (sample, tile): grid (cl, batch, tiles).
template <int R, typename T, bool kBypass, bool kPerMode, bool kFma,
          bool kTiled>
cudaError_t launch_kernel(const Args<T>& a, int batch, int tiles, int cl,
                          int smem_bytes, cudaStream_t stream) {
  auto* kernel = fused_wgrad_kernel<R, T, kBypass, kPerMode, kFma, kTiled>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fno::configure(kernel, dim3(cl, batch, tiles), kThreads,
                                   cl, smem_bytes, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, typename T, bool kBypass, bool kPerMode, bool kTiled>
cudaError_t launch_chain(const Args<T>& a, int batch, int tiles, int cl,
                         int smem_bytes, cudaStream_t stream) {
  return a.L.fma ? launch_kernel<R, T, kBypass, kPerMode, true, kTiled>(
                       a, batch, tiles, cl, smem_bytes, stream)
                 : launch_kernel<R, T, kBypass, kPerMode, false, kTiled>(
                       a, batch, tiles, cl, smem_bytes, stream);
}

template <int R, typename T, bool kBypass, bool kTiled>
cudaError_t launch_modes(const Args<T>& a, int per_mode, int batch,
                         int tiles, int cl, int smem_bytes,
                         cudaStream_t stream) {
  return per_mode ? launch_chain<R, T, kBypass, true, kTiled>(
                        a, batch, tiles, cl, smem_bytes, stream)
                  : launch_chain<R, T, kBypass, false, kTiled>(
                        a, batch, tiles, cl, smem_bytes, stream);
}

template <int R, typename T, bool kTiled>
cudaError_t launch_tiles(const Args<T>& a, int per_mode, int bypass,
                         int batch, int tiles, int cl, int smem_bytes,
                         cudaStream_t stream) {
  return bypass ? launch_modes<R, T, true, kTiled>(a, per_mode, batch, tiles,
                                                   cl, smem_bytes, stream)
                : launch_modes<R, T, false, kTiled>(a, per_mode, batch,
                                                    tiles, cl, smem_bytes,
                                                    stream);
}

template <int R, typename T>
cudaError_t launch(const Args<T>& a, int per_mode, int bypass, int tiled,
                   int batch, int tiles, int cl, int smem_bytes,
                   cudaStream_t stream) {
  return tiled ? launch_tiles<R, T, true>(a, per_mode, bypass, batch, tiles,
                                          cl, smem_bytes, stream)
               : launch_tiles<R, T, false>(a, per_mode, bypass, batch, tiles,
                                           cl, smem_bytes, stream);
}

template <typename T>
int max_clusters_for(int rank, int cl, int smem_bytes, int* n) {
  switch (rank) {
    case 1: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<1, T, true, false, false, false>, cl,
        smem_bytes, n));
    case 2: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<2, T, true, false, false, false>, cl,
        smem_bytes, n));
    case 3: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<3, T, true, false, false, false>, cl,
        smem_bytes, n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout of a launch from its C arguments (dims, plan as the entry
// below takes them): a cluster's tile of cl·hc hidden and cl·os out
// channels (untiled: hc = hs, every channel).
WLayout layout_of(int rank, int esize, const int* dims, const int* plan) {
  int n[3], k[3];
  for (int i = 0; i < 3; ++i) {
    n[i] = i < rank ? dims[3 + i] : 1;
    k[i] = i < rank ? dims[6 + i] : 1;
  }
  const int cl = plan[0], hc = plan[10], os = plan[2];
  const int ht = 1LL * cl * hc < dims[1] ? cl * hc : dims[1];
  const int ot = 1LL * cl * os < dims[2] ? cl * os : dims[2];
  return wgrad_layout(rank, esize, ht, ot, n, k, hc, os, plan[3], plan[4],
                      plan[8] != 0, plan[9] != 0);
}

template <typename T>
int dispatch(int rank, const void* x, const void* gz,
             const void* const* mats, void* ws, void* tickets,
             void* const* outs, const int* dims, const int* plan,
             void* stream) {
  if (rank < 1 || rank > 3) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a = {};
  a.x = static_cast<const T*>(x);
  a.gz = static_cast<const T*>(gz);
  for (int i = 0; i < rank; ++i) {
    a.fx.r[i] = static_cast<const T*>(mats[2 * i]);
    a.fx.i[i] = static_cast<const T*>(mats[2 * i + 1]);
    a.fg.r[i] = static_cast<const T*>(mats[2 * rank + 2 * i]);
    a.fg.i[i] = static_cast<const T*>(mats[2 * rank + 2 * i + 1]);
  }
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<unsigned*>(tickets);
  a.dwr = static_cast<float*>(outs[0]);
  a.dwi = static_cast<float*>(outs[1]);
  a.dwb = static_cast<float*>(outs[2]);
  a.dbias = static_cast<float*>(outs[3]);
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
  const int rows = plan[3];
  a.cols = plan[4];
  const int smem_bytes = plan[5];
  const int per_mode = plan[6];
  a.kc = plan[7];
  const int bypass = plan[8];
  a.hc = plan[10];
  const int ot = plan[11];
  if (a.hc < 1 || a.hc > a.hs || ot < 1 || 1LL * ot * cl * a.os < a.O ||
      1LL * (ot - 1) * cl * a.os >= a.O) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.ht = (a.H + cl * a.hc - 1) / (cl * a.hc);
  const int tiled = a.hc < a.hs || ot > 1;
  a.L = layout_of(rank, static_cast<int>(sizeof(T)), dims, plan);
  if (a.os > kMaxOut || a.H > kThreads || rows < 1 ||
      (rank == 1 && !a.L.fma && rows % 16 != 0) || a.cols < 16 ||
      a.cols % 16 != 0 ||
      (!a.L.fma &&
       chain::acc_tiles(rank, a.L.chain) > chain::kWarps * chain::kMaxAcc) ||
      (bypass && a.L.tiles > kWarps * kMaxPT) || a.L.bytes > smem_bytes ||
      (per_mode && a.kc < 1) || (bypass && !(a.dwb && a.dbias))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank) {
    case 1: return static_cast<int>(launch<1, T>(
        a, per_mode, bypass, tiled, batch, ot * a.ht, cl, smem_bytes, s));
    case 2: return static_cast<int>(launch<2, T>(
        a, per_mode, bypass, tiled, batch, ot * a.ht, cl, smem_bytes, s));
    default: return static_cast<int>(launch<3, T>(
        a, per_mode, bypass, tiled, batch, ot * a.ht, cl, smem_bytes, s));
  }
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (x, gz,
// operands). mats: 4·rank device pointers (the x chain's re/im per stage,
// then the gz chain's). ws: B·(2·O·H (shared W) + O·H + O (bypass) +
// 2·(H+O)·K (per-mode W; tiled: 2·cl·(hc+os)·K a tile)) floats of
// scratch; tickets: `cluster` (tiled: cluster · tiles) zeroed unsigned
// ints. outs: {dwr, dwi [O,H] (per-mode [O,H,K]), dwb [O,H],
// dbias [O]}, float32; dwb and dbias null without the bypass.
// dims: {B, H, O, n_1, n_2, n_3, k_1, k_2, k_3}.
// plan: {cluster, hidden/block, out/block, s_1 rows per chain chunk (rank
// 1, tensor cores: points, a multiple of 16), points per phase-3 chunk (a
// multiple of 16), smem bytes, per_mode, modes per chunk of the per-mode
// batch reduction, bypass, phase 1's chain (0 the tensor cores, 1 the CUDA
// cores), hidden channels a block (hidden/block: untiled; else hidden tiles
// of cluster · that many), out tiles (of cluster · out/block channels)};
// a launch runs out tiles · hidden tiles clusters a sample.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_wgrad(int dtype, int rank, const void* x, const void* gz,
                           const void* const* mats, void* ws, void* tickets,
                           void* const* outs, const int* dims,
                           const int* plan, void* stream) {
  if (dtype == 0) {
    return dispatch<float>(rank, x, gz, mats, ws, tickets, outs, dims, plan,
                           stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(rank, x, gz, mats, ws, tickets, outs, dims,
                                   plan, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a launch with these dims and plan (as above)
// needs: the wrapper's plan (kernels/engine.py _wgrad_bytes) mirrors it.
extern "C" long long fused_wgrad_smem(int dtype, int rank, const int* dims,
                                      const int* plan) {
  return layout_of(rank, dtype == 1 ? 2 : 4, dims, plan).bytes;
}

// Writes to *n how many clusters of `cl` blocks (with `smem_bytes` of shared
// memory each) the card can run at once, asked of one instance (shared
// weights, with the bypass, the tensor cores' chain) for all: they take the same shared memory;
// returns the cudaError_t.
extern "C" int fused_wgrad_max_clusters(int dtype, int rank, int cl,
                                        int smem_bytes, int* n) {
  if (dtype == 0) return max_clusters_for<float>(rank, cl, smem_bytes, n);
  if (dtype == 1) {
    return max_clusters_for<__nv_bfloat16>(rank, cl, smem_bytes, n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Human-readable name of a cudaError_t, for the Python wrapper's errors.
extern "C" const char* fused_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
