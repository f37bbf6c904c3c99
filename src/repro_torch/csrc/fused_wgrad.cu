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
// False. Element type
// float or __nv_bfloat16 for x, gz and the operands; every sum accumulates
// in f32 and the outputs are f32 (the reference emits them at the param
// dtype, f32 under both precision presets).
//
// What bounds it on an H100. At fno2d (B=8, H=O=64, 128×128, 32×32 modes)
// the least work is a real FFT of every x and gz channel, the spectral
// reduction (8 FLOP per complex multiply-add) and the dW_b reduction
// (2·O·H·S per sample): ~1.9 GFLOP, so the f32 CUDA-core rate bounds it
// (~29 µs); in bf16 the bytes of x and gz. This kernel computes the
// transforms as dense DFT products on CUDA cores (as fused_block.cu does),
// so load issue and occupancy bound it in practice.
//
// Design. The TPU kernel walks a grid (out tile, hidden tile, batch) with
// the batch innermost, carrying the sums in VMEM across batch steps. Hopper
// blocks run in parallel, so:
//   * one thread-block CLUSTER of CL blocks per sample b, as in the forward
//     kernel; block r holds hidden slice r and out slice r;
//   * phase 1 — block r runs the forward chain of its x channels into A and
//     the adjoint-forward chain of its gz channels into Ĝ, both in its own
//     shared memory (rows padded to K+1 floats so that threads reading
//     consecutive channels hit distinct banks);
//   * phase 2 — after a cluster barrier, block r forms the per-sample dW of
//     its out slice against EVERY hidden channel, reading the other blocks'
//     A through distributed shared memory;
//   * phase 3 — block r forms the per-sample dW_b and dbias of its out slice
//     over s, staging chunks of x and gz through shared memory; dbias is
//     summed once per out channel;
//   * the batch reduction runs in the same launch and is deterministic:
//     each block writes its per-sample partials to a workspace, fences, and
//     takes a ticket on its rank's counter; the last of the B blocks of rank
//     r to arrive sums the B partials of out slice r in sample order and
//     writes the outputs. The wrapper zeroes the counters for each launch.
//   * per-mode weights: per-sample dW partials would take B·2·O·H·K floats
//     (1.07 GB at fno2d-large B=8), so phase 2 instead writes the sample's
//     spectra A and Ĝ of this block's channels to the workspace (2·(H+O)·K
//     floats per sample, 16.8 MB there) and the last block of rank r forms
//     dW[o,h,k] of out slice r from them, summing the samples in order
//     (it reads every rank's A, so each cluster syncs after writing). It
//     stages Ĝ of the whole batch over a chunk of modes in shared memory;
//     each thread takes kHP hidden channels of one mode, so every staged Ĝ
//     value feeds kHP complex multiply-adds. Only CL blocks do this
//     reduction (16 of 132 SMs at fno2d-large).
#include <cooperative_groups.h>

#include "fno_common.cuh"

namespace cg = cooperative_groups;
using fno::kThreads;
using fno::ld;

namespace {

constexpr int kMaxOut = 8;  // out channels per block (registers)
constexpr int kHP = 2;      // hidden channels per thread, per-mode reduction

// Loop bound of phase i (1..3) below. Built with -DFUSED_WGRAD_ELIDE=<mask>,
// the phases whose bit (1 << i) is set run no iteration: the output is then
// wrong and only the time counts (launch/block_phases.py).
#ifndef FUSED_WGRAD_ELIDE
#define FUSED_WGRAD_ELIDE 0
#endif
#define PHASE_BOUND(i, n) (((FUSED_WGRAD_ELIDE >> (i)) & 1) ? 0 : (n))

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
  int rows_f;       // s_1 rows per forward-chain chunk
  int cols;         // points per chunk of the dW_b reduction
  int kc;           // per-mode: modes per chunk of the batch reduction
};

// kBypass=false compiles phase 3 (dW_b, dbias) away: the bare spectral
// layer's backward. kPerMode=true forms dW per mode in the batch
// reduction; kPerMode=false sums the modes in phase 2.
template <int R, typename T, bool kBypass, bool kPerMode>
__global__ void __launch_bounds__(kThreads)
fused_wgrad_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int nb = static_cast<int>(gridDim.y);
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, hs = a.hs, os = a.os;
  const fno::Geom g = fno::make_geom<R>(a.n, a.k);
  const int K = g.K, S = g.S, ldk = K + 1;
  const int h0 = rank * hs, nh = max(0, min(hs, H - h0));
  const int o0 = rank * os, no = max(0, min(os, O - o0));
  // Floats of one sample's workspace: the dW partials, the dW_b and dbias
  // partials (at nd), then the per-mode spectra (at np_).
  const int nd = kPerMode ? 0 : 2 * O * H;
  const int np_ = nd + (kBypass ? O * H + O : 0);
  const int wsn = np_ + (kPerMode ? 2 * (H + O) * K : 0);
  float* wsb = a.ws + static_cast<size_t>(b) * wsn;
  float* wsp = wsb + np_;  // per-mode spectra of this sample

  // Shared memory: spectra A of my hidden slice and Ĝ of my out slice, the
  // last-block flag, then the work area of each phase.
  float* Ar = smem;
  float* Ai = Ar + hs * ldk;
  float* Gr = Ai + hs * ldk;
  float* Gi = Gr + os * ldk;
  int* last = reinterpret_cast<int*>(Gi + os * ldk);
  float* work = Gi + os * ldk + 4;

  for (int i = tid; i < hs * ldk; i += kThreads) Ar[i] = Ai[i] = 0.f;
  for (int i = tid; i < os * ldk; i += kThreads) Gr[i] = Gi[i] = 0.f;
  __syncthreads();

  // Phase 1: A of my hidden channels, Ĝ of my out channels.
  fno::forward_chain<R, T>(a.x + (static_cast<size_t>(b) * H + h0) * S,
                           PHASE_BOUND(1, nh), g, a.rows_f, a.fx, Ar, Ai, ldk,
                           work);
  fno::forward_chain<R, T>(a.gz + (static_cast<size_t>(b) * O + o0) * S,
                           PHASE_BOUND(1, no), g, a.rows_f, a.fg, Gr, Gi, ldk,
                           work);
  cluster.sync();

  if constexpr (kPerMode) {
    // Phase 2, per-mode: this sample's spectra of my channels to the
    // workspace, for the batch reduction.
    for (int i = tid; i < PHASE_BOUND(2, nh * K); i += kThreads) {
      const int c = i / K, kk = i % K;
      const size_t at = static_cast<size_t>(h0 + c) * K + kk;
      wsp[at] = Ar[c * ldk + kk];
      wsp[static_cast<size_t>(H) * K + at] = Ai[c * ldk + kk];
    }
    for (int i = tid; i < PHASE_BOUND(2, no * K); i += kThreads) {
      const int c = i / K, kk = i % K;
      const size_t at = static_cast<size_t>(2 * H + o0 + c) * K + kk;
      wsp[at] = Gr[c * ldk + kk];
      wsp[static_cast<size_t>(O) * K + at] = Gi[c * ldk + kk];
    }
    // The batch reduction of rank r reads every rank's A: each sample's
    // blocks have all written theirs before any of them takes a ticket.
    __threadfence();
    cluster.sync();
  } else {
    // Phase 2: dW[o,h] of this sample for my out slice and every h. Thread
    // (h, kg) sums the modes k ≡ kg (mod KG) for all my o, then the KG
    // partials are summed in a fixed order.
    const int KG = kThreads / H;
    const int h = tid % H, kg = tid / H;
    float* red = work;  // [KG][2][os][H]
    if (kg < KG) {
      const int src = h / hs, hh = h % hs;
      const float* rAr = cluster.map_shared_rank(Ar, src) + hh * ldk;
      const float* rAi = cluster.map_shared_rank(Ai, src) + hh * ldk;
      float accr[kMaxOut], acci[kMaxOut];
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) accr[o] = acci[o] = 0.f;
      for (int kk = kg; kk < PHASE_BOUND(2, K); kk += KG) {
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
        if (o < no) {
          red[((kg * 2) * os + o) * H + h] = accr[o];
          red[((kg * 2 + 1) * os + o) * H + h] = acci[o];
        }
      }
    }
    // Every block has read what it needs of the others' A: none may leave,
    // or reuse its spectra, before this barrier.
    cluster.sync();
    for (int i = tid; i < no * H; i += kThreads) {
      const int o = i / H, hc = i % H;
      float sr = 0.f, si = 0.f;
      for (int q = 0; q < KG; ++q) {
        sr += red[((q * 2) * os + o) * H + hc];
        si += red[((q * 2 + 1) * os + o) * H + hc];
      }
      wsb[(o0 + o) * H + hc] = sr;
      wsb[O * H + (o0 + o) * H + hc] = -si;  // conj
    }
    __syncthreads();
  }

  // Phase 3: dW_b[o,h] and dbias[o] of this sample for my out slice. Thread
  // (h, sg) sums the points j ≡ sg (mod SG) of each chunk for all my o.
  if constexpr (kBypass) {
    const int SG = kThreads / H;
    const int h = tid % H, sg = tid / H;
    const int cs = a.cols;
    float* xs = work;              // [H][cs + 1]
    float* gs = xs + H * (cs + 1);  // [os][cs]
    const T* xb = a.x + static_cast<size_t>(b) * H * S;
    const T* gb = a.gz + (static_cast<size_t>(b) * O + o0) * S;
    float wacc[kMaxOut], bacc[kMaxOut];
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) wacc[o] = bacc[o] = 0.f;
    for (int c0 = 0; c0 < PHASE_BOUND(3, S); c0 += cs) {
      const int nc = min(cs, S - c0);
      for (int i = tid; i < H * nc; i += kThreads) {
        const int hc = i / nc, j = i % nc;
        xs[hc * (cs + 1) + j] = ld(xb + static_cast<size_t>(hc) * S + c0 + j);
      }
      for (int i = tid; i < no * nc; i += kThreads) {
        const int o = i / nc, j = i % nc;
        gs[o * cs + j] = ld(gb + static_cast<size_t>(o) * S + c0 + j);
      }
      __syncthreads();
      if (sg < SG) {
        for (int j = sg; j < nc; j += SG) {
          const float xv = xs[h * (cs + 1) + j];
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < no) {
              const float gv = gs[o * cs + j];
              wacc[o] = fmaf(gv, xv, wacc[o]);
              if (h == 0) bacc[o] += gv;
            }
          }
        }
      }
      __syncthreads();
    }
    float* red = work;               // [SG][os][H]
    float* redb = red + SG * os * H;  // [SG][os]
    if (sg < SG) {
#pragma unroll
      for (int o = 0; o < kMaxOut; ++o) {
        if (o < no) {
          red[(sg * os + o) * H + h] = wacc[o];
          if (h == 0) redb[sg * os + o] = bacc[o];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < no * H; i += kThreads) {
      const int o = i / H, hc = i % H;
      float s = 0.f;
      for (int q = 0; q < SG; ++q) s += red[(q * os + o) * H + hc];
      wsb[nd + (o0 + o) * H + hc] = s;
    }
    for (int o = tid; o < no; o += kThreads) {
      float s = 0.f;
      for (int q = 0; q < SG; ++q) s += redb[q * os + o];
      wsb[nd + O * H + o0 + o] = s;
    }
  }

  // Batch reduction: the last of the B blocks of my rank sums the partials
  // of out slice `rank` in sample order.
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(a.tickets + rank, 1u) == nb - 1u;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if constexpr (!kPerMode || kBypass) {  // the [O,H] sums
    for (int i = tid; i < no * H; i += kThreads) {
      const int at = (o0 + i / H) * H + i % H;
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
    for (int o = tid; o < no; o += kThreads) {
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
    const size_t spo = np_;  // the spectra's offset in a sample
    float* gs = work;
    const int hg = (H + kHP - 1) / kHP;
    for (int k0 = 0; k0 < K; k0 += kc) {
      const int nk = min(kc, K - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < nb * 2 * no * nk; i += kThreads) {
        const int kk = i % nk, o = i / nk % no, c = i / nk / no % 2;
        const int q = i / nk / no / 2;
        const float* g = a.ws + static_cast<size_t>(q) * wsn + spo +
                         static_cast<size_t>(2 * H + c * O + o0 + o) * K;
        gs[((q * 2 + c) * os + o) * kc + kk] = __ldcg(g + k0 + kk);
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
        for (int q = 0; q < nb; ++q) {
          const float* sp = a.ws + static_cast<size_t>(q) * wsn + spo + k0 +
                            kk;
          float ar[kHP], ai[kHP];
#pragma unroll
          for (int u = 0; u < kHP; ++u) {
            const size_t h = min(hq + u, H - 1);
            ar[u] = __ldcg(sp + h * K);
            ai[u] = __ldcg(sp + (H + h) * K);
          }
          const float* g = gs + (q * 2 * os) * kc + kk;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < no) {
              const float gr = g[o * kc], gi = g[(os + o) * kc];
#pragma unroll
              for (int u = 0; u < kHP; ++u) {
                accr[u][o] = fmaf(gr, ar[u], fmaf(-gi, ai[u], accr[u][o]));
                acci[u][o] = fmaf(gr, ai[u], fmaf(gi, ar[u], acci[u][o]));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kHP; ++u) {
          if (hq + u >= H) break;
#pragma unroll
          for (int o = 0; o < kMaxOut; ++o) {
            if (o < no) {
              const size_t at =
                  (static_cast<size_t>(o0 + o) * H + hq + u) * K + k0 + kk;
              a.dwr[at] = accr[u][o];
              a.dwi[at] = -acci[u][o];  // conj
            }
          }
        }
      }
    }
  }
}

template <int R, typename T, bool kBypass, bool kPerMode>
cudaError_t launch_kernel(const Args<T>& a, int batch, int cl,
                          int smem_bytes, cudaStream_t stream) {
  auto* kernel = fused_wgrad_kernel<R, T, kBypass, kPerMode>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fno::configure(kernel, batch, cl, smem_bytes, stream,
                                   &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, typename T, bool kBypass>
cudaError_t launch_modes(const Args<T>& a, int per_mode, int batch, int cl,
                         int smem_bytes, cudaStream_t stream) {
  return per_mode ? launch_kernel<R, T, kBypass, true>(a, batch, cl,
                                                       smem_bytes, stream)
                  : launch_kernel<R, T, kBypass, false>(a, batch, cl,
                                                        smem_bytes, stream);
}

template <int R, typename T>
cudaError_t launch(const Args<T>& a, int per_mode, int bypass, int batch,
                   int cl, int smem_bytes, cudaStream_t stream) {
  return bypass ? launch_modes<R, T, true>(a, per_mode, batch, cl,
                                           smem_bytes, stream)
                : launch_modes<R, T, false>(a, per_mode, batch, cl,
                                            smem_bytes, stream);
}

template <typename T>
int max_clusters_for(int rank, int cl, int smem_bytes, int* n) {
  switch (rank) {
    case 1: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<1, T, true, false>, cl, smem_bytes, n));
    case 2: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<2, T, true, false>, cl, smem_bytes, n));
    case 3: return static_cast<int>(fno::max_clusters(
        fused_wgrad_kernel<3, T, true, false>, cl, smem_bytes, n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int rank, const void* x, const void* gz,
             const void* const* mats, void* ws, void* tickets,
             void* const* outs, const int* dims, const int* plan,
             void* stream) {
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
  a.rows_f = plan[3];
  a.cols = plan[4];
  const int smem_bytes = plan[5];
  const int per_mode = plan[6];
  a.kc = plan[7];
  const int bypass = plan[8];
  if (a.os > kMaxOut || a.H > kThreads || a.cols < 1 ||
      (per_mode && a.kc < 1) || (bypass && !(a.dwb && a.dbias))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank) {
    case 1: return static_cast<int>(
        launch<1, T>(a, per_mode, bypass, batch, cl, smem_bytes, s));
    case 2: return static_cast<int>(
        launch<2, T>(a, per_mode, bypass, batch, cl, smem_bytes, s));
    case 3: return static_cast<int>(
        launch<3, T>(a, per_mode, bypass, batch, cl, smem_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16 (x, gz,
// operands). mats: 4·rank device pointers (the x chain's re/im per stage,
// then the gz chain's). ws: B·(2·O·H (shared W) + O·H + O (bypass) +
// 2·(H+O)·K (per-mode W)) floats of scratch; tickets: `cluster` zeroed
// unsigned ints. outs: {dwr, dwi [O,H] (per-mode [O,H,K]), dwb [O,H],
// dbias [O]}, float32; dwb and dbias null without the bypass.
// dims: {B, H, O, n_1, n_2, n_3, k_1, k_2, k_3}.
// plan: {cluster, hidden/block, out/block, rows_f, cols, smem bytes,
// per_mode, modes per chunk of the per-mode batch reduction, bypass}.
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

// Writes to *n how many clusters of `cl` blocks (with `smem_bytes` of shared
// memory each) the card can run at once, asked of one instance (shared
// weights, with the bypass) for all: they take the same shared memory;
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
