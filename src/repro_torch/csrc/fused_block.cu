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
// Replaces the TPU kernel repro/kernels/engine.py::fused_fnond_call
// (_make_fwd_kernel, engine.py:161-427) in those three modes, with shared
// weights W[o,h] or per-mode weights W[o,h,k_1..k_R] (the classic FNO
// layout), optional bypass and bias epilogue, no lift/proj. Spatial rank
// R ∈ {1,2,3}; element type float or __nv_bfloat16 for x, gy, the weights
// and the DFT operands; every sum accumulates in f32; the output is written
// once, at the element type or (out_f32) in f32.
//
// What bounds it on an H100. At fno2d (B=8, H=O=64, 128×128, 32×32 modes)
// the block needs ~1.9 GFLOP when its transforms are FFTs (2.5·N·log2 N per
// channel each way) beside the CGEMM and the bypass, against ~67 MB of x and
// y in f32: in f32 the card's CUDA-core rate bounds it (~29 µs at
// 67 TFLOP/s); in bf16 its memory (~10 µs). This kernel computes the
// truncated transforms as dense DFT products, ~4.6 GFLOP, all on CUDA cores
// fed from shared memory and L1, so in practice load issue and occupancy
// bound it: each thread keeps kTP outputs in registers so one operand load
// feeds kTP FMAs. Tensor cores (wgmma) and TMA are later work.
//
// Design. The TPU kernel walks a sequential grid over hidden tiles and carries
// the spectral accumulator of a (batch, out) tile in 16 MiB of VMEM. Hopper
// blocks run in parallel and get at most 227 KB of shared memory, so:
//   * one thread-block CLUSTER of CL blocks serves one sample b (CL = 16
//     when the card holds the whole batch's 16-block clusters at once, else
//     the portable 8; the wrapper asks the card and picks);
//   * phase 1 — block r runs the truncated forward DFT chain for its slice of
//     hidden channels, streaming x over s_1 chunks, and keeps the spectra
//     A[h, k_1..k_R] (complex, f32) in its own shared memory;
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
//   * phase 3 — per s_1 chunk, the padded inverse chain (s_1 first, real irDFT
//     on s_R last), then the bypass Σ_h wb·x re-read from L2 (one sample's x
//     is a few MiB), + bias, the epilogue, and a single write.
// Occupancy is low at small batches (B·CL blocks of 132 SMs). Ragged extents
// are masked here: the TPU's lane padding is not ported.
#include <cooperative_groups.h>

#include "fno_common.cuh"

namespace cg = cooperative_groups;
using fno::kThreads;
using fno::kTP;
using fno::ld;
using fno::stage;

namespace {

constexpr int kMaxOut = 8;  // out channels per block (registers in phase 2/3)
constexpr int kPts = 2;     // points per thread in the bypass epilogue

enum Act { kGelu = 0, kGeluVjp = 1, kLinear = 2 };

// Loop bound of phase i (1..3) below. Built with -DFUSED_BLOCK_ELIDE=<mask>,
// the phases whose bit (1 << i) is set run no iteration: the output is then
// wrong and only the time counts (launch/block_phases.py).
#ifndef FUSED_BLOCK_ELIDE
#define FUSED_BLOCK_ELIDE 0
#endif
#define PHASE_BOUND(i, n) (((FUSED_BLOCK_ELIDE >> (i)) & 1) ? 0 : (n))

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
  int rows_f, rows_i;  // s_1 rows per forward / inverse chunk
  long long w_so, w_sh;  // W's element strides of o and h
};

// kBypass=false (wb null) compiles the bare spectral layer: no wb loads and
// no bypass loop, while the bypass path keeps its code unchanged.
// kPerMode=true reads per-mode weights from device memory in phase 2;
// kPerMode=false stages the shared weights' rows in shared memory.
template <int R, typename T, bool kBypass, bool kPerMode>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(gridDim.x);  // the cluster spans grid x
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, hs = a.hs, os = a.os;
  const fno::Geom g = fno::make_geom<R>(a.n, a.k);
  const int n1 = g.n1, n2 = g.n2, n3 = g.n3;
  const int k1 = g.k1, k2 = g.k2, k3 = g.k3;
  const int P = g.P, Kp = g.Kp, K = g.K, S = g.S;
  const int h0 = rank * hs, nh = max(0, min(hs, H - h0));
  const int o0 = rank * os, no = max(0, min(os, O - o0));

  // Shared memory: spectra A of my hidden slice, CGEMM result C of my out
  // slice, my rows of the weights (wb only, with per-mode W), then the work
  // area of phases 1 and 3.
  float* Ar = smem;
  float* Ai = Ar + hs * K;
  float* Cr = Ai + hs * K;
  float* Ci = Cr + os * K;
  float* Wr = Ci + os * K;
  float* Wi = Wr + (kPerMode ? 0 : os * H);
  float* Wb = Wi + (kPerMode ? 0 : os * H);
  float* Bs = Wb + os * H;
  float* work = Bs + kMaxOut;

  for (int i = tid; i < no * H; i += kThreads) {
    const int o = o0 + i / H, h = i % H;
    if (!kPerMode) {
      const size_t at = o * a.w_so + h * a.w_sh;
      Wr[i] = ld(a.wr + at);
      Wi[i] = ld(a.wi + at);
    }
    Wb[i] = kBypass ? ld(a.wb + o * H + h) : 0.f;
  }
  for (int i = tid; i < no; i += kThreads)
    Bs[i] = a.bias ? ld(a.bias + o0 + i) : 0.f;
  for (int i = tid; i < hs * K; i += kThreads) Ar[i] = Ai[i] = 0.f;
  __syncthreads();

  // Phase 1: truncated forward DFT chain of my hidden channels (axis s_R
  // first), streamed over chunks of s_1 rows; the s_1 stage accumulates.
  fno::forward_chain<R, T>(a.x + (static_cast<size_t>(b) * H + h0) * S,
                           PHASE_BOUND(1, nh), g, a.rows_f, a.f, Ar, Ai, K,
                           work);
  cluster.sync();

  // Phase 2: CGEMM over the whole hidden axis, reading every block's spectra
  // through distributed shared memory. Per-mode: W[o0 + o, h, kk] at
  // wbase + o·w_so + h·w_sh.
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
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < no) {
        Cr[o * K + kk] = cr[o];
        Ci[o * K + kk] = ci[o];
      }
    }
  }
  // No block may leave, or reuse its spectra, while another still reads them.
  cluster.sync();

  // Phase 3: per s_1 chunk, the padded inverse chain (s_1 first, real irDFT
  // on s_R last) into ys[o][r·P + p], then bypass + bias + epilogue and one
  // write.
  const int ri = a.rows_i;
  for (int c0 = 0; c0 < PHASE_BOUND(3, n1); c0 += ri) {
    const int nr = min(ri, n1 - c0);
    const int npts = nr * P;
    float* ys = work;  // [no][nr·P]
    float* t1r = ys + os * ri * P;
    float* t1i = t1r + os * ri * Kp;
    const T* e1r = a.e.r[0] + c0;  // columns c0.. of E_1 [k_1][n_1]
    const T* e1i = a.e.i[0] + c0;
    if constexpr (R == 1) {
      stage<T, true, false, false, kTP>(Cr, Ci, no, k1, 1, e1r, e1i, n1, nr, ys,
                                        nullptr);
    } else {
      // T1[o][r][k'] = Σ_{k_1} C[o][k_1][k'] · E_1[k_1][c0 + r]
      stage<T, true, true, false, kTP>(Cr, Ci, no, k1, Kp, e1r, e1i, n1, nr,
                                       t1r, t1i);
      __syncthreads();
      if constexpr (R == 2) {
        stage<T, true, false, false, kTP>(t1r, t1i, no * nr, k2, 1, a.e.r[1],
                                          a.e.i[1], n2, n2, ys, nullptr);
      } else {
        float* t2r = t1i + os * ri * Kp;  // [o][r][n2][k3]
        float* t2i = t2r + os * ri * n2 * k3;
        stage<T, true, true, false, kTP>(t1r, t1i, no * nr, k2, k3, a.e.r[1],
                                         a.e.i[1], n2, n2, t2r, t2i);
        __syncthreads();
        stage<T, true, false, false, kTP>(t2r, t2i, no * nr * n2, k3, 1,
                                          a.e.r[2], a.e.i[2], n3, n3, ys,
                                          nullptr);
      }
    }
    __syncthreads();
    // Bypass: each thread takes kPts points so every wb[o, h] it loads
    // feeds kPts FMAs; x is read once per (h, point), coalesced.
    const T* xb = a.x + static_cast<size_t>(b) * H * S + c0 * P;
    for (int p0 = tid; p0 < npts; p0 += kThreads * kPts) {
      int pt[kPts];
      float byp[kPts][kMaxOut];
#pragma unroll
      for (int u = 0; u < kPts; ++u) {
        pt[u] = min(p0 + u * kThreads, npts - 1);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) byp[u][o] = 0.f;
      }
      for (int h = 0; h < (kBypass ? H : 0); ++h) {
        float xv[kPts];
#pragma unroll
        for (int u = 0; u < kPts; ++u)
          xv[u] = ld(xb + static_cast<size_t>(h) * S + pt[u]);
#pragma unroll
        for (int o = 0; o < kMaxOut; ++o) {
          if (o < no) {
            const float w = Wb[o * H + h];
#pragma unroll
            for (int u = 0; u < kPts; ++u) byp[u][o] = fmaf(w, xv[u], byp[u][o]);
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
            const float z = (ys[o * npts + pt[u]] + byp[u][o]) + Bs[o];
            float v = z;
            if (a.act == kGelu) {
              v = fno::gelu_tanh(z);
            } else if (a.act == kGeluVjp) {
              v = ld(a.gy + at) * fno::dgelu_tanh(z);
            }
            if (a.out_f32) {
              static_cast<float*>(a.y)[at] = v;
            } else {
              fno::st(static_cast<T*>(a.y) + at, v);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int R, typename T, bool kBypass, bool kPerMode>
cudaError_t launch_kernel(const Args<T>& a, int batch, int cl,
                          int smem_bytes, cudaStream_t stream) {
  auto* kernel = fused_block_kernel<R, T, kBypass, kPerMode>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fno::configure(kernel, batch, cl, smem_bytes, stream,
                                   &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, typename T, bool kPerMode>
cudaError_t launch_mode(const Args<T>& a, int batch, int cl, int smem_bytes,
                        cudaStream_t stream) {
  return a.wb ? launch_kernel<R, T, true, kPerMode>(a, batch, cl, smem_bytes,
                                                    stream)
              : launch_kernel<R, T, false, kPerMode>(a, batch, cl,
                                                     smem_bytes, stream);
}

template <int R, typename T>
cudaError_t launch(const Args<T>& a, int per_mode, int batch, int cl,
                   int smem_bytes, cudaStream_t stream) {
  return per_mode
             ? launch_mode<R, T, true>(a, batch, cl, smem_bytes, stream)
             : launch_mode<R, T, false>(a, batch, cl, smem_bytes, stream);
}

template <typename T>
int max_clusters_for(int rank, int cl, int smem_bytes, int* n) {
  switch (rank) {
    case 1: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<1, T, true, false>, cl, smem_bytes, n));
    case 2: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<2, T, true, false>, cl, smem_bytes, n));
    case 3: return static_cast<int>(fno::max_clusters(
        fused_block_kernel<3, T, true, false>, cl, smem_bytes, n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int rank, int act, int out_f32, const void* x, const void* wr,
             const void* wi, const void* wb, const void* bias, const void* gy,
             const void* const* mats, void* y, const int* dims,
             const int* plan, const int* wl, void* stream) {
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
  const int per_mode = wl[0];
  a.w_so = wl[1];
  a.w_sh = wl[2];
  if (a.os > kMaxOut || act < kGelu || act > kLinear ||
      (act == kGeluVjp) != (gy != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank) {
    case 1: return static_cast<int>(
        launch<1, T>(a, per_mode, batch, cl, smem_bytes, s));
    case 2: return static_cast<int>(
        launch<2, T>(a, per_mode, batch, cl, smem_bytes, s));
    case 3: return static_cast<int>(
        launch<3, T>(a, per_mode, batch, cl, smem_bytes, s));
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
// plan: {cluster, hidden/block, out/block, rows_f, rows_i, smem bytes}.
// wl: {per_mode, stride of o, stride of h}: wr, wi are [O, H] (per_mode =
// 0) or [O, H, K] with the modes contiguous, at these element strides.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_block_forward(int dtype, int rank, int act, int out_f32,
                                   const void* x, const void* wr,
                                   const void* wi, const void* wb,
                                   const void* bias, const void* gy,
                                   const void* const* mats, void* y,
                                   const int* dims, const int* plan,
                                   const int* wl, void* stream) {
  if (dtype == 0) {
    return dispatch<float>(rank, act, out_f32, x, wr, wi, wb, bias, gy, mats,
                           y, dims, plan, wl, stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(rank, act, out_f32, x, wr, wi, wb, bias,
                                   gy, mats, y, dims, plan, wl, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
