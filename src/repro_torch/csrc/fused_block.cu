// Fused FNO block forward for NVIDIA Hopper (sm_90a):
//
//   y[b,o,s] = gelu_tanh( Re iDFT_pad( Σ_h DFT_trunc(x[b,h])·(wr + i·wi)[o,h] )[s]
//                         + Σ_h wb[o,h]·x[b,h,s] + bias[o] )
//
// Replaces the TPU kernel repro/kernels/engine.py::fused_fnond_call
// (_make_fwd_kernel, engine.py:161-427) in its block-forward mode
// (act="gelu", shared weights, bypass + bias epilogue, no lift/proj).
// Spatial rank R ∈ {1,2,3}; element type float or __nv_bfloat16 for x, the
// weights, the DFT operands and y; every sum accumulates in f32 and y is
// written once, at the element type.
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
//     C[o,k] = Σ_h W[o,h]·A[h,k] for its slice of out channels, reading the
//     other blocks' spectra through distributed shared memory: the spectrum
//     never touches device memory, and no block recomputes another's DFTs;
//   * phase 3 — per s_1 chunk, the padded inverse chain (s_1 first, real irDFT
//     on s_R last), then the bypass Σ_h wb·x re-read from L2 (one sample's x
//     is a few MiB), + bias, gelu, and a single write of y.
// Occupancy is low at small batches (B·CL blocks of 132 SMs). Ragged extents
// are masked here: the TPU's lane padding is not ported.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxOut = 8;  // out channels per block (registers in phase 2/3)
constexpr int kTP = 4;      // outputs per thread in the non-accumulating stages
constexpr int kPts = 2;     // points per thread in the bypass epilogue

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
  const T* wr;    // [O, H]
  const T* wi;    // [O, H]
  const T* wb;    // [O, H]
  const T* bias;  // [O]
  const T* fr[3];  // forward stage i (axis R-i): [n, k] real part
  const T* fi[3];  //                             imaginary part
  const T* er[3];  // inverse stage i (axis 1+i): [k, n] real part
  const T* ei[3];  //                             imaginary part
  T* y;           // [B, O, n_1..n_R]
  int H, O;
  int n[3], k[3];  // extents and modes, axis order 1..R (unused = 1)
  int hs, os;      // hidden / out channels per block of the cluster
  int rows_f, rows_i;  // s_1 rows per forward / inverse chunk
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float gelu_tanh(float z) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * z * (1.0f + tanhf(c * (z + 0.044715f * z * z * z)));
}

// One DFT stage on shared-memory tensors viewed as [pre][n][post]:
//   out[p][j][q] (+)= Σ_{i<n} in[p][i][q] · M[i·ldm + j],   j < kout.
// kInCplx=false marks a real input (in_i unused). kOutCplx=false keeps only
// the real part Σ in_r·M_r − in_i·M_i (the last inverse stage). Each thread
// computes kTP outputs p, p+1, … that share every operand load M[i, j]
// (register blocking: the loop is load-bound, not FMA-bound). Every thread
// owns distinct outputs, so kAcc needs no synchronisation.
template <typename T, bool kInCplx, bool kOutCplx, bool kAcc, int kTP>
__device__ void stage(const float* in_r, const float* in_i, int pre, int n,
                      int post, const T* m_r, const T* m_i, int ldm, int kout,
                      float* out_r, float* out_i) {
  const int total = (pre + kTP - 1) / kTP * kout * post;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int q = idx % post;
    const int t = idx / post;
    const int j = t % kout;
    const int p0 = t / kout * kTP;
    int base[kTP];
#pragma unroll
    for (int u = 0; u < kTP; ++u) base[u] = min(p0 + u, pre - 1) * n * post + q;
    float sr[kTP], si[kTP];
#pragma unroll
    for (int u = 0; u < kTP; ++u) sr[u] = si[u] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float mr = ld(m_r + i * ldm + j);
      const float mi = ld(m_i + i * ldm + j);
#pragma unroll
      for (int u = 0; u < kTP; ++u) {
        const float a = in_r[base[u] + i * post];
        if (kInCplx) {
          const float c = in_i[base[u] + i * post];
          sr[u] = fmaf(a, mr, fmaf(-c, mi, sr[u]));
          if (kOutCplx) si[u] = fmaf(a, mi, fmaf(c, mr, si[u]));
        } else {
          sr[u] = fmaf(a, mr, sr[u]);
          if (kOutCplx) si[u] = fmaf(a, mi, si[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTP; ++u) {
      if (p0 + u >= pre) break;
      const int o = ((p0 + u) * kout + j) * post + q;
      if (kOutCplx) {
        if (kAcc) {
          out_r[o] += sr[u];
          out_i[o] += si[u];
        } else {
          out_r[o] = sr[u];
          out_i[o] = si[u];
        }
      } else {
        out_r[o] = sr[u];
      }
    }
  }
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(gridDim.x);  // the cluster spans grid x
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = a.H, O = a.O, hs = a.hs, os = a.os;
  const int n1 = a.n[0], n2 = a.n[1], n3 = a.n[2];
  const int k1 = a.k[0], k2 = a.k[1], k3 = a.k[2];
  const int P = (R >= 2 ? n2 : 1) * (R == 3 ? n3 : 1);   // points per s_1 row
  const int Kp = (R >= 2 ? k2 : 1) * (R == 3 ? k3 : 1);  // modes per k_1
  const int K = k1 * Kp;
  const int S = n1 * P;
  const int h0 = rank * hs, nh = max(0, min(hs, H - h0));
  const int o0 = rank * os, no = max(0, min(os, O - o0));

  // Shared memory: spectra A of my hidden slice, CGEMM result C of my out
  // slice, my rows of the weights, then the work area of phases 1 and 3.
  float* Ar = smem;
  float* Ai = Ar + hs * K;
  float* Cr = Ai + hs * K;
  float* Ci = Cr + os * K;
  float* Wr = Ci + os * K;
  float* Wi = Wr + os * H;
  float* Wb = Wi + os * H;
  float* Bs = Wb + os * H;
  float* work = Bs + kMaxOut;

  for (int i = tid; i < no * H; i += kThreads) {
    const int g = (o0 + i / H) * H + i % H;
    Wr[i] = ld(a.wr + g);
    Wi[i] = ld(a.wi + g);
    Wb[i] = ld(a.wb + g);
  }
  for (int i = tid; i < no; i += kThreads) Bs[i] = ld(a.bias + o0 + i);
  for (int i = tid; i < hs * K; i += kThreads) Ar[i] = Ai[i] = 0.f;
  __syncthreads();

  // Phase 1: truncated forward DFT chain of my hidden channels (axis s_R
  // first), streamed over chunks of s_1 rows; the s_1 stage accumulates.
  const int rf = a.rows_f;
  for (int hh = 0; hh < PHASE_BOUND(1, nh); ++hh) {
    const T* xh = a.x + (static_cast<size_t>(b) * H + h0 + hh) * S;
    for (int c0 = 0; c0 < n1; c0 += rf) {
      const int nr = min(rf, n1 - c0);
      float* xs = work;  // [nr][P]
      for (int i = tid; i < nr * P; i += kThreads) xs[i] = ld(xh + c0 * P + i);
      __syncthreads();
      const float* zr = xs;  // [nr][Kp] spectrum of the inner axes
      const float* zi = nullptr;
      if constexpr (R == 2) {
        float* z2r = xs + rf * P;
        float* z2i = z2r + rf * Kp;
        stage<T, false, true, false, kTP>(xs, nullptr, nr, n2, 1, a.fr[0], a.fi[0],
                                     k2, k2, z2r, z2i);
        zr = z2r;
        zi = z2i;
        __syncthreads();
      } else if constexpr (R == 3) {
        float* z1r = xs + rf * P;  // [nr][n2][k3]
        float* z1i = z1r + rf * n2 * k3;
        stage<T, false, true, false, kTP>(xs, nullptr, nr * n2, n3, 1, a.fr[0],
                                     a.fi[0], k3, k3, z1r, z1i);
        __syncthreads();
        float* z2r = z1i + rf * n2 * k3;  // [nr][k2][k3]
        float* z2i = z2r + rf * Kp;
        stage<T, true, true, false, kTP>(z1r, z1i, nr, n2, k3, a.fr[1], a.fi[1],
                                    k2, k2, z2r, z2i);
        zr = z2r;
        zi = z2i;
        __syncthreads();
      }
      // A[k_1][k'] += Σ_{r<nr} Z[r][k'] · F_1[c0 + r][k_1]
      const T* f1r = a.fr[R - 1] + c0 * k1;
      const T* f1i = a.fi[R - 1] + c0 * k1;
      if constexpr (R == 1) {
        stage<T, false, true, true, 1>(zr, nullptr, 1, nr, 1, f1r, f1i, k1, k1,
                                    Ar + hh * K, Ai + hh * K);
      } else {
        stage<T, true, true, true, 1>(zr, zi, 1, nr, Kp, f1r, f1i, k1, k1,
                                   Ar + hh * K, Ai + hh * K);
      }
      __syncthreads();
    }
  }
  cluster.sync();

  // Phase 2: CGEMM over the whole hidden axis, reading every block's spectra
  // through distributed shared memory.
  for (int kk = tid; kk < PHASE_BOUND(2, K); kk += kThreads) {
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
            const float wr = Wr[o * H + h], wi = Wi[o * H + h];
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
  // on s_R last) into ys[o][r·P + p], then bypass + bias + gelu and one write.
  const int ri = a.rows_i;
  for (int c0 = 0; c0 < PHASE_BOUND(3, n1); c0 += ri) {
    const int nr = min(ri, n1 - c0);
    const int npts = nr * P;
    float* ys = work;  // [no][nr·P]
    float* t1r = ys + os * ri * P;
    float* t1i = t1r + os * ri * Kp;
    const T* e1r = a.er[0] + c0;  // columns c0.. of E_1 [k_1][n_1]
    const T* e1i = a.ei[0] + c0;
    if constexpr (R == 1) {
      stage<T, true, false, false, kTP>(Cr, Ci, no, k1, 1, e1r, e1i, n1, nr, ys,
                                   nullptr);
    } else {
      // T1[o][r][k'] = Σ_{k_1} C[o][k_1][k'] · E_1[k_1][c0 + r]
      stage<T, true, true, false, kTP>(Cr, Ci, no, k1, Kp, e1r, e1i, n1, nr, t1r,
                                  t1i);
      __syncthreads();
      if constexpr (R == 2) {
        stage<T, true, false, false, kTP>(t1r, t1i, no * nr, k2, 1, a.er[1],
                                     a.ei[1], n2, n2, ys, nullptr);
      } else {
        float* t2r = t1i + os * ri * Kp;  // [o][r][n2][k3]
        float* t2i = t2r + os * ri * n2 * k3;
        stage<T, true, true, false, kTP>(t1r, t1i, no * nr, k2, k3, a.er[1],
                                    a.ei[1], n2, n2, t2r, t2i);
        __syncthreads();
        stage<T, true, false, false, kTP>(t2r, t2i, no * nr * n2, k3, 1, a.er[2],
                                     a.ei[2], n3, n3, ys, nullptr);
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
      for (int h = 0; h < H; ++h) {
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
            const float z = (ys[o * npts + pt[u]] + byp[u][o]) + Bs[o];
            st(a.y + (static_cast<size_t>(b) * O + o0 + o) * S + c0 * P +
                   pt[u],
               gelu_tanh(z));
          }
        }
      }
    }
    __syncthreads();
  }
}

// Kernel attributes and launch configuration for clusters of `cl` blocks;
// `attr` must outlive `cfg`.
template <int R, typename T>
cudaError_t configure(int batch, int cl, int smem_bytes, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto kernel = fused_block_kernel<R, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  if (cl > 8) {  // Hopper schedules clusters of up to 16 blocks on request
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = dim3(cl, batch, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int R, typename T>
cudaError_t launch(const Args<T>& a, int batch, int cl, int smem_bytes,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R, T>(batch, cl, smem_bytes, stream, &cfg,
                                    &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fused_block_kernel<R, T>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cl` blocks the card holds at once (0: none fits).
template <int R, typename T>
cudaError_t max_clusters(int cl, int smem_bytes, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<R, T>(1, cl, smem_bytes, nullptr, &cfg,
                                    &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, fused_block_kernel<R, T>, &cfg);
}

template <typename T>
int max_clusters_for(int rank, int cl, int smem_bytes, int* n) {
  switch (rank) {
    case 1: return static_cast<int>(max_clusters<1, T>(cl, smem_bytes, n));
    case 2: return static_cast<int>(max_clusters<2, T>(cl, smem_bytes, n));
    case 3: return static_cast<int>(max_clusters<3, T>(cl, smem_bytes, n));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int rank, const void* x, const void* wr, const void* wi,
             const void* wb, const void* bias, const void* const* mats,
             void* y, const int* dims, const int* plan, void* stream) {
  Args<T> a = {};
  a.x = static_cast<const T*>(x);
  a.wr = static_cast<const T*>(wr);
  a.wi = static_cast<const T*>(wi);
  a.wb = static_cast<const T*>(wb);
  a.bias = static_cast<const T*>(bias);
  for (int i = 0; i < rank; ++i) {
    a.fr[i] = static_cast<const T*>(mats[2 * i]);
    a.fi[i] = static_cast<const T*>(mats[2 * i + 1]);
    a.er[i] = static_cast<const T*>(mats[2 * rank + 2 * i]);
    a.ei[i] = static_cast<const T*>(mats[2 * rank + 2 * i + 1]);
  }
  a.y = static_cast<T*>(y);
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
  if (a.os > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rank) {
    case 1: return static_cast<int>(launch<1, T>(a, batch, cl, smem_bytes, s));
    case 2: return static_cast<int>(launch<2, T>(a, batch, cl, smem_bytes, s));
    case 3: return static_cast<int>(launch<3, T>(a, batch, cl, smem_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mats: 4·rank device pointers (forward re/im per stage, then inverse).
// dims: {B, H, O, n_1, n_2, n_3, k_1, k_2, k_3}.
// plan: {cluster, hidden/block, out/block, rows_f, rows_i, smem bytes}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_block_forward(int dtype, int rank, const void* x,
                                   const void* wr, const void* wi,
                                   const void* wb, const void* bias,
                                   const void* const* mats, void* y,
                                   const int* dims, const int* plan,
                                   void* stream) {
  if (dtype == 0) {
    return dispatch<float>(rank, x, wr, wi, wb, bias, mats, y, dims, plan,
                           stream);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(rank, x, wr, wi, wb, bias, mats, y, dims,
                                   plan, stream);
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
