// Device helpers shared by the fused FNO block kernel (fused_block.cu) and
// the fused weight-gradient kernel (fused_wgrad.cu): element loads and
// stores, the tanh GELU and its derivative, one truncated-DFT stage on
// shared-memory tensors, one s_1 chunk of the forward DFT chain, and the
// streamed forward DFT chain of a run of channels on the CUDA cores (the
// kernels' second chain plan, and the lift's). Every sum accumulates in
// f32. Guarded by a macro, not #pragma once: a test's mutated copy of this
// header, found first, then stands in for the sources' own.
#ifndef REPRO_TORCH_FNO_COMMON_CUH
#define REPRO_TORCH_FNO_COMMON_CUH
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// A device function called, not inlined, on the card: its registers are not
// shared with the live state of the kernel around it. The CPU emulation of
// the tests inlines as it likes.
#ifdef __CUDACC__
#define FNO_NOINLINE __noinline__
#else
#define FNO_NOINLINE
#endif

namespace fno {

constexpr int kThreads = 512;
constexpr int kTP = 4;  // outputs per thread in the non-accumulating stages

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v rounded to T and back: the value a T store then load would give.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float z) {
  return 0.5f * z * (1.0f + tanhf(kGeluC * (z + kGeluA * z * z * z)));
}

// d/dz of gelu_tanh: with u = c·(z + a·z³),
// gelu'(z) = ½(1 + tanh u) + ½·z·(1 − tanh²u)·c·(1 + 3a·z²).
__device__ __forceinline__ float dgelu_tanh(float z) {
  const float z2 = z * z;
  const float t = tanhf(kGeluC * z * (1.0f + kGeluA * z2));
  return 0.5f * (1.0f + t) +
         0.5f * z * (1.0f - t * t) * kGeluC * (1.0f + 3.0f * kGeluA * z2);
}

// Extents of one launch, axis order 1..R (unused axes are 1).
struct Geom {
  int n1, n2, n3, k1, k2, k3;
  int P;   // points per s_1 row
  int Kp;  // modes per k_1
  int K;   // modes in all
  int S;   // points in all
};

template <int R>
__device__ __forceinline__ Geom make_geom(const int* n, const int* k) {
  Geom g;
  g.n1 = n[0];
  g.n2 = n[1];
  g.n3 = n[2];
  g.k1 = k[0];
  g.k2 = k[1];
  g.k3 = k[2];
  g.P = (R >= 2 ? g.n2 : 1) * (R == 3 ? g.n3 : 1);
  g.Kp = (R >= 2 ? g.k2 : 1) * (R == 3 ? g.k3 : 1);
  g.K = g.k1 * g.Kp;
  g.S = g.n1 * g.P;
  return g;
}

// A chain of R truncated-DFT operands, real and imaginary parts per stage.
template <typename T>
struct Mats {
  const T* r[3];
  const T* i[3];
};

// One complex DFT stage on shared-memory tensors viewed as [pre][n][post]:
//   out[p][j][q] (+)= Σ_{i<n} in[p][i][q] · M[i·ldm + j],   j < kout.
// kInCplx=false marks a real input (in_i unused). Each thread computes kTP
// outputs p, p+1, … that share every operand load M[i, j] (register
// blocking: the loop is load-bound, not FMA-bound). Every thread owns
// distinct outputs, so kAcc needs no synchronisation.
template <typename T, bool kInCplx, bool kAcc, int kTPn>
__device__ void stage(const float* in_r, const float* in_i, int pre, int n,
                      int post, const T* m_r, const T* m_i, int ldm, int kout,
                      float* out_r, float* out_i) {
  const int total = (pre + kTPn - 1) / kTPn * kout * post;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int q = idx % post;
    const int t = idx / post;
    const int j = t % kout;
    const int p0 = t / kout * kTPn;
    int base[kTPn];
#pragma unroll
    for (int u = 0; u < kTPn; ++u) base[u] = min(p0 + u, pre - 1) * n * post + q;
    float sr[kTPn], si[kTPn];
#pragma unroll
    for (int u = 0; u < kTPn; ++u) sr[u] = si[u] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float mr = ld(m_r + i * ldm + j);
      const float mi = ld(m_i + i * ldm + j);
#pragma unroll
      for (int u = 0; u < kTPn; ++u) {
        const float a = in_r[base[u] + i * post];
        if (kInCplx) {
          const float c = in_i[base[u] + i * post];
          sr[u] = fmaf(a, mr, fmaf(-c, mi, sr[u]));
          si[u] = fmaf(a, mi, fmaf(c, mr, si[u]));
        } else {
          sr[u] = fmaf(a, mr, sr[u]);
          si[u] = fmaf(a, mi, si[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTPn; ++u) {
      if (p0 + u >= pre) break;
      const int o = ((p0 + u) * kout + j) * post + q;
      if (kAcc) {
        out_r[o] += sr[u];
        out_i[o] += si[u];
      } else {
        out_r[o] = sr[u];
        out_i[o] = si[u];
      }
    }
  }
}

// One s_1 chunk of the truncated forward DFT chain of one real channel:
// xs [nr][P] holds rows c0..c0+nr of s_1 in shared memory, `tmp` the
// stages' intermediates (2·rf·Kp floats at R ≥ 2, + 2·rf·n2·k3 at R = 3);
// the s_1 stage ACCUMULATES the spectrum into out_{r,i}[k] (k = k_1·Kp + k').
// Every thread of the block calls it; it ends synchronised.
template <int R, typename T>
__device__ void chain_chunk(const float* xs, int nr, int c0, const Geom& g,
                            int rf, const Mats<T>& m, float* out_r,
                            float* out_i, float* tmp) {
  const float* zr = xs;  // [nr][Kp] spectrum of the inner axes
  const float* zi = nullptr;
  if constexpr (R == 2) {
    float* z2r = tmp;
    float* z2i = z2r + rf * g.Kp;
    stage<T, false, false, kTP>(xs, nullptr, nr, g.n2, 1, m.r[0],
                                      m.i[0], g.k2, g.k2, z2r, z2i);
    zr = z2r;
    zi = z2i;
    __syncthreads();
  } else if constexpr (R == 3) {
    float* z1r = tmp;  // [nr][n2][k3]
    float* z1i = z1r + rf * g.n2 * g.k3;
    stage<T, false, false, kTP>(xs, nullptr, nr * g.n2, g.n3, 1,
                                      m.r[0], m.i[0], g.k3, g.k3, z1r, z1i);
    __syncthreads();
    float* z2r = z1i + rf * g.n2 * g.k3;  // [nr][k2][k3]
    float* z2i = z2r + rf * g.Kp;
    stage<T, true, false, kTP>(z1r, z1i, nr, g.n2, g.k3, m.r[1],
                                     m.i[1], g.k2, g.k2, z2r, z2i);
    zr = z2r;
    zi = z2i;
    __syncthreads();
  }
  // A[k_1][k'] += Σ_{r<nr} Z[r][k'] · F_1[c0 + r][k_1]
  const T* f1r = m.r[R - 1] + c0 * g.k1;
  const T* f1i = m.i[R - 1] + c0 * g.k1;
  if constexpr (R == 1) {
    stage<T, false, true, 1>(zr, nullptr, 1, nr, 1, f1r, f1i, g.k1,
                                   g.k1, out_r, out_i);
  } else {
    stage<T, true, true, 1>(zr, zi, 1, nr, g.Kp, f1r, f1i, g.k1, g.k1,
                                  out_r, out_i);
  }
  __syncthreads();
}

// Floats of forward_chain's `work` at rank R, extents n and modes k (axis
// order 1..R, unused = 1) and `rf` s_1 rows a chunk: rf·P (+ 2·rf·Kp at
// R ≥ 2, + 2·rf·n2·k3 at R = 3). Mirrored by kernels/engine.py _chain_work.
__host__ __device__ inline long long chain_work(int R, const int* n,
                                                const int* k, int rf) {
  const long long kp = 1LL * k[1] * k[2];
  long long w = 1LL * rf * n[1] * n[2];
  if (R >= 2) w += 2LL * rf * kp;
  if (R == 3) w += 2LL * rf * n[1] * k[2];
  return w;
}

// Truncated forward DFT chain of `nch` real channels src[c][s] (channel
// stride S), axis s_R first, streamed over chunks of `rf` s_1 rows; the s_1
// stage ACCUMULATES the spectrum of channel c into out_{r,i}[c·ldo + k]
// (k = k_1·Kp + k', the caller zeroes it). `work` holds chain_work floats;
// the last chunk may be short. Every thread of the block calls it; it ends
// synchronised. The kernels' second chain plan: a call of its own, its
// operands by value, so that it adds nothing to the registers of the
// tensor-core chain beside it in the same kernel.
template <int R, typename T>
__device__ FNO_NOINLINE void forward_chain(const T* src, int nch,
                                           const Geom g, int rf,
                                           const Mats<T> m, float* out_r,
                                           float* out_i, int ldo,
                                           float* work) {
  for (int c = 0; c < nch; ++c) {
    const T* xh = src + static_cast<size_t>(c) * g.S;
    for (int c0 = 0; c0 < g.n1; c0 += rf) {
      const int nr = min(rf, g.n1 - c0);
      float* xs = work;  // [nr][P]
      for (int i = threadIdx.x; i < nr * g.P; i += blockDim.x)
        xs[i] = ld(xh + c0 * g.P + i);
      __syncthreads();
      chain_chunk<R, T>(xs, nr, c0, g, rf, m, out_r + c * ldo,
                        out_i + c * ldo, xs + rf * g.P);
    }
  }
}

// Kernel attributes and launch configuration for a grid of clusters of `cl`
// blocks, one cluster per sample; `attr` must outlive `cfg`.
template <class Kernel>
cudaError_t configure(Kernel kernel, int batch, int cl, int smem_bytes,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
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

// How many clusters of `cl` blocks of `kernel` the card holds at once.
template <class Kernel>
cudaError_t max_clusters(Kernel kernel, int cl, int smem_bytes, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, 1, cl, smem_bytes, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

}  // namespace fno

#endif  // REPRO_TORCH_FNO_COMMON_CUH
