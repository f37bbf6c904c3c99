// CPU emulation of the CUDA runtime subset that src/repro_torch/csrc uses,
// for compiling a kernel source with g++ and running it on the CPU in tests.
// Every thread of a thread-block cluster runs as a POSIX thread; blocks of a
// cluster run together, clusters one after another. __syncthreads is a
// per-block barrier, cluster.sync a cluster-wide one, and each block owns a
// shared-memory buffer that the other blocks of its cluster can map.
// Clusters run in grid order, so a block's atomic ticket sees every earlier
// cluster's writes. A launch without a cluster attribute runs its blocks one
// at a time, in grid order. The including build replaces
// `extern __shared__ float smem[];` with
// `float* smem = g_smem[blockIdx.x].data();`.
#pragma once
#include <pthread.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <vector>

#define CUDA_EMULATION 1  // the kernels' emulated paths (tc_common.cuh)
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::vector<std::vector<float>> g_smem;  // one buffer per block
inline std::vector<pthread_barrier_t> g_block_bar;
inline pthread_barrier_t g_cluster_bar;
// Warp shuffles: every lane of a warp posts its value, the warp meets at a
// barrier, reads its partner's and meets again (all 32 lanes take part).
inline std::vector<pthread_barrier_t> g_warp_bar;  // [block][warp]
inline std::vector<float> g_lanes;                 // [block][thread]
// Fragment registers of an emulated mma.sync (mma.h): [block][thread][6].
inline std::vector<unsigned> g_xchg;

inline void __syncthreads() { pthread_barrier_wait(&g_block_bar[blockIdx.x]); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t w = blockIdx.x * (blockDim.x / 32) + warp;
  float* lanes = g_lanes.data() + blockIdx.x * blockDim.x + warp * 32;
  lanes[lane] = v;
  pthread_barrier_wait(&g_warp_bar[w]);
  const float r = lanes[lane ^ lane_mask];
  pthread_barrier_wait(&g_warp_bar[w]);
  return r;
}
inline float __ldg(const float* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __ldcg(const float* p) { return *p; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// The emulated card holds EMULATED_MAX_CLUSTERS clusters at once, of any size.
#ifndef EMULATED_MAX_CLUSTERS
#define EMULATED_MAX_CLUSTERS 4
#endif
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F*,
                                           const cudaLaunchConfig_t*) {
  *n = EMULATED_MAX_CLUSTERS;
  return cudaSuccess;
}
// ... and EMULATED_SMS multiprocessors of one block each.
#ifndef EMULATED_SMS
#define EMULATED_SMS 2
#endif
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMULATED_SMS;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid value (emulated)";
}

namespace emu {
struct Thread {
  unsigned bx, by, tx, bz;
  const std::function<void()>* body;
};
inline void* run(void* p) {
  Thread* t = static_cast<Thread*>(p);
  threadIdx = dim3(t->tx);
  blockIdx = dim3(t->bx, t->by, t->bz);
  (*t->body)();
  return nullptr;
}
}  // namespace emu

template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(E...),
                               A&&... args) {
  gridDim = c->gridDim;
  blockDim = c->blockDim;
  const std::function<void()> body = [&]() { k(args...); };
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 64 * 1024);
  const unsigned nwarps = blockDim.x % 32 == 0 ? blockDim.x / 32 : 0;
  g_warp_bar.assign(gridDim.x * nwarps, pthread_barrier_t{});
  g_lanes.assign(gridDim.x * blockDim.x, 0.f);
  g_xchg.assign(gridDim.x * blockDim.x * 6, 0u);
  auto warp_bars = [&](unsigned bx, bool init) {
    for (unsigned w = bx * nwarps; w < (bx + 1) * nwarps; ++w) {
      if (init) pthread_barrier_init(&g_warp_bar[w], nullptr, 32);
      else pthread_barrier_destroy(&g_warp_bar[w]);
    }
  };
  if (c->numAttrs == 0) {  // no cluster: every block alone, in grid order
    g_block_bar.assign(gridDim.x, pthread_barrier_t{});
    for (unsigned bz = 0; bz < gridDim.z; ++bz) {
      for (unsigned by = 0; by < gridDim.y; ++by) {
        for (unsigned bx = 0; bx < gridDim.x; ++bx) {
          g_smem.assign(gridDim.x, std::vector<float>());
          g_smem[bx].assign(c->dynamicSmemBytes / 4, NAN);
          pthread_barrier_init(&g_block_bar[bx], nullptr, blockDim.x);
          warp_bars(bx, true);
          std::vector<emu::Thread> ts;
          for (unsigned t = 0; t < blockDim.x; ++t)
            ts.push_back({bx, by, t, bz, &body});
          std::vector<pthread_t> ids(ts.size());
          for (size_t i = 0; i < ts.size(); ++i)
            if (pthread_create(&ids[i], &attr, emu::run, &ts[i]) != 0)
              abort();
          for (auto& id : ids) pthread_join(id, nullptr);
          pthread_barrier_destroy(&g_block_bar[bx]);
          warp_bars(bx, false);
        }
      }
    }
    pthread_attr_destroy(&attr);
    return cudaSuccess;
  }
  const unsigned cl = c->attrs[0].val.clusterDim.x;
  if (c->numAttrs != 1 || cl != gridDim.x) return cudaErrorInvalidValue;
  for (unsigned bz = 0; bz < gridDim.z; ++bz) {
    for (unsigned by = 0; by < gridDim.y; ++by) {
      // Shared memory starts as NaN so a read before a write shows up.
      g_smem.assign(cl, std::vector<float>(c->dynamicSmemBytes / 4, NAN));
      g_block_bar.assign(cl, pthread_barrier_t{});
      for (auto& b : g_block_bar) pthread_barrier_init(&b, nullptr, blockDim.x);
      for (unsigned bx = 0; bx < cl; ++bx) warp_bars(bx, true);
      pthread_barrier_init(&g_cluster_bar, nullptr, blockDim.x * cl);
      std::vector<emu::Thread> ts;
      for (unsigned bx = 0; bx < cl; ++bx)
        for (unsigned t = 0; t < blockDim.x; ++t)
          ts.push_back({bx, by, t, bz, &body});
      std::vector<pthread_t> ids(ts.size());
      for (size_t i = 0; i < ts.size(); ++i)
        if (pthread_create(&ids[i], &attr, emu::run, &ts[i]) != 0) abort();
      for (auto& id : ids) pthread_join(id, nullptr);
      for (auto& b : g_block_bar) pthread_barrier_destroy(&b);
      for (unsigned bx = 0; bx < cl; ++bx) warp_bars(bx, false);
      pthread_barrier_destroy(&g_cluster_bar);
    }
  }
  pthread_attr_destroy(&attr);
  return cudaSuccess;
}
