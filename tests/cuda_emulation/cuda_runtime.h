// CPU emulation of the CUDA runtime subset that src/repro_torch/csrc uses,
// for compiling a kernel source with g++ and running it on the CPU in tests.
// Every thread of a thread-block cluster runs as a POSIX thread; blocks of a
// cluster run together, clusters one after another. __syncthreads is a
// per-block barrier, cluster.sync a cluster-wide one, and each block owns a
// shared-memory buffer that the other blocks of its cluster can map.
// The including build replaces `extern __shared__ float smem[];` with
// `float* smem = g_smem[blockIdx.x].data();`.
#pragma once
#include <pthread.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
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

inline void __syncthreads() { pthread_barrier_wait(&g_block_bar[blockIdx.x]); }
inline float __ldg(const float* p) { return *p; }

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
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid value (emulated)";
}

namespace emu {
struct Thread {
  unsigned bx, by, tx;
  const std::function<void()>* body;
};
inline void* run(void* p) {
  Thread* t = static_cast<Thread*>(p);
  threadIdx = dim3(t->tx);
  blockIdx = dim3(t->bx, t->by);
  (*t->body)();
  return nullptr;
}
}  // namespace emu

template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(E...),
                               A&&... args) {
  gridDim = c->gridDim;
  blockDim = c->blockDim;
  const unsigned cl = c->attrs[0].val.clusterDim.x;
  if (c->numAttrs != 1 || cl != gridDim.x) return cudaErrorInvalidValue;
  const std::function<void()> body = [&]() { k(args...); };
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 64 * 1024);
  for (unsigned by = 0; by < gridDim.y; ++by) {
    // Shared memory starts as NaN so a read before a write shows up.
    g_smem.assign(cl, std::vector<float>(c->dynamicSmemBytes / 4, NAN));
    g_block_bar.assign(cl, pthread_barrier_t{});
    for (auto& b : g_block_bar) pthread_barrier_init(&b, nullptr, blockDim.x);
    pthread_barrier_init(&g_cluster_bar, nullptr, blockDim.x * cl);
    std::vector<emu::Thread> ts;
    for (unsigned bx = 0; bx < cl; ++bx)
      for (unsigned t = 0; t < blockDim.x; ++t) ts.push_back({bx, by, t, &body});
    std::vector<pthread_t> ids(ts.size());
    for (size_t i = 0; i < ts.size(); ++i)
      if (pthread_create(&ids[i], &attr, emu::run, &ts[i]) != 0) abort();
    for (auto& id : ids) pthread_join(id, nullptr);
    for (auto& b : g_block_bar) pthread_barrier_destroy(&b);
    pthread_barrier_destroy(&g_cluster_bar);
  }
  pthread_attr_destroy(&attr);
  return cudaSuccess;
}
