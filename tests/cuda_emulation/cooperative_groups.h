// CPU emulation of the thread-block-cluster part of cooperative groups.
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return blockIdx.x; }
  void sync() const { pthread_barrier_wait(&g_cluster_bar); }
  template <class T>
  T* map_shared_rank(T* p, int rank) const {
    const ptrdiff_t off = reinterpret_cast<float*>(p) - g_smem[blockIdx.x].data();
    return reinterpret_cast<T*>(g_smem[rank].data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
