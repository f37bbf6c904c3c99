// CPU emulation of the tensor-core products that src/repro_torch/csrc uses
// (tc_common.cuh): mma.sync m16n8k8 TF32 and m16n8k16 bf16 with an f32
// accumulator. Each lane holds only its own fragment registers, as on the
// card: the warp's 32 lanes post theirs, meet at the warp barrier, and
// each computes its four outputs from the gathered tiles. A TF32 product
// reads only the 19 high bits of each f32 operand, as the tensor cores do.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace emu {

// The TF32 value the tensor cores read from an f32 operand: its low 13
// mantissa bits dropped.
inline float tf32_operand(unsigned u) { return __uint_as_float(u & ~0x1FFFu); }

inline float bf16_half(unsigned u, int hi) {
  return __bfloat162float(__nv_bfloat16{uint16_t(hi ? u >> 16 : u & 0xFFFF)});
}

// Every lane's 6 fragment registers (a0..a3, b0, b1) of one mma.sync.
inline void gather(const unsigned (&a)[4], const unsigned (&b)[2],
                   unsigned (&all)[32][6]) {
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t w = blockIdx.x * (blockDim.x / 32) + warp;
  unsigned* slots = g_xchg.data() + (blockIdx.x * blockDim.x + warp * 32) * 6;
  for (int i = 0; i < 4; ++i) slots[lane * 6 + i] = a[i];
  for (int i = 0; i < 2; ++i) slots[lane * 6 + 4 + i] = b[i];
  pthread_barrier_wait(&g_warp_bar[w]);
  std::memcpy(all, slots, sizeof(all));
  pthread_barrier_wait(&g_warp_bar[w]);
}

// d += A·B for this lane's outputs (g, 2t), (g, 2t+1), (g+8, 2t), (g+8,
// 2t+1) of the 16×8 tile, from the warp's A [16][K] and B [K][8].
template <int K>
inline void accumulate(float (&d)[4], const float (&A)[16][K],
                       const float (&B)[K][8]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    float s = d[e];
    for (int k = 0; k < K; ++k) s += A[r][k] * B[k][c];
    d[e] = s;
  }
}

}  // namespace emu

inline void emulated_mma_tf32(float (&d)[4], const unsigned (&a)[4],
                              const unsigned (&b)[2]) {
  unsigned all[32][6];
  emu::gather(a, b, all);
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    A[g][t] = emu::tf32_operand(all[l][0]);
    A[g + 8][t] = emu::tf32_operand(all[l][1]);
    A[g][t + 4] = emu::tf32_operand(all[l][2]);
    A[g + 8][t + 4] = emu::tf32_operand(all[l][3]);
    B[t][g] = emu::tf32_operand(all[l][4]);
    B[t + 4][g] = emu::tf32_operand(all[l][5]);
  }
  emu::accumulate<8>(d, A, B);
}

inline void emulated_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                              const unsigned (&b)[2]) {
  unsigned all[32][6];
  emu::gather(a, b, all);
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu::bf16_half(all[l][0], h);
      A[g + 8][2 * t + h] = emu::bf16_half(all[l][1], h);
      A[g][2 * t + 8 + h] = emu::bf16_half(all[l][2], h);
      A[g + 8][2 * t + 8 + h] = emu::bf16_half(all[l][3], h);
      B[2 * t + h][g] = emu::bf16_half(all[l][4], h);
      B[2 * t + 8 + h][g] = emu::bf16_half(all[l][5], h);
    }
  }
  emu::accumulate<16>(d, A, B);
}
