// CPU emulation of __nv_bfloat16 (round to nearest even, as the card does).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t v;
};
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
