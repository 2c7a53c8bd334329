// bfloat16 for the host build of a kernel source (see cuda_runtime.h): the
// card's conversions, round to nearest even and NaN to 0x7fff.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{0x7fff};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}
