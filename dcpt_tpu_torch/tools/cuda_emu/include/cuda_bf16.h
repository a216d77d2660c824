// bfloat16 for the CPU emulation (see ../build.py): round to nearest even.
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = (uint32_t)h.v << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) { uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1); return __nv_bfloat16{(uint16_t)(u >> 16)}; }
struct alignas(4) __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 h) { return float2{__bfloat162float(h.x), __bfloat162float(h.y)}; }
