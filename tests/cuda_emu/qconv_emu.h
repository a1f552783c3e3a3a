// CPU emulation of what csrc/qconv.cu uses beyond tests/cuda_emu/cuda_emu.h:
// bfloat16 (a uint16 rounded to nearest even), the float intrinsics, static
// __shared__ variables (one per block, by the id the text pass gives them),
// and the PTX primitives: cp.async as a copy (zero-filled when its source
// size is 0), ldmatrix.x4 and mma.sync.m16n8k32.s8 through the warp's
// exchange slots.  Blocks run one at a time.  tests/test_torch_int8.py rewrites the source onto it.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}
inline __nv_bfloat16 __float2bfloat16_rn(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};   // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float((unsigned)h.bits << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __int2float_rn(int v) { return (float)v; }

namespace emu {
// the blocks of csrc/qconv.cu's kernels never wait on each other
inline const bool qconv_serial = (serial_blocks = true);
inline std::mutex static_mu;
inline std::map<std::pair<const void*, int>, std::vector<unsigned char>> static_mem;
// the block's static __shared__ variable number id, of n elements
template <class T> T* static_shared(int id, int n) {
  std::lock_guard<std::mutex> lk(static_mu);
  auto& v = static_mem[{blk, id}];
  if (v.size() < n * sizeof(T)) v.assign(n * sizeof(T), 0xA5);
  return reinterpret_cast<T*>(v.data());
}
// every lane's 64-bit value, in lane order
inline void gather(uint64_t v, uint64_t* all) {
  uint64_t* s = blk->slots.data() + 32 * warp();
  s[lane()] = v;
  wbar();
  for (int i = 0; i < 32; ++i) all[i] = s[i];
  wbar();
}
}  // namespace emu

inline void cp_async16(void* dst, const void* src, int src_bytes) {
  if (src_bytes == 16) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

// matrix i's rows come from lanes 8i..8i+7; a lane gets the 4 bytes at column
// 4 (lane % 4) of row lane / 4 of each matrix
inline void ldmatrix_x4(unsigned* r, const void* p) {
  uint64_t addr[32];
  emu::gather((uint64_t)(uintptr_t)p, addr);
  const int l = emu::lane();
  for (int i = 0; i < 4; ++i)
    std::memcpy(&r[i], (const unsigned char*)(uintptr_t)addr[8 * i + l / 4] + 4 * (l % 4), 4);
}

// D = A (16 x 32, row) B (32 x 8, col) + C, int8 in, int32 out
inline void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  uint64_t a01[32], a23[32], b01[32];
  emu::gather(a[0] | ((uint64_t)a[1] << 32), a01);
  emu::gather(a[2] | ((uint64_t)a[3] << 32), a23);
  emu::gather(b[0] | ((uint64_t)b[1] << 32), b01);
  auto A = [&](int row, int k) {
    const int ln = (row % 8) * 4 + (k % 16) / 4, reg = (row >= 8 ? 1 : 0) + (k >= 16 ? 2 : 0);
    const uint64_t w = reg < 2 ? a01[ln] : a23[ln];
    return (int)(int8_t)((w >> (32 * (reg & 1) + 8 * (k % 4))) & 0xff);
  };
  auto B = [&](int k, int n) {
    const int ln = n * 4 + (k % 16) / 4, reg = k >= 16 ? 1 : 0;
    return (int)(int8_t)((b01[ln] >> (32 * reg + 8 * (k % 4))) & 0xff);
  };
  const int g = emu::lane() >> 2, t = emu::lane() & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    int s = 0;
    for (int k = 0; k < 32; ++k) s += A(row, k) * B(k, col);
    c[e] += s;
  }
}
