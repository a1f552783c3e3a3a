// CPU emulation of the CUDA built-ins that csrc/wpe_solve.cu, csrc/qconv.cu and
// csrc/upfirdn.cu use, for g++ (C++20): one std::thread per CUDA thread, all blocks of a grid
// (up to three dimensions) at once, a
// std::barrier per block for __syncthreads and per warp for the warp-level
// operations (shuffles, reductions, ballots exchange values through a slot per
// lane), a generation counter per named barrier for bar.arrive / bar.sync.
// tests/test_torch_wpe_plan.py rewrites the launches, the dynamic shared
// memory and the inline PTX of the source onto it.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(x) alignas(x)
#define __launch_bounds__(...)

struct double2 { double x, y; };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline double2 make_double2(double x, double y) { return {x, y}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }

struct EmuIdx { unsigned x, y, z; };
inline thread_local EmuIdx threadIdx, blockIdx, blockDim, gridDim;

namespace emu {
struct NamedBar {
  std::mutex m;
  std::condition_variable cv;
  int count = 0;
  unsigned gen = 0;
};
struct Block {
  std::vector<unsigned char> smem;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<uint64_t> slots;
  NamedBar named[16];
};
inline thread_local Block* blk = nullptr;
inline void* smem() { return blk->smem.data(); }
inline int lane() { return threadIdx.x & 31; }
inline int warp() { return threadIdx.x / 32; }
inline void wbar() { blk->warp_bar[warp()]->arrive_and_wait(); }
inline uint64_t exchange(uint64_t v, int src) {
  uint64_t* s = blk->slots.data() + 32 * warp();
  s[lane()] = v;
  wbar();
  const uint64_t out = s[src & 31];
  wbar();
  return out;
}
inline unsigned reduce(unsigned v, bool take_max) {
  uint64_t* s = blk->slots.data() + 32 * warp();
  s[lane()] = v;
  wbar();
  unsigned out = (unsigned)s[0];
  for (int i = 1; i < 32; ++i)
    out = take_max ? std::max(out, (unsigned)s[i]) : std::min(out, (unsigned)s[i]);
  wbar();
  return out;
}
// bar.arrive (wait = false) and bar.sync (wait = true) on barrier id with n threads
inline void named_bar(int id, int n, bool wait) {
  NamedBar& b = blk->named[id];
  std::unique_lock<std::mutex> lk(b.m);
  const unsigned gen = b.gen;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    b.cv.notify_all();
    return;
  }
  if (wait) b.cv.wait(lk, [&] { return b.gen != gen; });
}
// one block at a time when set (for kernels whose blocks never wait on each
// other: fewer threads alive at once)
inline bool serial_blocks = false;
inline void launch(dim3 g, dim3 b, size_t smem_bytes, std::function<void()> body) {
  const unsigned nb = g.x * g.y * g.z, nt = b.x;
  std::vector<std::unique_ptr<Block>> blocks;
  for (unsigned i = 0; i < nb; ++i) {
    auto bl = std::make_unique<Block>();
    bl->smem.assign(smem_bytes, 0xA5);  // garbage, as on the card
    bl->bar = std::make_unique<std::barrier<>>(nt);
    for (unsigned w = 0; w < (nt + 31) / 32; ++w)
      bl->warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32u, nt - 32 * w)));
    bl->slots.assign(32 * ((nt + 31) / 32), 0);
    blocks.push_back(std::move(bl));
  }
  std::vector<std::thread> ts;
  for (unsigned i = 0; i < nb; ++i) {
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([&, i, t] {
        blk = blocks[i].get();
        threadIdx = {t, 0, 0};
        blockIdx = {i % g.x, (i / g.x) % g.y, i / (g.x * g.y)};
        blockDim = {nt, 1, 1};
        gridDim = {g.x, g.y, g.z};
        body();
      });
    if (serial_blocks || i + 1 == nb) {
      for (auto& t : ts) t.join();
      ts.clear();
    }
  }
}
}  // namespace emu

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::wbar(); }
inline double __shfl_sync(unsigned, double v, int src) {
  uint64_t b;
  std::memcpy(&b, &v, 8);
  b = emu::exchange(b, src);
  double o;
  std::memcpy(&o, &b, 8);
  return o;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return (unsigned)emu::exchange(v, src);
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return emu::reduce(v, true); }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return emu::reduce(v, false); }
inline unsigned __ballot_sync(unsigned, bool v) {
  uint64_t* s = emu::blk->slots.data() + 32 * emu::warp();
  s[emu::lane()] = v;
  emu::wbar();
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) out |= (s[i] ? 1u : 0u) << i;
  emu::wbar();
  return out;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline long long __double_as_longlong(double v) {
  long long b;
  std::memcpy(&b, &v, 8);
  return b;
}
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
// rcp.approx.ftz.f64 as a float32 reciprocal: about as many bits as the card's
inline double emu_rcp_approx(double d) { return (double)(1.0f / (float)d); }
using std::fma;
using std::fmaf;
