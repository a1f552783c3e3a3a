// cp.async for the CPU emulation (tests/cuda_emu/cuda_emu.h): a plain copy.
#pragma once
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, unsigned long bytes) {
  std::memcpy(dst, src, bytes);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
