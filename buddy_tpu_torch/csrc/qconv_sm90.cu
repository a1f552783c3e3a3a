// K10's int8 convolution for Hopper: a TMA halo tile feeding wgmma.
//
// Replaces buddy_tpu/ops/qconv.py:97 `_int8_conv` and the dequant epilogue of
// `quantized_conv` (:108-136), the same function as csrc/qconv.cu's
// qc_conv_kernel (the mma.sync route, kept for the shapes this one does not
// take) and bit for bit with it: exact int32 sums, the same epilogue.
// ops/qconv.py::int8_conv sends a CUDA tensor here when C_in % 128 == 0 and
// C_out % 128 == 0, which every convolution of the full-width int8 U-Net meets
// (C_in and C_out 128-512).
//
// What bounds it on the H100: operations (int8 at 1979 TOP/s) at the 3x3
// shapes, the output's bytes at most 1x1 shapes.  The design:
//
// * A from a halo tile.  A CTA owns a tile of one output phase, 8 x 16
//   pixels of the input grid, and 128 output channels.  For each
//   128-channel chunk of C_in one TMA load (a 4-D tensor map over the NHWC
//   int8 input, dims {C, W, H, B}, 128-byte swizzle) brings the box the
//   tile's taps reach: for the 3x3 and the fused 3x3, 10 x 18 pixels x 128
//   bytes (23 KB) starting at (x0 - 1, y0 - 1); for the 1x1 kinds 8 x 16 with
//   no halo.  TMA's zero fill outside the tensor is the convolution's zero
//   padding and masks the ragged edges (W = 66 and 132 are not multiples of
//   16).  Every tap reads its A fragments from that one box with ldmatrix, at
//   rows shifted by the tap's offset under the same XOR swizzle: no per-tap
//   reload.  The box is 180 pixels for 128 outputs, 1.41 input pixels read
//   per output pixel and chunk, against 9 for qc_conv_kernel (the fused
//   3x3's four phases each load the same box).
// * wgmma with A in registers: wgmma.mma_async m64n128k32 .s32.s8.s8, A from
//   the ldmatrix fragments (a warpgroup 64 of the tile's pixels, a warp 16,
//   one tile row), B the tap's 128 output channels x 128 input channels of
//   w_q (KK, C_out, C_in), K-major, through a matrix descriptor of a
//   TMA-loaded, 128-byte-swizzled slot.  Two register sets of A: one
//   k-block's wgmmas run while the next one's fragments load
//   (wgmma.wait_group 1).
// * Thread 0 keeps the loads in flight through mbarrier rings (two halo
//   slots, four weight slots; the parity flips on each wrap), each slot
//   reissued once every warp has freed it.  A producer warp of its own would
//   make the block 288 threads, which the card charges registers as three
//   warpgroups: at the consumers' 122 registers two CTAs would no longer
//   share an SM (and at 16 tile rows the launch failed).
// * Weight traffic: the weights are streamed per (tap, chunk), 16 KB a
//   k-block from L2, 9 x C_in x 128 bytes a tile at 3x3 (147 KB at C_in 128,
//   1152 bytes an output pixel).  Keeping them resident fits only the C_in =
//   128 3x3 (147 KB of the 227 KB, with no room left for the halo ring);
//   C_in 256-512 needs 295 KB-2.4 MB.  So an output pixel's weight reads
//   (1152 bytes a chunk at 3x3) exceed its A reads (180 a chunk); they come
//   from L2 and cost little (k10_profile.py: a copy that skips the reloads
//   after the first four is 3-7% faster at 3x3, no faster at 1x1), and 16
//   tile rows (one CTA an SM, half the weight reads an output) were tried
//   and ran slower than 8 (two CTAs an SM).  What holds the kernel is each
//   CTA's serial chain: ~3 us until its box arrives, the wgmmas waiting on
//   loads that thread 0 can reissue only when both warpgroups have freed a
//   slot, and the epilogue (PERF.md).
// * The epilogue, bit for bit: `dequant` below is qc_conv_kernel's word for
//   word (__int2float_rn, the bf16 rounding, __fmul_rn / __fadd_rn /
//   __fmaf_rn, so nvcc's contraction moves no bit); for bfloat16 output
//   `dequant2_bf16` does the same operations on two channels at once, its
//   roundings one cvt.rn.bf16x2.f32 for the pair.  The CTA's scales and
//   biases are computed once into shared memory while the first loads are
//   in flight.  The accumulators are staged in shared memory (the ring, free
//   once every warp is past its last tap) and written with 16-byte stores, a
//   row of a pixel's channels at a time, with qc_conv_kernel's phase and
//   replicate addressing.  No shared memory written by threads is later read
//   by wgmma or written by TMA (one tile a CTA), so no fence.proxy.async is
//   needed.
//
// The exact int32 sums cannot overflow: 127^2 x 9 x 512 < 2^31.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 8;                       // tile rows: a warp each
constexpr int kCols = 16;                      // tile columns: a warp's 16 A rows
constexpr int kChunk = 128;                    // bytes of C_in a k-block, the swizzle's row
constexpr int BN = 128;                        // output channels a CTA
constexpr int kMaxTaps = 9;
constexpr int kBStages = 4;                    // weight slots
constexpr int kThreads = 256;                  // two warpgroups
constexpr int kBBytes = BN * kChunk;           // a weight slot, 16 KB
constexpr int kOutLds = BN * 4 + 16;           // a staged output row, bytes

// k10_profile.py times the kernel's spans by building it with a header that
// defines QC_PROBE (clock64 and %globaltimer at the points marked below); in
// the port's build the markers are empty.
#ifndef QC_PROBE
#define QC_PROBE(point)
#endif

struct ConvParams {
  void* y;              // (B, Ho, Wo, Cout): int32, bfloat16 or float32
  const float* sw;      // (Cout,)
  const float* sx;      // per-tensor activation scale on the device, or null
  const float* bias;    // (Cout,) or null
  int B, H, W, Cin, Cout;
  int up;               // outputs at (2p + r, 2q + s) of phase 2r + s, else at (p, q)
  int replicate;        // each result written to the 2x2 block of (p, q) (the fused 1x1)
  int out_mode;         // 0 int32 sums, 1 bfloat16, 2 float32
  int round_bf16;       // round float(acc) to bfloat16 first (bfloat16 output)
  int tiles_x, tiles_y, cchunks;
  int lo_y, lo_x;       // the box's origin relative to the tile's
  int box_h, box_w;     // the box, pixels
  int halo_stride;      // bytes a halo slot (1024-aligned)
  int ntaps;
  int off[4][kMaxTaps]; // a tap's pixel offset in the box, per phase
  int t[4][kMaxTaps];   // its packed weight index
};

// ---------------------------------------------------------------------------
// the PTX primitives
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}
// wait until the phase of parity `parity` has completed; a wait of more than
// 10 s traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (i & 1023) == 1023) {
      const uint64_t now = globaltimer_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above wgmma_wait_all
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// the descriptor of a K-major operand of 128-byte rows under the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused), 1024 bytes between
// groups of 8 rows, layout SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define QC_D8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),          \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128 int32 over the warpgroup) += a (64 x 32 int8, registers) * b
// (32 x 128 int8, shared memory, K-major)
__device__ __forceinline__ void wgmma_s8_m64n128k32(int* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : QC_D8(0), QC_D8(8), QC_D8(16), QC_D8(24), QC_D8(32), QC_D8(40), QC_D8(48), QC_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef QC_D8

// ---------------------------------------------------------------------------
// the epilogue's arithmetic: csrc/qconv.cu's, word for word
// ---------------------------------------------------------------------------
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the epilogue of one sum: its bits for int32 output, else the dequantized value
__device__ __forceinline__ float dequant(const ConvParams& p, int acc, float scale, float bias) {
  float a = __int2float_rn(acc);
  if (p.round_bf16) a = round_bf16(a);
  if (p.out_mode == 1) {
    a = round_bf16(__fmul_rn(a, scale));
    if (p.bias != nullptr) a = round_bf16(__fadd_rn(a, bias));
    return a;
  }
  return p.bias != nullptr ? __fmaf_rn(a, scale, bias) : __fmul_rn(a, scale);
}

// two sums of adjacent channels to bfloat16 (out_mode 1): dequant's
// operations on each, its bfloat16 roundings done two at a time (one
// cvt.rn.bf16x2.f32 for two, where dequant spends one cvt a value and the
// store one more for the pair; conversions issue at 16 a clock per SM), the
// last of them the packed result
__device__ __forceinline__ __nv_bfloat162 dequant2_bf16(const ConvParams& p, int acc0, int acc1,
                                                      float s0, float s1, float b0, float b1) {
  float a0 = __int2float_rn(acc0), a1 = __int2float_rn(acc1);
  if (p.round_bf16) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(a0, a1);
    a0 = __low2float(r);
    a1 = __high2float(r);
  }
  __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(a0, s0), __fmul_rn(a1, s1));
  if (p.bias != nullptr)
    r = __floats2bfloat162_rn(__fadd_rn(__low2float(r), b0), __fadd_rn(__high2float(r), b1));
  return r;
}

// ---------------------------------------------------------------------------
// the kernel: a CTA a tile of 8 x 16 pixels and 128 output channels
// ---------------------------------------------------------------------------
// registers: the accumulators (64 a thread) and two taps' A fragments (2 x
// 16) stay in registers while the wgmmas run; at 112 ptxas spilled and
// serialized the wgmmas (C7512).  128 x 256 threads lets two CTAs share an SM.
// (A block of 288 threads, a producer warp beside the two warpgroups, is
// charged registers as three warpgroups, so thread 0 issues the loads.)
__global__ void __maxnreg__(128)
    qc_conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const ConvParams p) {
  QC_PROBE(entry);
  constexpr int kM = kRows * kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 + 2 * kBStages];
  __shared__ int s_off[kMaxTaps];
  __shared__ float s_scale[BN], s_bias[BN];

  // the ring (and then the staged output) at a 1024-byte boundary, as the
  // 128-byte swizzle's pattern needs
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t halo0 = base, bslot0 = base + 2 * p.halo_stride;
  const uint32_t bar0 = smem_u32(bars);
  auto full_h = [&](int i) { return bar0 + 8u * i; };
  auto empty_h = [&](int i) { return bar0 + 8u * (2 + i); };
  auto full_b = [&](int i) { return bar0 + 8u * (4 + i); };
  auto empty_b = [&](int i) { return bar0 + 8u * (4 + kBStages + i); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int phase = blockIdx.z, n0 = blockIdx.y * BN;
  int tile = blockIdx.x;
  const int tx = tile % p.tiles_x;
  tile /= p.tiles_x;
  const int ty = tile % p.tiles_y;
  const int b = tile / p.tiles_y;
  const int x0 = tx * kCols, y0 = ty * kRows;

  if (tid < p.ntaps) s_off[tid] = p.off[phase][tid];

  // k-block q = chunk * ntaps + tap: the tap's weight slice into slot
  // q % kBStages and, at a chunk's first tap, the chunk's box into halo slot
  // chunk % 2.  Thread 0 issues them in order, each once its slots are free:
  // the weight slot once k-block q - kBStages is done, the halo slot once
  // chunk - 2 is; `done` is the last k-block this warp has released.
  const int ntaps = p.ntaps, nkb = p.cchunks * ntaps;
  const uint32_t hbytes = (uint32_t)(p.box_h * p.box_w * kChunk);
  int next = 0;
  auto ready = [&](int q, int done) {
    if (q >= nkb || q - kBStages > done) return false;
    const int c = q / ntaps;
    return q != c * ntaps || (c - 1) * ntaps - 1 <= done;
  };
  auto issue = [&](int q) {
    const int c = q / ntaps, k = q - c * ntaps;
    if (k == 0) {
      mbar_wait(empty_h(c & 1), ((c >> 1) & 1) ^ 1);
      mbar_expect_tx(full_h(c & 1), hbytes);
      tma_load_4d(halo0 + (c & 1) * p.halo_stride, &xmap, full_h(c & 1), c * kChunk,
                  x0 + p.lo_x, y0 + p.lo_y, b);
    }
    const int bs = q % kBStages;
    mbar_wait(empty_b(bs), ((q / kBStages) & 1) ^ 1);
    mbar_expect_tx(full_b(bs), kBBytes);
    tma_load_2d(bslot0 + bs * kBBytes, &wmap, full_b(bs), c * kChunk, p.t[phase][k] * p.Cout + n0);
  };

  // thread 0 sets the barriers up and starts the first loads at once; the
  // epilogue's scale and bias of channels n0 + tid (as qc_conv_kernel's)
  // follow while they are in flight
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_h(i), 1);
      mbar_init(empty_h(i), kThreads / 32);
    }
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(full_b(i), 1);
      mbar_init(empty_b(i), kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    while (ready(next, -1)) issue(next++);
  }
  __syncthreads();
  if (tid < BN) {
    const int n = n0 + tid;
    float sc = 0.0f, bi = 0.0f;
    if (p.out_mode != 0) {
      sc = p.sx != nullptr ? __fmul_rn(*p.sx, p.sw[n]) : p.sw[n];
      if (p.bias != nullptr) bi = p.bias[n];
      if (p.out_mode == 1) {
        sc = round_bf16(sc);
        bi = round_bf16(bi);
      }
    }
    s_scale[tid] = sc;
    s_bias[tid] = bi;
  }

  // warpgroup wg holds tile rows wg * 4 + w of its warps w, a warp one row
  // of 16 pixels (its A rows, ldmatrix's lane & 15)
  const int wg = warp >> 2, w = warp & 3;
  const int pix = (wg * 4 + w) * p.box_w + (lane & 15), khalf = lane >> 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  // k-block q's A fragments, from its chunk's box at the tap's offset
  auto load_a = [&](uint32_t(&a)[4][4], int q) {
    QC_PROBE(load);
    const int c = q / ntaps, k = q - c * ntaps;
    if (k == 0) mbar_wait(full_h(c & 1), (c >> 1) & 1);
    QC_PROBE(box);
    const int px = pix + s_off[k];
    const uint32_t row = halo0 + (c & 1) * p.halo_stride + (uint32_t)px * kChunk;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(a[ks], row + (((2 * ks + khalf) ^ (px & 7)) << 4));
    QC_PROBE(lda);
  };
  // its four wgmmas, one commit group
  auto mma = [&](const uint32_t(&a)[4][4], int q) {
    const int bs = q % kBStages;
    mbar_wait(full_b(bs), (q / kBStages) & 1);
    QC_PROBE(slice);
    const uint64_t desc = sw128_desc(bslot0 + bs * kBBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_s8_m64n128k32(acc, a[ks], desc + 2 * ks);
    wgmma_commit();
    QC_PROBE(issue);
  };
  // k-block q's wgmmas have completed: free its slots, issue what they allow
  auto release = [&](int q) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_b(q % kBStages));
      if ((q + 1) % ntaps == 0) mbar_arrive(empty_h((q / ntaps) & 1));
    }
    if (tid == 0)
      while (ready(next, q)) issue(next++);
    __syncwarp();
    QC_PROBE(release);
  };

  // two register sets of A: a group of wgmmas runs while the next k-block's
  // fragments load (wait_group 1 keeps the newest group in flight)
  uint32_t a0[4][4], a1[4][4];
  load_a(a0, 0);
  QC_PROBE(first);
  for (int q = 0; q < nkb; q += 2) {
    mma(a0, q);
    wgmma_wait<1>();
    QC_PROBE(wait);
    if (q > 0) release(q - 1);
    if (q + 1 < nkb) {
      load_a(a1, q + 1);
      mma(a1, q + 1);
      wgmma_wait<1>();
      QC_PROBE(wait);
      release(q);
      if (q + 2 < nkb) load_a(a0, q + 2);
    } else {
      wgmma_wait<0>();
      QC_PROBE(wait);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
  QC_PROBE(main);

  // epilogue: every warp past its last tap, the ring becomes the output tile
  // (rows of kOutLds bytes, pixel m = tile row * 16 + column), then written
  // out a row of 128 channels at a time
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
  const int esize = p.out_mode == 1 ? 2 : 4;
  uint8_t* sO = sbase;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * t4;
    const float scale[2] = {s_scale[c], s_scale[c + 1]}, bias[2] = {s_bias[c], s_bias[c + 1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int m = (wg * 4 + w) * kCols + g + 8 * h;
        uint8_t* dst = sO + m * kOutLds + c * esize;
        const int* a2 = &acc[4 * j + 2 * h];
        if (p.out_mode == 0) {
          *reinterpret_cast<int2*>(dst) = make_int2(a2[0], a2[1]);
        } else if (p.out_mode == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              dequant2_bf16(p, a2[0], a2[1], scale[0], scale[1], bias[0], bias[1]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(dequant(p, a2[0], scale[0], bias[0]),
                                                        dequant(p, a2[1], scale[1], bias[1]));
        }
      }
  }
  __syncthreads();
  QC_PROBE(staged);
  const int Ho = p.up ? 2 * p.H : p.H, Wo = p.up ? 2 * p.W : p.W;
  const int nrep = p.replicate ? 4 : 1;
  // 16 bytes a thread where the rows allow it, else an element
  const int unit = ((p.Cout * esize) % 16 == 0 && (uintptr_t)p.y % 16 == 0) ? 16 : esize;
  const int per_row = BN * esize / unit;
  for (int e = tid; e < kM * per_row; e += kThreads) {
    const int r = e / per_row, off = (e - r * per_row) * unit;
    const int yy = y0 + r / kCols, xx = x0 + r % kCols;
    if (yy >= p.H || xx >= p.W) continue;
    const uint8_t* src = sO + r * kOutLds + off;
    for (int rep = 0; rep < nrep; ++rep) {
      const int oy = p.up ? 2 * yy + (p.replicate ? rep >> 1 : phase >> 1) : yy;
      const int ox = p.up ? 2 * xx + (p.replicate ? rep & 1 : phase & 1) : xx;
      uint8_t* dst = reinterpret_cast<uint8_t*>(p.y) +
                     ((((size_t)b * Ho + oy) * Wo + ox) * p.Cout + n0) * esize + off;
      if (unit == 16) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if (unit == 4) *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
      else *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
    }
  }
  QC_PROBE(end);
}

// ---------------------------------------------------------------------------
// the tensor maps: cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (the library is built without -lcuda)
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// an int8 tensor map of `rank` dims (innermost first), 128-byte swizzle, zero fill
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const ConvParams& p, int phases,
           int smem, cudaStream_t stream) {
  static int smem_set = 0;
  if (smem > smem_set) {
    int err = (int)cudaFuncSetAttribute((const void*)qc_conv_sm90_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == 0)   // two CTAs an SM need the largest shared-memory carveout
      err = (int)cudaFuncSetAttribute((const void*)qc_conv_sm90_kernel,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
    if (err != 0) return err;
    smem_set = smem;
  }
  const long long gx = (long long)p.B * p.tiles_y * p.tiles_x;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, p.Cout / BN, phases);
  qc_conv_sm90_kernel<<<grid, kThreads, smem, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point; returns the launch's cudaError_t
// ---------------------------------------------------------------------------

// x (B, H, W, Cin) int8, w (KK, Cout, Cin) int8 -> y (B, Ho, Wo, Cout), as
// csrc/qconv.cu's qc_conv, with C_in % 128 == 0 and C_out % 128 == 0.  plan
// (ops/qconv.py::halo_plan): tile rows (8), the box's origin relative
// to the tile (lo_y, lo_x) and size (box_h, box_w), then per phase and tap
// (pixel offset in the box, packed weight index).
extern "C" int qc_conv_sm90(const int8_t* x, const int8_t* w, void* y, const float* sw,
                            const float* sx, const float* bias, int B, int H, int W, int Cin,
                            int Cout, int up, int replicate, int phases, int ntaps,
                            const int* plan, int out_mode, int round_bf16, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < kChunk || Cin % kChunk != 0 || Cout < BN ||
      Cout % BN != 0 || ntaps < 1 || ntaps > kMaxTaps || (phases != 1 && phases != 4) ||
      (phases == 4 && !up) || (replicate && (!up || phases != 1)) || out_mode < 0 ||
      out_mode > 2 || (out_mode != 0 && sw == nullptr) || plan == nullptr ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = plan[0], lo_y = plan[1], lo_x = plan[2], box_h = plan[3], box_w = plan[4];
  if (rows != kRows || box_h < rows || box_w < kCols || box_h > 256 || box_w > 256)
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.y = y;
  p.sw = sw;
  p.sx = sx;
  p.bias = bias;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.up = up;
  p.replicate = replicate;
  p.out_mode = out_mode;
  p.round_bf16 = round_bf16;
  p.tiles_x = (W + kCols - 1) / kCols;
  p.tiles_y = (H + rows - 1) / rows;
  p.cchunks = Cin / kChunk;
  p.lo_y = lo_y;
  p.lo_x = lo_x;
  p.box_h = box_h;
  p.box_w = box_w;
  const int halo_bytes = box_h * box_w * kChunk;
  p.halo_stride = (halo_bytes + 1023) & ~1023;
  p.ntaps = ntaps;
  for (int ph = 0; ph < 4; ++ph)
    for (int k = 0; k < kMaxTaps; ++k) {
      const bool in = ph < phases && k < ntaps;
      const int* e = plan + 5 + 2 * (ph * ntaps + k);
      p.off[ph][k] = in ? e[0] : 0;
      p.t[ph][k] = in ? e[1] : 0;
      // every pixel the tap reads lies inside the box, in the row it shifts to
      if (in && (e[0] < 0 || e[0] % box_w + kCols > box_w ||
                 e[0] + (rows - 1) * box_w + kCols - 1 >= box_h * box_w || e[1] < 0))
        return (int)cudaErrorInvalidValue;
    }
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin, (cuuint64_t)W * Cin, (cuuint64_t)H * W * Cin};
  const cuuint32_t xbox[4] = {kChunk, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  int kk = 0;
  for (int i = 0; i < phases * ntaps; ++i) kk = plan[6 + 2 * i] + 1 > kk ? plan[6 + 2 * i] + 1 : kk;
  const cuuint64_t wdims[2] = {(cuuint64_t)Cin, (cuuint64_t)kk * Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)Cin};
  const cuuint32_t wbox[2] = {kChunk, BN};
  if (!encode(&xmap, x, 4, xdims, xstrides, xbox) || !encode(&wmap, w, 2, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int ring = 2 * p.halo_stride + kBStages * kBBytes;
  const int staged = rows * kCols * kOutLds;
  const int smem = 1024 + (ring > staged ? ring : staged);
  return launch(xmap, wmap, p, phases, smem, stream);
}
