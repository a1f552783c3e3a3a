// K10 — int8 convolution with int32 accumulation on the tensor cores, and the
// activation and weight quantization around it.
//
// Replaces buddy_tpu/ops/qconv.py: _quantize_act (:65), _quantize_w (:81),
// _int8_conv (:97) and the dequant epilogue of quantized_conv (:108-136),
// which XLA lowered onto the TPU's matrix unit.  With lhs_dilation (2, 2) the
// same op serves the fused nearest-up2 convolutions of the up-ResBlocks
// (buddy_tpu/models/layers.py:163-186, K8 with K10): here those are four
// output phases of the half-resolution input, each a 2x2 (the derived 4x4
// kernel, pads 2) or a 1x1 (the derived 2x2, pads 1) convolution.
//
// Arithmetic, as the JAX package's under jit on the CPU (ops/qconv.py holds
// the plain versions and says why each step is what it is):
//   s = fma(max|v|, fl(1/127), 1e-12)        XLA's max / 127 + eps
//   x_q = clamp(rint(fl_T(x * fl_T(1 / s_x))), -127, 127), T = x's dtype
//   w_q = clamp(rint(w32 / s_w), -127, 127),  w32 = w (* s_x per input channel)
//   y = fl_T(fl_T(float(acc)) * fl_T(scale)) + fl_T(b)     bfloat16 output
//   y = fma(float(acc), scale, b)                          float32 output
// with acc the exact int32 sum in every accumulation mode (XLA sums int8
// products exactly and, with float32 activations, drops the "bfloat16"
// mode's rounding of the sum, so the three modes give the same bits).
//
// What bounds it on the H100: operations.  At the U-Net's shapes a
// convolution does 2 * taps * C_in MACs per output element against a few
// bytes, far above the card's int8 ridge (~590 operations a byte at 1979
// TOP/s and 3.35 TB/s).  The design is a first, simple implicit GEMM:
// M = output pixels of one phase, N = C_out, K = taps x C_in; CTA tiles of
// 128 x 128 x 64 bytes, four k-steps in flight through cp.async
// (zero-filled outside the image and past C_in), eight warps of 32 x 64,
// ldmatrix.x4 fragments from rows padded to 80 bytes (no bank conflicts)
// and mma.sync.m16n8k32.s32.s8.s8.s32; the epilogue stages the tile in
// shared memory and writes each pixel's channels with 16-byte stores.  A
// wgmma/TMA design is later work.
//
// The activation quantization is bytes-bound: the dynamic form is two
// launches (per-CTA partial maxima, then the quantize pass, whose CTAs
// reduce the partials in a fixed order in their prologue: no atomics), the
// static form one.  Weights are quantized by one launch (a CTA an output
// channel), once per weight version (the conv modules keep them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQThreads = 256;      // quantization kernels
constexpr int kConvThreads = 256;   // conv kernel: 8 warps, 4 along M x 2 along N
constexpr int BM = 128, BN = 128, BK = 64, LDS = 80;   // tile, bytes a k-step, smem row
constexpr int kMaxTaps = 9;
constexpr int kStages = 4;                          // k-steps in flight
constexpr int kOutLds = BN * 4 + 16;                  // a staged output row, bytes
constexpr int kConvSmem = kStages * (BM + BN) * LDS > BM * kOutLds ? kStages * (BM + BN) * LDS
                                                                    : BM * kOutLds;

// ---------------------------------------------------------------------------
// the PTX primitives (the tests' CPU emulation supplies its own)
// ---------------------------------------------------------------------------
#ifndef QCONV_EMULATION
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// ---------------------------------------------------------------------------
// arithmetic shared by the kernels
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a value rounded to the element type T
template <class T> __device__ __forceinline__ float fl(float v);
template <> __device__ __forceinline__ float fl<float>(float v) { return v; }
template <> __device__ __forceinline__ float fl<bf16>(float v) { return round_bf16(v); }

// XLA's max / 127 + eps: a multiply by the rounded reciprocal, fused with the add
__device__ __forceinline__ float scale_from_max(float m) {
  return __fmaf_rn(m, __fdiv_rn(1.0f, 127.0f), 1e-12f);
}
__device__ __forceinline__ float clamp127(float r) { return fminf(fmaxf(r, -127.0f), 127.0f); }

// max over the CTA of values >= 0 (their bits order as unsigned ints), to every thread
__device__ float block_max(float v) {
  __shared__ float warp_max[32];
  const unsigned u = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = __uint_as_float(u);
  __syncthreads();
  float m = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, warp_max[i]);
  __syncthreads();
  return m;
}

// ---------------------------------------------------------------------------
// activations: partial maxima, then the quantize pass
// ---------------------------------------------------------------------------
template <class T> struct Vec;                       // 16 bytes of T in, V bytes of int8 out
template <> struct Vec<float> { static constexpr int V = 4; typedef unsigned Out; };
template <> struct Vec<bf16> { static constexpr int V = 8; typedef uint2 Out; };

template <class T>
__global__ void __launch_bounds__(kQThreads)
    qc_absmax_kernel(const T* __restrict__ x, long long n, int vec, float* __restrict__ part) {
  constexpr int V = Vec<T>::V;
  const long long stride = (long long)gridDim.x * kQThreads;
  const long long start = (long long)blockIdx.x * kQThreads + threadIdx.x;
  const long long nv = vec ? n / V : 0;
  float m = 0.0f;
  for (long long i = start; i < nv; i += stride) {
    const uint4 q = reinterpret_cast<const uint4*>(x)[i];
    const T* h = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(to_float(h[e])));
  }
  for (long long i = nv * V + start; i < n; i += stride) m = fmaxf(m, fabsf(to_float(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// inv = fl_T(1 / s), as (1.0 / s_x).astype(x.dtype)
template <class T> __device__ __forceinline__ float inverse(float s) {
  return fl<T>(__fdiv_rn(1.0f, s));
}
template <class T> __device__ __forceinline__ int8_t quantize(float v, float inv) {
  return (int8_t)(int)clamp127(rintf(fl<T>(__fmul_rn(v, inv))));
}

// sx: the static scale (a scalar, or C of them when per_channel); part: the
// partial maxima of the dynamic form (nparts of them; sx is then unused and
// the scale goes to sx_out)
template <class T>
__global__ void __launch_bounds__(kQThreads)
    qc_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, long long n, int C,
                       int vec, const float* __restrict__ sx, int per_channel,
                       const float* __restrict__ part, int nparts, float* __restrict__ sx_out) {
  extern __shared__ __align__(16) float inv_c[];
  __shared__ float inv_s;
  if (part != nullptr) {
    float m = 0.0f;
    for (int i = threadIdx.x; i < nparts; i += kQThreads) m = fmaxf(m, part[i]);
    m = block_max(m);
    if (threadIdx.x == 0) {
      const float s = scale_from_max(m);
      inv_s = inverse<T>(s);
      if (blockIdx.x == 0) *sx_out = s;
    }
  } else if (!per_channel) {
    if (threadIdx.x == 0) inv_s = inverse<T>(*sx);
  } else {
    for (int c = threadIdx.x; c < C; c += kQThreads) inv_c[c] = inverse<T>(sx[c]);
  }
  __syncthreads();
  constexpr int V = Vec<T>::V;
  const long long stride = (long long)gridDim.x * kQThreads;
  const long long start = (long long)blockIdx.x * kQThreads + threadIdx.x;
  const long long nv = vec ? n / V : 0;
  for (long long i = start; i < nv; i += stride) {
    const uint4 q = reinterpret_cast<const uint4*>(x)[i];
    const T* h = reinterpret_cast<const T*>(&q);
    const int c0 = (int)((i * V) % C);
    typename Vec<T>::Out o;
    int8_t* b = reinterpret_cast<int8_t*>(&o);
#pragma unroll
    for (int e = 0; e < V; ++e) b[e] = quantize<T>(to_float(h[e]), per_channel ? inv_c[c0 + e] : inv_s);
    reinterpret_cast<typename Vec<T>::Out*>(xq)[i] = o;
  }
  for (long long i = nv * V + start; i < n; i += stride)
    xq[i] = quantize<T>(to_float(x[i]), per_channel ? inv_c[i % C] : inv_s);
}

// ---------------------------------------------------------------------------
// weights: a CTA an output channel; w (O, I, KK) float32 -> wq (KK, O, I)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float weight_value(const float* wo, const float* in_scale, int e,
                                              int KK) {
  return in_scale != nullptr ? __fmul_rn(wo[e], in_scale[e / KK]) : wo[e];
}

__global__ void __launch_bounds__(kQThreads)
    qc_weight_kernel(const float* __restrict__ w, const float* __restrict__ in_scale,
                     int8_t* __restrict__ wq, float* __restrict__ sw, int O, int I, int KK) {
  __shared__ float s_w;
  const int o = blockIdx.x;
  const float* wo = w + (size_t)o * I * KK;
  float m = 0.0f;
  for (int e = threadIdx.x; e < I * KK; e += kQThreads)
    m = fmaxf(m, fabsf(weight_value(wo, in_scale, e, KK)));
  m = block_max(m);
  if (threadIdx.x == 0) {
    s_w = scale_from_max(m);
    sw[o] = s_w;
  }
  __syncthreads();
  const float s = s_w;
  for (int e = threadIdx.x; e < I * KK; e += kQThreads) {
    const int i = e / KK, kk = e - i * KK;
    wq[((size_t)kk * O + o) * I + i] =
        (int8_t)(int)clamp127(rintf(__fdiv_rn(weight_value(wo, in_scale, e, KK), s)));
  }
}

// ---------------------------------------------------------------------------
// the convolution: implicit GEMM, int8 x int8 -> int32, dequant epilogue
// ---------------------------------------------------------------------------
struct Taps {
  int n;                              // taps a phase
  int dy[4][kMaxTaps], dx[4][kMaxTaps], t[4][kMaxTaps];   // input offset, packed weight index
};

struct ConvParams {
  const int8_t* x;      // (B, H, W, Cin)
  const int8_t* w;      // (KK, Cout, Cin)
  void* y;              // (B, Ho, Wo, Cout): int32, bfloat16 or float32
  const float* sw;      // (Cout,)
  const float* sx;      // per-tensor activation scale on the device, or null (static per-channel)
  const float* bias;    // (Cout,) or null
  int B, H, W, Cin, Cout;
  int up;               // outputs at (2p + r, 2q + s) of phase 2r + s, else at (p, q)
  int replicate;        // each result written to the 2x2 block of (p, q) (the fused 1x1)
  int cchunks;          // ceil(Cin / BK)
  int out_mode;         // 0 int32 sums, 1 bfloat16, 2 float32
  int round_bf16;       // round float(acc) to bfloat16 first (bfloat16 output)
  int vec;              // Cin % 16 == 0: 16-byte cp.async rows
  Taps taps;
};

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

__global__ void __launch_bounds__(kConvThreads, 2) qc_conv_kernel(const ConvParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sA = smem;                                 // kStages x BM rows of LDS bytes
  uint8_t* sB = smem + kStages * BM * LDS;            // kStages x BN rows
  __shared__ int tap_dy[kMaxTaps];
  __shared__ int tap_dx[kMaxTaps];
  __shared__ int tap_t[kMaxTaps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int phase = blockIdx.z;
  if (tid < p.taps.n) {
    tap_dy[tid] = p.taps.dy[phase][tid];
    tap_dx[tid] = p.taps.dx[phase][tid];
    tap_t[tid] = p.taps.t[phase][tid];
  }
  const long long HW = (long long)p.H * p.W, M = p.B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the loader: rows lr and lr + 64 of each tile, 16 bytes at byte lc of the k-step
  const int lr = tid >> 2, lc = (tid & 3) * 16;
  int rb[2], ry[2], rx[2];
  bool rin[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long m = m0 + lr + 64 * j;
    rin[j] = m < M;
    const long long mm = rin[j] ? m : 0;
    rb[j] = (int)(mm / HW);
    const int rem = (int)(mm - rb[j] * HW);
    ry[j] = rem / p.W;
    rx[j] = rem - ry[j] * p.W;
  }
  __syncthreads();   // the tap table

  const int ksteps = p.taps.n * p.cchunks;
  auto load = [&](int stage, int ks) {
    const int tap = ks / p.cchunks, c = (ks - tap * p.cchunks) * BK + lc;
    const int dy = tap_dy[tap], dx = tap_dx[tap], t = tap_t[tap];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int yy = ry[j] + dy, xx = rx[j] + dx;
      const bool ok = rin[j] && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W && c < p.Cin;
      const int8_t* src = ok ? p.x + (((long long)rb[j] * p.H + yy) * p.W + xx) * p.Cin + c : p.x;
      uint8_t* dst = sA + (stage * BM + lr + 64 * j) * LDS + lc;
      if (p.vec) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        int4 v = make_int4(0, 0, 0, 0);
        int8_t* b = reinterpret_cast<int8_t*>(&v);
        for (int e = 0; e < 16; ++e) b[e] = (ok && c + e < p.Cin) ? src[e] : (int8_t)0;
        *reinterpret_cast<int4*>(dst) = v;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + lr + 64 * j;
      const bool ok = n < p.Cout && c < p.Cin;
      const int8_t* src = ok ? p.w + ((long long)t * p.Cout + n) * p.Cin + c : p.w;
      uint8_t* dst = sB + (stage * BN + lr + 64 * j) * LDS + lc;
      if (p.vec) {
        cp_async16(dst, src, ok ? 16 : 0);
      } else {
        int4 v = make_int4(0, 0, 0, 0);
        int8_t* b = reinterpret_cast<int8_t*>(&v);
        for (int e = 0; e < 16; ++e) b[e] = (ok && c + e < p.Cin) ? src[e] : (int8_t)0;
        *reinterpret_cast<int4*>(dst) = v;
      }
    }
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // k-steps 0 .. kStages - 2 in flight; then each iteration waits for its
  // k-step, refills the stage the previous iteration read and computes
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ksteps) load(st, st);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ks + kStages - 1 < ksteps) load((ks + kStages - 1) % kStages, ks + kStages - 1);
    cp_async_commit();
    const int stage = ks % kStages;
    const uint8_t* a_base = sA + stage * BM * LDS;
    const uint8_t* b_base = sB + stage * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], a_base + (wm + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned r[4];
        ldmatrix_x4(r, b_base + (wn + jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS + kk +
                           ((lane >> 3) & 1) * 16);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the pipeline's shared memory becomes the output tile

  // epilogue: the tile dequantized into shared memory (rows of kOutLds
  // bytes), then written out a row of C_out channels at a time
  const int g = lane >> 2, t4 = lane & 3;
  const int esize = p.out_mode == 1 ? 2 : 4;
  uint8_t* sO = smem;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float scale[2], bias[2];
    const int c = wn + j * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + c + e;
      float sc = 0.0f, bi = 0.0f;
      if (n < p.Cout && p.out_mode != 0) {
        sc = p.sx != nullptr ? __fmul_rn(*p.sx, p.sw[n]) : p.sw[n];
        if (p.bias != nullptr) bi = p.bias[n];
        if (p.out_mode == 1) {
          sc = round_bf16(sc);
          bi = round_bf16(bi);
        }
      }
      scale[e] = sc;
      bias[e] = bi;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* dst = sO + (wm + i * 16 + g + 8 * h) * kOutLds + c * esize;
        const int* a2 = &acc[i][j][2 * h];
        if (p.out_mode == 0) {
          *reinterpret_cast<int2*>(dst) = make_int2(a2[0], a2[1]);
        } else if (p.out_mode == 1) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              dequant(p, a2[0], scale[0], bias[0]), dequant(p, a2[1], scale[1], bias[1]));
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(dequant(p, a2[0], scale[0], bias[0]),
                                                        dequant(p, a2[1], scale[1], bias[1]));
        }
      }
  }
  __syncthreads();
  const int Ho = p.up ? 2 * p.H : p.H, Wo = p.up ? 2 * p.W : p.W;
  const int ncols = p.Cout - n0 < BN ? p.Cout - n0 : BN;
  const int nrep = p.replicate ? 4 : 1;
  // 16 bytes a thread where the rows allow it, else an element
  const int unit = ((ncols * esize) % 16 == 0 && (p.Cout * esize) % 16 == 0 &&
                    (uintptr_t)p.y % 16 == 0) ? 16 : esize;
  const int per_row = ncols * esize / unit;
  for (int e = tid; e < BM * per_row; e += kConvThreads) {
    const int r = e / per_row, off = (e - r * per_row) * unit;
    const long long m = m0 + r;
    if (m >= M) break;
    const int b = (int)(m / HW);
    const int rem = (int)(m - b * HW);
    const int yy = rem / p.W, xx = rem - yy * p.W;
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
}

// CTAs of a quantization pass: 8 vectors a thread, at most kMaxQCtas (the
// grid strides over the rest), so that the dynamic form's partials stay few
constexpr int kMaxQCtas = 1024;
int quant_ctas(long long n) {
  const long long b = (n + 8LL * 8 * kQThreads - 1) / (8LL * 8 * kQThreads);
  return (int)(b < 1 ? 1 : (b > kMaxQCtas ? kMaxQCtas : b));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points; each returns the launch's cudaError_t
// ---------------------------------------------------------------------------

// partial maxima of |x| (n elements), one a CTA: the count of CTAs to allocate for
extern "C" int qc_absmax_parts(long long n) { return quant_ctas(n); }

// x (n elements, channel = index % C) -> xq int8.  Dynamic (sx == null): two
// launches, the partial maxima into part (qc_absmax_parts(n) floats), then the
// quantize pass, whose scale goes to sx_out.  Static: sx holds one scale, or C
// when per_channel.
extern "C" int qc_quantize(const void* x, int8_t* xq, long long n, int C, int is_bf16,
                           const float* sx, int per_channel, float* part, float* sx_out,
                           cudaStream_t stream) {
  if (n < 1 || C < 1 || C > 8192 || (sx == nullptr && (part == nullptr || sx_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int V = is_bf16 ? 8 : 4;
  const int vec = (C % V == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)xq % V == 0);
  const int nparts = qc_absmax_parts(n);
  if (sx == nullptr) {
    if (is_bf16)
      qc_absmax_kernel<bf16><<<nparts, kQThreads, 0, stream>>>(
          reinterpret_cast<const bf16*>(x), n, vec, part);
    else
      qc_absmax_kernel<float><<<nparts, kQThreads, 0, stream>>>(
          reinterpret_cast<const float*>(x), n, vec, part);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int grid = quant_ctas(n);
  const size_t smem = per_channel ? (size_t)C * sizeof(float) : 0;
  const float* pp = sx == nullptr ? part : nullptr;
  if (is_bf16)
    qc_quantize_kernel<bf16><<<grid, kQThreads, smem, stream>>>(
        reinterpret_cast<const bf16*>(x), xq, n, C, vec, sx, per_channel, pp, nparts, sx_out);
  else
    qc_quantize_kernel<float><<<grid, kQThreads, smem, stream>>>(
        reinterpret_cast<const float*>(x), xq, n, C, vec, sx, per_channel, pp, nparts, sx_out);
  return (int)cudaGetLastError();
}

// w (O, I, KK) float32 [* in_scale (I,)] -> wq (KK, O, I) int8 and sw (O,)
extern "C" int qc_weight(const float* w, const float* in_scale, int8_t* wq, float* sw, int O,
                         int I, int KK, cudaStream_t stream) {
  if (O < 1 || I < 1 || KK < 1) return (int)cudaErrorInvalidValue;
  qc_weight_kernel<<<O, kQThreads, 0, stream>>>(w, in_scale, wq, sw, O, I, KK);
  return (int)cudaGetLastError();
}

// x (B, H, W, Cin) int8, w (KK, Cout, Cin) int8 -> y (B, Ho, Wo, Cout).  taps:
// phases x ntaps x (dy, dx, t); phases is 1, or 4 with up (outputs at
// (2p + r, 2q + s)); replicate writes each result of one phase to the 2x2 block.
extern "C" int qc_conv(const int8_t* x, const int8_t* w, void* y, const float* sw, const float* sx,
                       const float* bias, int B, int H, int W, int Cin, int Cout, int up,
                       int replicate, int phases, int ntaps, const int* taps, int out_mode,
                       int round_bf16, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cout % 2 != 0 || ntaps < 1 ||
      ntaps > kMaxTaps || (phases != 1 && phases != 4) || (phases == 4 && !up) ||
      (replicate && (!up || phases != 1)) || out_mode < 0 || out_mode > 2 ||
      (out_mode != 0 && sw == nullptr))
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.x = x;
  p.w = w;
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
  p.cchunks = (Cin + BK - 1) / BK;
  p.out_mode = out_mode;
  p.round_bf16 = round_bf16;
  p.vec = (Cin % 16 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0);
  p.taps.n = ntaps;
  for (int ph = 0; ph < 4; ++ph)
    for (int k = 0; k < kMaxTaps; ++k) {
      const bool in = ph < phases && k < ntaps;
      const int* e = taps + 3 * (ph * ntaps + k);
      p.taps.dy[ph][k] = in ? e[0] : 0;
      p.taps.dx[ph][k] = in ? e[1] : 0;
      p.taps.t[ph][k] = in ? e[2] : 0;
    }
  const long long M = (long long)B * H * W;
  const long long gx = (M + BM - 1) / BM;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const int err = (int)cudaFuncSetAttribute((const void*)qc_conv_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              kConvSmem);
    if (err != 0) return err;
    smem_set = true;
  }
  const dim3 grid((unsigned)gx, (Cout + BN - 1) / BN, phases);
  qc_conv_kernel<<<grid, kConvThreads, kConvSmem, stream>>>(p);
  return (int)cudaGetLastError();
}
