// K11 — FIR resampling (upfirdn), the forward pass and its input vjp.
//
// Replaces buddy_tpu/ops/resample.py::upfirdn2d (:33) and ::upfirdn1d (:94),
// which the JAX package writes as one lhs-dilated depthwise XLA convolution
// (no Pallas kernel: XLA's convolution served on the TPU), and which the
// port ran on the card as depthwise library convolutions (a transposed
// convolution of stride `up`, a strided convolution) at 4-6% of their byte
// bound.  It computes, per channel and per spatial axis: zero insertion by
// `up` (H up samples, the up - 1 trailing zeros included), padding by
// (pad0, pad1) (negative pads crop), a true convolution with the FIR kernel
// (flipped relative to correlation), every `down`-th sample.  The input vjp
// is the same function with up and down swapped, the kernel flipped and
// pad0 = taps - 1 - pad0 (ops/resample.py derives it), so one kernel serves
// both directions.
//
// Layout: x (B, H, W, C) and y (B, OH, OW, C) contiguous: an NCHW tensor in
// channels_last memory, or an NCHW-contiguous one read as B * C images of
// one channel.  Each thread moves 16 bytes (4 channels) where C is a
// multiple of 4 and both pointers are 16-byte aligned, else one float.
//
// What bounds it on the H100: bytes.  A pass does ceil(kh / up) x
// ceil(kw / up) multiply-adds an output value (4 at the U-Net's up x2, 16
// at its down x2), far below the card's ridge, so the least time is the
// input read once and the output written once over 3.35 TB/s.  Design:
//   * a CTA owns a tile of TY x TX output pixels and a chunk of channels; it
//     stages the input pixels that tile reaches (its footprint plus the
//     halo) in shared memory once, with cp.async, 16 bytes a thread,
//     neighbouring threads on neighbouring channels, and zeros where the
//     footprint leaves the image (the padding);
//   * each output value sums only the taps that meet a nonzero input
//     (polyphase: its first tap follows from its phase, the next ones are
//     `up` apart), read from the staged tile; the zero-stuffed grid is
//     never formed;
//   * a thread keeps one channel vector and one column of the tile and
//     walks its rows, so its column's phase, taps and addresses are worked
//     out once (a thread that took any pixel of the tile ran 1.09-1.26x
//     longer at the U-Net's top blocks, PERF.md);
//   * each output value is written once, 16 bytes a thread;
//   * tiles run fastest in the grid, so neighbouring CTAs share their halo
//     in the L2 and each input byte comes from device memory about once.
// The FIR kernel (at most kMaxTaps x kMaxTaps) is passed by value and copied
// to shared memory by each CTA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFactor = 8;     // up and down, each axis
constexpr int kMaxTaps = 16;      // kernel rows and columns
constexpr int kSmemBudget = 48 * 1024;

struct Taps {
  float k[kMaxTaps * kMaxTaps];   // row-major (kh, kw), as the FIR kernel
};

struct Geometry {
  int H, W, nv, OH, OW;           // sizes; nv: vectors of V a pixel
  int uy, ux, dy, dx, py, px;     // factors and low pads
  int kh, kw;                     // taps
  int TY, lx, tiles_x, tiles;     // output tile (TX = 1 << lx), tiles an image
  int chunk, chunks;              // vectors of a channel chunk (a power of two), chunks
  int rows, cols;                 // staged input tile (the largest a tile can reach)
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void madd(float& a, float w, const float& b) { a = fmaf(w, b, a); }
__device__ __forceinline__ void madd(float4& a, float w, const float4& b) {
  a.x = fmaf(w, b.x, a.x);
  a.y = fmaf(w, b.y, a.y);
  a.z = fmaf(w, b.z, a.z);
  a.w = fmaf(w, b.w, a.w);
}

template <class V>
__global__ void __launch_bounds__(kThreads)
upfirdn_kernel(const V* __restrict__ x, V* __restrict__ y, Geometry g, Taps taps) {
  extern __shared__ __align__(16) float4 smem_f4[];
  V* tile = reinterpret_cast<V*>(smem_f4);
  float* w = reinterpret_cast<float*>(tile + g.rows * g.cols * g.chunk);
  int blk = blockIdx.x;
  const int t = blk % g.tiles;
  blk /= g.tiles;
  const int v0 = (blk % g.chunks) * g.chunk, b = blk / g.chunks;
  const int oy0 = (t / g.tiles_x) * g.TY, ox0 = (t % g.tiles_x) << g.lx;
  // the first input row and column the tile reaches
  const int iy0 = ceil_div(oy0 * g.dy - g.py, g.uy), ix0 = ceil_div(ox0 * g.dx - g.px, g.ux);
  // each thread keeps one vector of the chunk; its pixels are `step` apart
  const int v = threadIdx.x % g.chunk, step = kThreads / g.chunk;
  const bool live = v0 + v < g.nv;
  for (int i = threadIdx.x; i < g.kh * g.kw; i += kThreads) w[i] = taps.k[i];

  const V* xb = x + (size_t)b * g.H * g.W * g.nv + v0 + v;
  for (int p = threadIdx.x / g.chunk, r = p / g.cols, c = p - r * g.cols; p < g.rows * g.cols;
       p += step) {
    const int iy = iy0 + r, ix = ix0 + c;
    V* dst = tile + p * g.chunk + v;
    if (live && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
      __pipeline_memcpy_async(dst, xb + ((size_t)iy * g.W + ix) * g.nv, sizeof(V));
    else
      zero(*dst);
    for (c += step; c >= g.cols; c -= g.cols) ++r;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // each thread keeps one column of the tile (TX divides step) and walks its
  // rows; output (oy, ox) reads padded sample oy dy - py + j, j < kh, with
  // the weight k[kh - 1 - j], and only samples on the up-grid are nonzero
  const int TX = 1 << g.lx, q = threadIdx.x / g.chunk;
  const int ox = ox0 + (q & (TX - 1));
  if (!live || ox >= g.OW) return;
  const int bx = ox * g.dx - g.px, rx = ceil_div(bx, g.ux), jx0 = rx * g.ux - bx;
  const V* sc = tile + (rx - ix0) * g.chunk + v;
  const float* wc = w + g.kw - 1 - jx0;
  const int row = g.cols * g.chunk, oy_end = oy0 + g.TY < g.OH ? oy0 + g.TY : g.OH;
  V* yc = y + (size_t)b * g.OH * g.OW * g.nv + (size_t)ox * g.nv + v0 + v;
  for (int oy = oy0 + (q >> g.lx); oy < oy_end; oy += step >> g.lx) {
    const int by = oy * g.dy - g.py, ry = ceil_div(by, g.uy);
    V acc;
    zero(acc);
    const V* sr = sc + (ry - iy0) * row;
    for (int jy = ry * g.uy - by; jy < g.kh; jy += g.uy, sr += row) {
      const float* wr = wc + (g.kh - 1 - jy) * g.kw;
      for (int jx = 0, c = 0; jx < g.kw - jx0; jx += g.ux, c += g.chunk) madd(acc, wr[-jx], sr[c]);
    }
    yc[(size_t)oy * g.OW * g.nv] = acc;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int log2_of(int p) {
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

}  // namespace

extern "C" {

// y (B, OH, OW, C) = upfirdn of x (B, H, W, C) with the FIR kernel `taps`
// (kh, kw, row-major float32 in host memory), factors (uy, ux) up and
// (dy, dx) down and low pads (py, px); the high pads are implied by OH, OW.
// Returns the launch's error; cudaErrorInvalidValue for a shape or factor
// the kernel does not take (nothing is launched then).
int upfirdn(const float* x, float* y, const float* taps, int kh, int kw, int B, int H, int W,
            int C, int OH, int OW, int uy, int ux, int dy, int dx, int py, int px,
            cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || uy < 1 || ux < 1 || dy < 1 ||
      dx < 1 || uy > kMaxFactor || ux > kMaxFactor || dy > kMaxFactor || dx > kMaxFactor ||
      B < 1 || H < 1 || W < 1 || C < 1 || OH < 1 || OW < 1)
    return cudaErrorInvalidValue;
  const int vec = (C % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0) ? 4 : 1;
  Geometry g;
  g.H = H, g.W = W, g.nv = C / vec, g.OH = OH, g.OW = OW;
  g.uy = uy, g.ux = ux, g.dy = dy, g.dx = dx, g.py = py, g.px = px, g.kh = kh, g.kw = kw;
  // 256 output pixels a tile (fewer where the image is smaller), channel
  // chunks of 32 floats (8 vectors of 4 or 32 single floats), halved until
  // the staged tile fits the budget: the larger side first, then the chunk
  // (a smaller chunk only lets TX grow, which it does not)
  g.chunk = pow2_at_least(g.nv) < (vec == 4 ? 8 : 32) ? pow2_at_least(g.nv) : (vec == 4 ? 8 : 32);
  // (TX at most the pixels a pass of the CTA's threads covers, so that each
  // thread keeps one column)
  g.TY = pow2_at_least(OH) < 16 ? pow2_at_least(OH) : 16;
  int TX = pow2_at_least(OW) < 256 / g.TY ? pow2_at_least(OW) : 256 / g.TY;
  if (TX > kThreads / g.chunk) TX = kThreads / g.chunk;
  size_t smem;
  for (;;) {
    g.rows = ((g.TY - 1) * dy + kh - 1) / uy + 1;
    g.cols = ((TX - 1) * dx + kw - 1) / ux + 1;
    smem = (size_t)g.rows * g.cols * g.chunk * vec * 4 + (size_t)kh * kw * 4;
    if (smem <= kSmemBudget) break;
    if (TX > 1 && TX >= g.TY) TX /= 2;
    else if (g.TY > 1) g.TY /= 2;
    else if (g.chunk > 1) g.chunk /= 2;
    else return cudaErrorInvalidValue;  // unreachable at the caps above
  }
  g.lx = log2_of(TX);
  g.tiles_x = (OW + TX - 1) / TX;
  g.tiles = ((OH + g.TY - 1) / g.TY) * g.tiles_x;
  g.chunks = (g.nv + g.chunk - 1) / g.chunk;
  const long long blocks = (long long)g.tiles * g.chunks * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < kh * kw; ++i) t.k[i] = taps[i];
  if (vec == 4)
    upfirdn_kernel<float4><<<(unsigned)blocks, kThreads, smem, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), g, t);
  else
    upfirdn_kernel<float><<<(unsigned)blocks, kThreads, smem, stream>>>(x, y, g, t);
  return cudaGetLastError();
}

}  // extern "C"
