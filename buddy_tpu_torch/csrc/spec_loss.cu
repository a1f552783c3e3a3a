// K4's loss pair — the per-utterance compressed-STFT loss and its vjp.
//
// Replaces the XLA-fused reductions of buddy_tpu/losses.py::loss_fn (:120,
// the l2_comp_stft_* losses) over the compression of _compress (:51):
//
//   C(X) = (|X| + 1e-8)^c X / |X|,   C(0) = (1e-8)^c + 0i (gradient 0),
//   L[b] = scale sum_{f,t} |A[b] - C(X[b])|^2,
//
// A an already compressed reference, and its backward: with coef =
// 2 scale g[b], dL/dA = coef (A - C(X)) and dL/dX the pull-back of -dL/dA
// through C (torch's convention for a real loss of a complex tensor, g =
// dL/dRe + i dL/dIm).  The compression's own kernels stay in Triton
// (csrc/spec_loss.py).
//
// Layout: complex64 (B, N) rows, N = bins x frames, as interleaved float.
//
// What bounds it on the H100: bytes.  Tens of operations an element against
// 16 bytes read (forward) or 16 read and 8-16 written (backward).  The
// design keeps the card's memory busy: every thread has four 16-byte loads
// of each operand (two complex values a load) in flight before it uses
// any, and a persistent grid of a few CTAs an SM walks each utterance's row
// in contiguous stretches, one stretch a CTA.  The forward reduces without
// float atomics: each CTA writes its partial sum (a fixed order: per
// thread, then a shuffle tree, then the warps in order), takes an integer
// ticket, and the CTA that draws the utterance's last ticket sums the
// partials in order and writes L[b] (and resets the ticket for the next
// call): one launch, bit-identical run to run.  The backward is one pass
// that writes dL/dX, and dL/dA only when it is asked for.  The head or tail
// element of a row that does not start or end on a 16-byte boundary (odd
// N) is done alone.  Everything is float32 and no fast-math intrinsic is
// used.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256, kUnroll = 4, kCtasPerSm = 4;
constexpr float kEps = 1e-8f;

// |X| without underflow of the squares (the guarded hypot: max(|re|, |im|)
// times the norm of the ratios), s = (|X| + 1e-8)^c / |X|, and 1 / |X|;
// at X = 0 the magnitude reads 1 and the caller masks the zero bin.  One
// log, one exp and two reciprocals serve the value and its vjp.
struct Scale {
  float mag, inv, s;
  bool zero;
};

__device__ __forceinline__ Scale scale_of(float2 x, float c) {
  const float ar = fabsf(x.x), ai = fabsf(x.y);
  const float mx = fmaxf(ar, ai);
  Scale k;
  k.zero = mx == 0.f;
  const float inv_mx = 1.f / (k.zero ? 1.f : mx);
  const float r = ar * inv_mx, i = ai * inv_mx;
  k.mag = k.zero ? 1.f : mx * sqrtf(r * r + i * i);
  k.inv = 1.f / k.mag;
  k.s = expf(c * logf(k.mag + kEps)) * k.inv;
  return k;
}

// C(X) = s X, (1e-8)^c at X = 0
__device__ __forceinline__ float2 compress(float2 x, const Scale& k, float zero_val) {
  return k.zero ? make_float2(zero_val, 0.f) : make_float2(x.x * k.s, x.y * k.s);
}

// s g + (s'/m) X Re(conj(X) g), s' = s (c/(m + eps) - 1/m); 0 at X = 0
__device__ __forceinline__ float2 compress_vjp(float2 x, float2 g, const Scale& k, float c) {
  const float t = k.s * (c / (k.mag + kEps) - k.inv) * k.inv * (x.x * g.x + x.y * g.y);
  return k.zero ? make_float2(0.f, 0.f) : make_float2(k.s * g.x + t * x.x, k.s * g.y + t * x.y);
}

__device__ __forceinline__ float sq_err(float2 a, float2 x, float c, float zero_val) {
  const float2 cx = compress(x, scale_of(x, c), zero_val);
  const float dr = a.x - cx.x, di = a.y - cx.y;
  return dr * dr + di * di;
}

// The row's complex elements [row0, row0 + N) as a float4 body of pairs
// [p0, p1) for this CTA (pair p holds elements 2p and 2p + 1), and the
// elements outside the body: head (row0, when it is odd) and tail.
struct Stretch {
  long long p0, p1, head, tail;      // head, tail: -1 when there is none
};

__device__ Stretch stretch(long long row0, long long N, int blk, int nb) {
  const long long a0 = (row0 + 1) & ~1LL;
  const long long a1 = max(a0, (row0 + N) & ~1LL);
  const long long np = (a1 - a0) / 2;
  Stretch s;
  s.p0 = a0 / 2 + np * blk / nb;
  s.p1 = a0 / 2 + np * (blk + 1) / nb;
  s.head = (blk == 0 && a0 != row0) ? row0 : -1;
  s.tail = (blk == nb - 1 && a1 < row0 + N && a1 >= a0) ? a1 : -1;
  if (s.tail == s.head) s.tail = -1;
  return s;
}

// L[b] = scale sum |A - C(X)|^2 over row b; grid (nb, B)
__global__ void __launch_bounds__(kThreads)
comp_loss_fwd_kernel(const float2* __restrict__ A, const float2* __restrict__ X,
                     float* __restrict__ part, unsigned* __restrict__ tickets,
                     float* __restrict__ loss, long long N, float c, float zero_val,
                     float scale) {
  const int b = blockIdx.y, blk = blockIdx.x, nb = gridDim.x;
  const Stretch s = stretch((long long)b * N, N, blk, nb);
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* X4 = reinterpret_cast<const float4*>(X);
  float acc = 0.f;
  for (long long p = s.p0 + threadIdx.x; p < s.p1; p += (long long)kThreads * kUnroll) {
    float4 a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + (long long)u * kThreads;
      a[u] = q < s.p1 ? __ldg(A4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[u] = q < s.p1 ? __ldg(X4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + (long long)u * kThreads < s.p1) {
        acc += sq_err(make_float2(a[u].x, a[u].y), make_float2(x[u].x, x[u].y), c, zero_val);
        acc += sq_err(make_float2(a[u].z, a[u].w), make_float2(x[u].z, x[u].w), c, zero_val);
      }
    }
  }
  if (threadIdx.x == 0) {
    if (s.head >= 0) acc += sq_err(A[s.head], X[s.head], c, zero_val);
    if (s.tail >= 0) acc += sq_err(A[s.tail], X[s.tail], c, zero_val);
  }
  // the CTA's partial: a shuffle tree, then the warps in order
  __shared__ float warp_sum[kThreads / 32];
  __shared__ bool last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
    part[(size_t)b * nb + blk] = t;
    __threadfence();
    last = atomicAdd(tickets + b, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the utterance's last CTA: its partials in order (lane l takes l, l + 32, ...)
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < nb; i += 32) t += __ldcg(part + (size_t)b * nb + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  if (threadIdx.x == 0) {
    loss[b] = scale * t;
    tickets[b] = 0u;
  }
}

// dL/dA = coef (A - C(X)) (when ga is given), dL/dX = vjp of C at X of
// -dL/dA (when gx is given), coef = 2 scale g[b]; grid (nb, B)
__global__ void __launch_bounds__(kThreads)
comp_loss_bwd_kernel(const float2* __restrict__ A, const float2* __restrict__ X,
                     const float* __restrict__ g, float2* __restrict__ ga,
                     float2* __restrict__ gx, long long N, float c, float zero_val,
                     float scale) {
  const int b = blockIdx.y, blk = blockIdx.x, nb = gridDim.x;
  const Stretch s = stretch((long long)b * N, N, blk, nb);
  const float coef = 2.f * scale * __ldg(g + b);
  const auto grads = [&](float2 a, float2 x, float2& da, float2& dx) {
    const Scale k = scale_of(x, c);
    const float2 cx = compress(x, k, zero_val);
    da = make_float2(coef * (a.x - cx.x), coef * (a.y - cx.y));
    dx = compress_vjp(x, make_float2(-da.x, -da.y), k, c);
  };
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* X4 = reinterpret_cast<const float4*>(X);
  float4* GA4 = reinterpret_cast<float4*>(ga);
  float4* GX4 = reinterpret_cast<float4*>(gx);
  for (long long p = s.p0 + threadIdx.x; p < s.p1; p += (long long)kThreads * kUnroll) {
    float4 a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + (long long)u * kThreads;
      a[u] = q < s.p1 ? __ldg(A4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[u] = q < s.p1 ? __ldg(X4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + (long long)u * kThreads;
      if (q >= s.p1) continue;
      float2 da0, dx0, da1, dx1;
      grads(make_float2(a[u].x, a[u].y), make_float2(x[u].x, x[u].y), da0, dx0);
      grads(make_float2(a[u].z, a[u].w), make_float2(x[u].z, x[u].w), da1, dx1);
      if (ga) GA4[q] = make_float4(da0.x, da0.y, da1.x, da1.y);
      if (gx) GX4[q] = make_float4(dx0.x, dx0.y, dx1.x, dx1.y);
    }
  }
  if (threadIdx.x == 0) {
    const long long ends[2] = {s.head, s.tail};
    for (int k = 0; k < 2; ++k) {
      const long long e = ends[k];
      if (e < 0) continue;
      float2 da, dx;
      grads(A[e], X[e], da, dx);
      if (ga) ga[e] = da;
      if (gx) gx[e] = dx;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// CTAs a row: a few CTAs an SM over the batch, and no more than the row's
// pairs fill at kUnroll a thread
int ctas_per_row(int B, long long N) {
  const long long fill = (N / 2 + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  const long long want = ((long long)kCtasPerSm * sm_count() + B - 1) / B;
  return (int)std::max(1LL, std::min(want, fill));
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The number of partial sums comp_loss_forward needs a row (its scratch is B x that).
extern "C" int comp_loss_parts(int B, long long N) { return ctas_per_row(B, N); }

// tickets: B unsigned ints, zero before the first call (each call leaves them zero)
extern "C" int comp_loss_forward(const float* A, const float* X, float* part, unsigned* tickets,
                                 float* loss, int B, long long N, float c, float zero_val,
                                 float scale, cudaStream_t stream) {
  if (B < 1 || N < 1 || !aligned(A) || !aligned(X)) return (int)cudaErrorInvalidValue;
  const int nb = ctas_per_row(B, N);
  comp_loss_fwd_kernel<<<dim3(nb, B), kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(A), reinterpret_cast<const float2*>(X), part, tickets, loss,
      N, c, zero_val, scale);
  return (int)cudaGetLastError();
}

extern "C" int comp_loss_backward(const float* A, const float* X, const float* g, float* ga,
                                  float* gx, int B, long long N, float c, float zero_val,
                                  float scale, cudaStream_t stream) {
  if (B < 1 || N < 1 || !aligned(A) || !aligned(X) || !aligned(ga) || !aligned(gx))
    return (int)cudaErrorInvalidValue;
  comp_loss_bwd_kernel<<<dim3(ctas_per_row(B, N), B), kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(A), reinterpret_cast<const float2*>(X), g,
      reinterpret_cast<float2*>(ga), reinterpret_cast<float2*>(gx), N, c, zero_val, scale);
  return (int)cudaGetLastError();
}
