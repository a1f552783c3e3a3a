// K6 — the blind operator's filter design and phasor:
//
//   env[b,k,n]  = sum_e w[b,e,k] * exp(p[b,e,k])^(-n)        k < bands, n < Nf
//   full        = env with a zero row below and above when the EQ extremes
//                 are fixed (rows q < Q)
//   I[b,f,n]    = (1-t[f]) log(full[b,j[f],n] + 1e-6) + t[f] log(full[b,j[f]+1,n] + 1e-6)
//   A[b,f,n]    = (exp(I) + 1e-6) * ola[n] + dpc[f,n]
//   H[b,f,n]    = A * exp(i phases[b,f,n])
//
// Replaces the XLA-fused chain of buddy_tpu/operators/subband.py:
// design_subband_filter :341, design_filter :367 and the phasor of
// compute_H :390.  The linear interpolation across the EQ breakpoints is a
// (F x Q) matrix with two non-zeros per row there; here each frequency row
// carries its interval j[f] and weight t[f] and gathers its two rows.
//
// What bounds it on the H100: at the main-path shape (B=8, F=513, Nf=100,
// Q=27) it moves 1.6 MB of phases in and 3.3 MB of H out, about 1.5 us at
// 3.35 TB/s: it is launch-bound, and what counts is that the eager chain's
// 15 launches (and their autograd mirror) become one forward and two
// backward launches.
//
// forward: one block per (b, f); thread n recomputes the two envelope rows it
// needs (2 E powf), so nothing is staged or stored between passes.
// backward: pass 1 (one block per (b, f)) writes dL/dphases and dL/dI; pass 2
// (one block per (b, q)) gathers dL/dI over the rows of the two intervals
// that touch breakpoint q, serially in a fixed order, and reduces over n in
// shared memory with a fixed tree: the sums of ~51k terms behind each
// dL/dweight and dL/ddecay have the same order in every run (no atomics).
//
// Gradients follow torch's convention for a real loss of complex H
// (gH = dL/dRe H + i dL/dIm H).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxExp = 4;

struct Dims {
  int F, Nf, E, bands, Q, pad;  // pad = 1 when the EQ extremes are fixed zero rows
};

// full[b, q, n] + 1e-6 for one (b, q, n); q indexes the EQ breakpoints.
__device__ __forceinline__ float full_plus_eps(const float* __restrict__ p,
                                               const float* __restrict__ w, const Dims d,
                                               int b, int q, int n) {
  const int k = q - d.pad;
  float env = 0.f;
  if (k >= 0 && k < d.bands) {
    for (int e = 0; e < d.E; ++e) {
      const size_t i = ((size_t)b * d.E + e) * d.bands + k;
      env += w[i] * powf(expf(p[i]), -(float)n);
    }
  }
  return env + 1e-6f;
}

__global__ void design_fwd_kernel(const float* __restrict__ p, const float* __restrict__ w,
                                  const float* __restrict__ phases, const int* __restrict__ jrow,
                                  const float* __restrict__ trow, const float* __restrict__ ola,
                                  const float* __restrict__ dpc, float2* __restrict__ H,
                                  const Dims d) {
  const int f = blockIdx.x, b = blockIdx.y;
  const int j = jrow[f];
  const float t = trow[f];
  for (int n = threadIdx.x; n < d.Nf; n += blockDim.x) {
    const float I = (1.f - t) * logf(full_plus_eps(p, w, d, b, j, n)) +
                    t * logf(full_plus_eps(p, w, d, b, j + 1, n));
    const float A = (expf(I) + 1e-6f) * ola[n] + dpc[(size_t)f * d.Nf + n];
    const size_t o = ((size_t)b * d.F + f) * d.Nf + n;
    float s, c;
    sincosf(phases[o], &s, &c);
    H[o] = make_float2(A * c, A * s);
  }
}

// pass 1: dL/dphases and dL/dI per (b, f, n).
__global__ void design_bwd_point_kernel(const float* __restrict__ p, const float* __restrict__ w,
                                        const float* __restrict__ phases,
                                        const float2* __restrict__ gH,
                                        const int* __restrict__ jrow,
                                        const float* __restrict__ trow,
                                        const float* __restrict__ ola,
                                        const float* __restrict__ dpc, float* __restrict__ gphases,
                                        float* __restrict__ gI, const Dims d) {
  const int f = blockIdx.x, b = blockIdx.y;
  const int j = jrow[f];
  const float t = trow[f];
  for (int n = threadIdx.x; n < d.Nf; n += blockDim.x) {
    const float I = (1.f - t) * logf(full_plus_eps(p, w, d, b, j, n)) +
                    t * logf(full_plus_eps(p, w, d, b, j + 1, n));
    const float P = expf(I);
    const float A = (P + 1e-6f) * ola[n] + dpc[(size_t)f * d.Nf + n];
    const size_t o = ((size_t)b * d.F + f) * d.Nf + n;
    float s, c;
    sincosf(phases[o], &s, &c);
    const float2 g = gH[o];
    gphases[o] = A * (g.y * c - g.x * s);
    gI[o] = (g.x * c + g.y * s) * ola[n] * P;
  }
}

// pass 2: dL/dweights and dL/ddecay of band k = q - pad for one (b, q).
// row_start[q] is the first frequency row whose interval index j is >= q
// (row_start[Q-1] = F): rows [row_start[q], row_start[q+1]) weigh breakpoint q
// by 1-t, rows [row_start[q-1], row_start[q]) by t.
__global__ void design_bwd_band_kernel(const float* __restrict__ p, const float* __restrict__ w,
                                       const float* __restrict__ gI,
                                       const float* __restrict__ trow,
                                       const int* __restrict__ row_start, float* __restrict__ gp,
                                       float* __restrict__ gw, const Dims d) {
  __shared__ float red[2 * kMaxExp][kThreads];
  const int k = blockIdx.x, b = blockIdx.y;
  const int q = k + d.pad;
  float acc_w[kMaxExp], acc_p[kMaxExp];
  for (int e = 0; e < kMaxExp; ++e) acc_w[e] = acc_p[e] = 0.f;
  for (int n = threadIdx.x; n < d.Nf; n += blockDim.x) {
    float g_log = 0.f;
    const float* col = gI + (size_t)b * d.F * d.Nf + n;
    if (q >= 1)
      for (int f = row_start[q - 1]; f < row_start[q]; ++f) g_log += trow[f] * col[(size_t)f * d.Nf];
    if (q <= d.Q - 2)
      for (int f = row_start[q]; f < row_start[q + 1]; ++f)
        g_log += (1.f - trow[f]) * col[(size_t)f * d.Nf];
    const float g_full = g_log / full_plus_eps(p, w, d, b, q, n);
    for (int e = 0; e < d.E; ++e) {
      const size_t i = ((size_t)b * d.E + e) * d.bands + k;
      const float decayed = powf(expf(p[i]), -(float)n);
      acc_w[e] += g_full * decayed;
      acc_p[e] += g_full * w[i] * (-(float)n) * decayed;
    }
  }
  for (int e = 0; e < d.E; ++e) {
    red[2 * e][threadIdx.x] = acc_w[e];
    red[2 * e + 1][threadIdx.x] = acc_p[e];
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int r = 0; r < 2 * d.E; ++r) red[r][threadIdx.x] += red[r][threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int e = 0; e < d.E; ++e) {
      const size_t i = ((size_t)b * d.E + e) * d.bands + k;
      gw[i] = red[2 * e][0];
      gp[i] = red[2 * e + 1][0];
    }
  }
}

}  // namespace

extern "C" int filter_design_fwd(const float* p, const float* w, const float* phases,
                                 const int* jrow, const float* trow, const float* ola,
                                 const float* dpc, float* H, int B, int F, int Nf, int E, int bands,
                                 int Q, int pad, cudaStream_t stream) {
  if (E > kMaxExp) return (int)cudaErrorInvalidValue;
  const Dims d{F, Nf, E, bands, Q, pad};
  design_fwd_kernel<<<dim3(F, B), kThreads, 0, stream>>>(p, w, phases, jrow, trow, ola, dpc,
                                                         reinterpret_cast<float2*>(H), d);
  return (int)cudaGetLastError();
}

extern "C" int filter_design_bwd(const float* p, const float* w, const float* phases,
                                 const float* gH, const int* jrow, const float* trow,
                                 const int* row_start, const float* ola, const float* dpc,
                                 float* gphases, float* gI, float* gp, float* gw, int B, int F,
                                 int Nf, int E, int bands, int Q, int pad, cudaStream_t stream) {
  if (E > kMaxExp) return (int)cudaErrorInvalidValue;
  const Dims d{F, Nf, E, bands, Q, pad};
  design_bwd_point_kernel<<<dim3(F, B), kThreads, 0, stream>>>(
      p, w, phases, reinterpret_cast<const float2*>(gH), jrow, trow, ola, dpc, gphases, gI, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  design_bwd_band_kernel<<<dim3(bands, B), kThreads, 0, stream>>>(p, w, gI, trow, row_start, gp,
                                                                  gw, d);
  return (int)cudaGetLastError();
}
