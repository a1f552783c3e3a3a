// K3 — subband frame convolution: a complex FIR along the STFT frame axis,
// one independent filter per (utterance, frequency bin).
//
// Replaces the TPU's overlap-save matmul DFTs in
// buddy_tpu/operators/subband.py: SubbandFiltering.subband_filtering :76
// (with _frame_fft_os :122, dft.cfft and dft.icfft_slice).
//
//   forward:  Y[b,f,t]  = sum_{j<Nf} H[b,f,j] * X[b,f,t+pre-j]
//   adjoint:  dX[b,f,s] = sum_{j<Nf} conj(H[b,f,j]) * G[b,f,s-pre+j]
//   filter:   dH[b,f,j] = sum_t G[b,f,t] * conj(X[b,f,t+pre-j])
// with zeros outside [0, T).  The two backward formulas follow torch's
// complex-gradient convention (G = dL/dRe Y + i dL/dIm Y).
//
// What bounds it on the H100: float32 FMA.  At the main-path shape
// (B=8, F=513, T=517, Nf=100) the forward is ~0.85 G real FMA against
// ~17 MB of input and output, about 25 FMA per byte, so it is compute-bound
// for plain FMA.  The design gives each (utterance, bin) row one block: the
// whole filter row (Nf values) and the whole signal row (T values) are
// staged in shared memory once, then every thread produces outputs from
// shared memory alone (filter taps broadcast, signal reads consecutive across
// the warp).  The TPU needed DFT matmuls to reach its matrix unit; here the
// direct sum needs no transform of X or H and nothing stored between passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Forward (adjoint = 0) or adjoint (adjoint = 1) FIR of one (b, f) row per block.
// x_bstride / h_bstride are element strides between utterances (0 broadcasts).
__global__ void fir_kernel(const float2* __restrict__ X, const float2* __restrict__ H,
                           float2* __restrict__ Y, int F, int T, int Nf, int pre,
                           long long x_bstride, long long h_bstride, int adjoint) {
  extern __shared__ float2 sm[];
  float2* hs = sm;       // Nf filter taps (conjugated for the adjoint)
  float2* xs = sm + Nf;  // T signal frames
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const float2* xr = X + b * x_bstride + (size_t)f * T;
  const float2* hr = H + b * h_bstride + (size_t)f * Nf;
  for (int i = threadIdx.x; i < Nf; i += blockDim.x) {
    const float2 v = hr[i];
    hs[i] = adjoint ? make_float2(v.x, -v.y) : v;
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x) xs[i] = xr[i];
  __syncthreads();

  float2* yr = Y + ((size_t)b * F + f) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    if (!adjoint) {
      // 0 <= t + pre - j < T
      const int jlo = max(0, t + pre - T + 1);
      const int jhi = min(Nf - 1, t + pre);
      for (int j = jlo; j <= jhi; ++j) {
        const float2 p = cmul(hs[j], xs[t + pre - j]);
        ar += p.x;
        ai += p.y;
      }
    } else {
      // 0 <= t - pre + j < T
      const int jlo = max(0, pre - t);
      const int jhi = min(Nf - 1, T - 1 - t + pre);
      for (int j = jlo; j <= jhi; ++j) {
        const float2 p = cmul(hs[j], xs[t - pre + j]);
        ar += p.x;
        ai += p.y;
      }
    }
    yr[t] = make_float2(ar, ai);
  }
}

// dH[b, f, j] = sum_t G[b, f, t] * conj(X[b, f, t + pre - j]); one (b, f) row per block.
__global__ void fir_dh_kernel(const float2* __restrict__ G, const float2* __restrict__ X,
                              float2* __restrict__ dH, int F, int T, int Nf, int pre,
                              long long x_bstride) {
  extern __shared__ float2 sm[];
  float2* gs = sm;      // T output-gradient frames
  float2* xs = sm + T;  // T signal frames
  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const float2* gr = G + ((size_t)b * F + f) * T;
  const float2* xr = X + b * x_bstride + (size_t)f * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    gs[i] = gr[i];
    xs[i] = xr[i];
  }
  __syncthreads();

  float2* dr = dH + ((size_t)b * F + f) * Nf;
  for (int j = threadIdx.x; j < Nf; j += blockDim.x) {
    // 0 <= t + pre - j < T
    const int tlo = max(0, j - pre);
    const int thi = min(T - 1, T - 1 + j - pre);
    float ar = 0.f, ai = 0.f;
    for (int t = tlo; t <= thi; ++t) {
      const float2 g = gs[t];
      const float2 x = xs[t + pre - j];
      ar += g.x * x.x + g.y * x.y;
      ai += g.y * x.x - g.x * x.y;
    }
    dr[j] = make_float2(ar, ai);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" int subband_fir(const float* X, const float* H, float* Y, int B, int F, int T,
                           int Nf, int pre, long long x_bstride, long long h_bstride,
                           int adjoint, cudaStream_t stream) {
  const size_t smem = (size_t)(Nf + T) * sizeof(float2);
  int err = set_smem((const void*)fir_kernel, smem);
  if (err) return err;
  fir_kernel<<<dim3(F, B), kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(X), reinterpret_cast<const float2*>(H),
      reinterpret_cast<float2*>(Y), F, T, Nf, pre, x_bstride, h_bstride, adjoint);
  return (int)cudaGetLastError();
}

extern "C" int subband_fir_dh(const float* G, const float* X, float* dH, int B, int F, int T,
                              int Nf, int pre, long long x_bstride, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)T * sizeof(float2);
  int err = set_smem((const void*)fir_dh_kernel, smem);
  if (err) return err;
  fir_dh_kernel<<<dim3(F, B), kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(G), reinterpret_cast<const float2*>(X),
      reinterpret_cast<float2*>(dH), F, T, Nf, pre, x_bstride);
  return (int)cudaGetLastError();
}
