// K7 — the WPE normal equations: (R + load I) G = P for a batch of small
// complex systems, load = diag_rel * trace(R) / n + eps formed in the kernel.
//
// Replaces the batched complex LU solve that XLA runs for
// buddy_tpu/sampling/wpe.py: _wpe_single_bin :60-61 (vmapped over bins and
// utterances).  The correlations R and P stay matrix products outside.
//
// Method, stated: LU with partial pivoting, in float64, of the complex64
// input.  R is Hermitian positive semi-definite only up to the rounding of
// its complex64 products, and the loading is ~1e-6 of its diagonal, so in
// float32 a Cholesky factorisation can meet a negative pivot and an LU loses
// most digits (complex64 WPE differs between frameworks by ~0.5% of the
// output's peak).  The input has 24 significant bits; factorising it in
// float64 gives the solution of exactly that system, which is what a
// complex128 library solve of the same input returns.
//
// What bounds it on the H100: operations, barely: 8 n^3 / 3 real operations
// a system (n = 50: 0.33 M, 0.7 G for the 2056 systems of a main-path call)
// against 41 KB read.  One block per system; the augmented matrix [R | P]
// lives in shared memory as double2 (n (n+1) 16 bytes: 40.8 KB at n = 50),
// so it is read from device memory once and five blocks fit on an SM.  Each
// elimination step is a pivot search by one warp, a row swap, the column of
// multipliers and the rank-1 update spread over the block's threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cdiv(double2 a, double2 b) {
  const double s = 1.0 / (b.x * b.x + b.y * b.y);
  return make_double2((a.x * b.x + a.y * b.y) * s, (a.y * b.x - a.x * b.y) * s);
}

__global__ void wpe_solve_kernel(const float2* __restrict__ R, const float2* __restrict__ P,
                                 float2* __restrict__ G, int n, double diag_rel, double eps) {
  extern __shared__ __align__(16) double2 a[];  // n rows of n + 1: [R + load I | P]
  __shared__ int pivot_row;
  const int ld = n + 1;
  const int tid = threadIdx.x;
  const float2* Rs = R + (size_t)blockIdx.x * n * n;
  const float2* Ps = P + (size_t)blockIdx.x * n;

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const float2 v = Rs[idx];
    a[(idx / n) * ld + idx % n] = make_double2(v.x, v.y);
  }
  for (int i = tid; i < n; i += blockDim.x) a[i * ld + n] = make_double2(Ps[i].x, Ps[i].y);
  __syncthreads();
  // every thread forms the same load (a serial sum in a fixed order)
  double trace = 0.0;
  for (int i = 0; i < n; ++i) trace += a[i * ld + i].x;
  const double load = diag_rel * (trace / n) + eps;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) a[i * ld + i].x += load;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {  // pivot: the row i >= k with the largest |a[i][k]|
      double best = -1.0;
      int row = k;
      for (int i = k + tid; i < n; i += 32) {
        const double2 v = a[i * ld + k];
        const double m = v.x * v.x + v.y * v.y;
        if (m > best) { best = m; row = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, off);
        const int orow = __shfl_down_sync(0xffffffffu, row, off);
        if (ob > best || (ob == best && orow < row)) { best = ob; row = orow; }
      }
      if (tid == 0) pivot_row = row;
    }
    __syncthreads();
    const int pr = pivot_row;
    if (pr != k) {
      for (int j = k + tid; j <= n; j += blockDim.x) {
        const double2 tmp = a[k * ld + j];
        a[k * ld + j] = a[pr * ld + j];
        a[pr * ld + j] = tmp;
      }
    }
    __syncthreads();
    const double2 akk = a[k * ld + k];
    for (int i = k + 1 + tid; i < n; i += blockDim.x) a[i * ld + k] = cdiv(a[i * ld + k], akk);
    __syncthreads();
    const int rows = n - k - 1, cols = n - k;  // columns k+1 .. n (the right-hand side too)
    for (int idx = tid; idx < rows * cols; idx += blockDim.x) {
      const int i = k + 1 + idx / cols, j = k + 1 + idx % cols;
      const double2 m = cmul(a[i * ld + k], a[k * ld + j]);
      a[i * ld + j].x -= m.x;
      a[i * ld + j].y -= m.y;
    }
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {  // back substitution on the last column
    if (tid == 0) a[k * ld + n] = cdiv(a[k * ld + n], a[k * ld + k]);
    __syncthreads();
    const double2 xk = a[k * ld + n];
    for (int i = tid; i < k; i += blockDim.x) {
      const double2 m = cmul(a[i * ld + k], xk);
      a[i * ld + n].x -= m.x;
      a[i * ld + n].y -= m.y;
    }
    __syncthreads();
  }
  float2* Gs = G + (size_t)blockIdx.x * n;
  for (int i = tid; i < n; i += blockDim.x)
    Gs[i] = make_float2((float)a[i * ld + n].x, (float)a[i * ld + n].y);
}

}  // namespace

extern "C" int wpe_solve(const float* R, const float* P, float* G, int batch, int n,
                         double diag_rel, double eps, cudaStream_t stream) {
  const size_t smem = (size_t)n * (n + 1) * sizeof(double2);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)wpe_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wpe_solve_kernel<<<batch, kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(R), reinterpret_cast<const float2*>(P),
      reinterpret_cast<float2*>(G), n, diag_rel, eps);
  return (int)cudaGetLastError();
}
