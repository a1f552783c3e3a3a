// K2 — STFT analysis and ISTFT synthesis as tap sums over hop-sample blocks.
//
// Replaces the TPU's conv-formulated STFT/ISTFT (buddy_tpu/ops/stft.py:
// _stft_conv :154 with its basis _stft_conv_kernel :132, _istft_conv :317
// with _istft_conv_kernel :294).  With the padded signal cut into blocks of
// `hop` samples, frame t is the sum over taps j of block[t + j] times the
// window-folded real-DFT basis rows j*hop .. (j+1)*hop.  Only
// taps = ceil(window support / hop) slices are computed: 4 for the model's
// hann(510) and for the operators' hann(512) right-padded to 1024.
//
// What bounds it on the H100: float32 FMA.  At the model geometry (B=8,
// 513 frames, 2F=512 outputs, 512 basis rows) one transform is ~1.1 G FMA
// against ~5 MB of input and ~8 MB of output, so it sits far above the
// memory roofline ridge.  The design keeps the signal tile in shared memory
// (read once per block, broadcast to all threads), reads each basis value
// once per block from L2 with coalesced loads, and keeps a register tile of
// output frames per thread so that one basis load feeds 2 x 16 FMAs.  No
// tensor cores yet (wgmma is later work); the basis is float32 as on the TPU
// reference's CPU path.
//
// The two kernels are each other's adjoint with the transposed basis, so
// the autograd functions of stft and istft use the pair in both directions.
// Complex data is interleaved float (torch.view_as_real layout).

#include <cuda_runtime.h>

namespace {

constexpr int kFreqPerBlock = 128;   // threads of the analysis kernel, one bin each
constexpr int kFramesPerBlock = 16;  // frames per analysis block (register tile)
constexpr int kSamplesPerBlock = 128;  // threads of the synthesis kernel, one sample each
constexpr int kBlocksPerTile = 8;    // output hop-blocks per synthesis block
constexpr int kBinChunk = 32;        // bins staged in shared memory at a time
constexpr int kBinGroups = 4;        // thread rows of the synthesis kernel splitting the bins

// out[n, f, t] = (sum_j sum_h x[n, t + j, h] * basis[j, h, f],
//                 sum_j sum_h x[n, t + j, h] * basis[j, h, F + f])
// x: (N, nb, hop) float; basis: (taps, hop, 2F) float; out: (N, F, T) float2.
__global__ void analysis_kernel(const float* __restrict__ x,
                                const float* __restrict__ basis,
                                float2* __restrict__ out,
                                int nb, int hop, int taps, int F, int T) {
  extern __shared__ float xs[];  // (kFramesPerBlock + taps - 1) rows of hop samples
  const int n = blockIdx.z;
  const int t0 = blockIdx.y * kFramesPerBlock;
  const int f = blockIdx.x * kFreqPerBlock + threadIdx.x;
  const int rows = kFramesPerBlock + taps - 1;
  const float* xn = x + (size_t)n * nb * hop;
  for (int i = threadIdx.x; i < rows * hop; i += blockDim.x) {
    const int b = t0 + i / hop;
    xs[i] = b < nb ? xn[(size_t)t0 * hop + i] : 0.f;
  }
  __syncthreads();
  if (f >= F) return;

  float re[kFramesPerBlock], im[kFramesPerBlock];
#pragma unroll
  for (int tt = 0; tt < kFramesPerBlock; ++tt) {
    re[tt] = 0.f;
    im[tt] = 0.f;
  }
  const size_t twoF = 2 * (size_t)F;
  for (int j = 0; j < taps; ++j) {
    const float* bj = basis + (size_t)j * hop * twoF;
    const float* xj = xs + j * hop;
    for (int h = 0; h < hop; ++h) {
      const float c = __ldg(bj + h * twoF + f);
      const float s = __ldg(bj + h * twoF + F + f);
#pragma unroll
      for (int tt = 0; tt < kFramesPerBlock; ++tt) {
        const float v = xj[tt * hop + h];
        re[tt] = fmaf(v, c, re[tt]);
        im[tt] = fmaf(v, s, im[tt]);
      }
    }
  }
  float2* o = out + ((size_t)n * F + f) * T;
#pragma unroll
  for (int tt = 0; tt < kFramesPerBlock; ++tt) {
    if (t0 + tt < T) o[t0 + tt] = make_float2(re[tt], im[tt]);
  }
}

// out[n, b, h] = sum_{j < taps, 0 <= b - j < T} sum_{f < F}
//                  z[n, f, b - j].re * basis[j, f, h] + z[n, f, b - j].im * basis[j, F + f, h]
// z: (N, F, T) float2; basis: (taps, 2F, hop) float; out: (N, nb_out, hop) float.
// Every output block gathers its own taps: no atomics, deterministic.  The
// sum over bins is split over kBinGroups rows of threads (threadIdx.y) and
// reduced in shared memory at the end, so that short spectra (the operator's
// ~100-frame RIR transforms) still give every SM several warps.
__global__ void synthesis_kernel(const float2* __restrict__ z,
                                 const float* __restrict__ basis,
                                 float* __restrict__ out,
                                 int nb_out, int hop, int taps, int F, int T) {
  extern __shared__ float zs[];  // [kBinChunk][rows][2]; reused for the reduction
  const int n = blockIdx.z;
  const int b0 = blockIdx.y * kBlocksPerTile;
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int rows = kBlocksPerTile + taps - 1;
  const int tfirst = b0 - (taps - 1);  // frame held in row 0
  const float2* zn = z + (size_t)n * F * T;

  float acc[kBlocksPerTile];
#pragma unroll
  for (int bb = 0; bb < kBlocksPerTile; ++bb) acc[bb] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBinChunk) {
    const int nf = min(kBinChunk, F - f0);
    __syncthreads();
    for (int i = tid; i < nf * rows; i += nthreads) {
      const int fi = i / rows;
      const int t = tfirst + i % rows;
      const float2 v = (t >= 0 && t < T) ? zn[(size_t)(f0 + fi) * T + t]
                                         : make_float2(0.f, 0.f);
      zs[2 * i] = v.x;
      zs[2 * i + 1] = v.y;
    }
    __syncthreads();
    if (h < hop) {
      for (int fi = threadIdx.y; fi < nf; fi += kBinGroups) {
        for (int j = 0; j < taps; ++j) {
          const float cr = __ldg(basis + ((size_t)j * 2 * F + f0 + fi) * hop + h);
          const float ci = __ldg(basis + ((size_t)j * 2 * F + F + f0 + fi) * hop + h);
          // row of frame b0 + bb - j is bb + taps - 1 - j
          const float* zr = zs + 2 * (fi * rows + taps - 1 - j);
#pragma unroll
          for (int bb = 0; bb < kBlocksPerTile; ++bb) {
            acc[bb] = fmaf(zr[2 * bb], cr, acc[bb]);
            acc[bb] = fmaf(zr[2 * bb + 1], ci, acc[bb]);
          }
        }
      }
    }
  }
  // reduce the kBinGroups partial sums: rows y > 0 park theirs, row 0 adds
  __syncthreads();
  if (threadIdx.y > 0) {
#pragma unroll
    for (int bb = 0; bb < kBlocksPerTile; ++bb)
      zs[((threadIdx.y - 1) * kBlocksPerTile + bb) * blockDim.x + threadIdx.x] = acc[bb];
  }
  __syncthreads();
  if (threadIdx.y > 0 || h >= hop) return;
  for (int g = 1; g < kBinGroups; ++g) {
#pragma unroll
    for (int bb = 0; bb < kBlocksPerTile; ++bb)
      acc[bb] += zs[((g - 1) * kBlocksPerTile + bb) * blockDim.x + threadIdx.x];
  }
#pragma unroll
  for (int bb = 0; bb < kBlocksPerTile; ++bb) {
    const int b = b0 + bb;
    if (b < nb_out) out[((size_t)n * nb_out + b) * hop + h] = acc[bb];
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" int stft_analysis(const float* x, const float* basis, float* out, int N, int nb,
                             int hop, int taps, int F, int T, cudaStream_t stream) {
  const size_t smem = (size_t)(kFramesPerBlock + taps - 1) * hop * sizeof(float);
  int err = set_smem((const void*)analysis_kernel, smem);
  if (err) return err;
  const dim3 grid((F + kFreqPerBlock - 1) / kFreqPerBlock,
                  (T + kFramesPerBlock - 1) / kFramesPerBlock, N);
  analysis_kernel<<<grid, kFreqPerBlock, smem, stream>>>(
      x, basis, reinterpret_cast<float2*>(out), nb, hop, taps, F, T);
  return (int)cudaGetLastError();
}

extern "C" int stft_synthesis(const float* z, const float* basis, float* out, int N,
                              int nb_out, int hop, int taps, int F, int T,
                              cudaStream_t stream) {
  const size_t stage = (size_t)kBinChunk * (kBlocksPerTile + taps - 1) * 2 * sizeof(float);
  const size_t reduce = (size_t)(kBinGroups - 1) * kBlocksPerTile * kSamplesPerBlock * sizeof(float);
  const size_t smem = stage > reduce ? stage : reduce;
  int err = set_smem((const void*)synthesis_kernel, smem);
  if (err) return err;
  const dim3 grid((hop + kSamplesPerBlock - 1) / kSamplesPerBlock,
                  (nb_out + kBlocksPerTile - 1) / kBlocksPerTile, N);
  synthesis_kernel<<<grid, dim3(kSamplesPerBlock, kBinGroups), smem, stream>>>(
      reinterpret_cast<const float2*>(z), basis, out, nb_out, hop, taps, F, T);
  return (int)cudaGetLastError();
}
