// K3 — subband frame convolution: a complex FIR along the STFT frame axis,
// one independent filter per (utterance, frequency bin), by FFTs of every
// row in shared memory.
//
// Replaces the TPU's overlap-save matmul DFTs in
// buddy_tpu/operators/subband.py: SubbandFiltering.subband_filtering :76
// (with frame_fft :132, _frame_fft_os :122, dft.cfft and dft.icfft_slice).
//
//   forward:  Y[b,f,t]  = sum_{j<Nf} H[b,f,j] * X[b,f,t+pre-j]
//   adjoint:  dX[b,f,s] = sum_{j<Nf} conj(H[b,f,j]) * G[b,f,s-pre+j]
//   filter:   dH[b,f,j] = sum_t G[b,f,t] * conj(X[b,f,t+pre-j])
// with zeros outside [0, T).  The two backward formulas follow torch's
// complex-gradient convention (G = dL/dRe Y + i dL/dIm Y).
//
// One kernel serves all three, and the frame spectrum: with n >= T + Nf - 1
// (ops/fft_plan.py::conv_fft_size, 640 = 8 8 2 5 at the main path's 517
// frames and 100 taps) each is one circular product of two rows,
//   r = ifft(fft(a) * fft(b))          (forward: a = H, b = X)
//   r = ifft(fft(a) * conj(fft(b)))    (adjoint: a = G, b = H; filter: a = G, b = X)
// with G placed at offset pre in its row of n, so that the wanted outputs
// are r[pre + t] (forward), r[s] (adjoint) and r[j] (filter) without
// wrapping.  The second operand's spectrum may come precomputed (the
// hoisted frame spectrum of the observation, `spectrum` mode of this same
// kernel), which saves one of the three transforms of a row.
//
// What bounds it on the H100: bytes.  At the main path's shape (8 x 513
// rows, T = 517, Nf = 100) the forward must read X and H once and write Y
// once, 37.5 MB, ~11 us at 3.35 TB/s, against ~0.6 GFLOP of FFTs (5 n log2 n
// a transform, three a row), ~9 us at 67 TFLOP/s float32.  The design
// therefore touches device memory once each way: a CTA takes a tile of
// rows (chosen from the occupancy, as K2 does) and copies the operands'
// rows and the precomputed spectrum's rows into shared memory
// asynchronously (cp.async: the spectrum arrives while the first transform
// runs); the first stage reads them there (zero outside a row's support),
// the stages run in shared memory (fft.cuh, frames padded against bank
// conflicts by ops/fft_plan.py::pad_shift), the product
// is formed there, the inverse runs the forward stages on the conjugate
// (its last stage stores only the outputs that are kept), and each row's
// outputs go out as one contiguous run.  There are no atomics: results are bit-identical run
// to run.  Complex data is interleaved float (torch.view_as_real layout).

#include <cuda_pipeline.h>

#include "fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;             // (utterance, bin) rows per CTA

struct Plan {
  int M, n_stages, pad_shift;
  int radix[kMaxStages], tw_off[kMaxStages], root_off[kMaxStages];
};

// One launch: the operands of row r = b F + f.  a: the first operand, a_len
// points placed at [a_off, a_off + a_len) of the row of n; b: the second,
// at offset 0 (nullptr when its spectrum `spec` is given, n points a row);
// strides between utterances in complex elements (0 broadcasts one row).
// Without b and spec the kernel writes fft(a) (n points a row) to out.
struct Args {
  const float2* a;
  const float2* b;
  const float2* spec;
  float2* out;
  long long a_bstride, b_bstride, spec_bstride;
  int a_len, a_off, b_len, conj_b, out_off, out_len, F, rows;
};

// Per-frame row pointers of a CTA, at the start of its dynamic shared memory.
struct alignas(16) Meta {
  const float2* base[2 * kMaxRows];
  const float2* spec_row[kMaxRows];
  int off[2 * kMaxRows], len[2 * kMaxRows];
};

// The first stage's loader: point k of frame fr from the rows copied into
// shared memory (unpadded, at stride FS), zero outside the frame's support
// [off, off + len).
struct RowLoad {
  const float2* rows;
  int FS;
  const int* off;
  const int* len;
  __device__ float2 operator()(int fr, int k) const {
    const int i = k - off[fr];
    return (unsigned)i < (unsigned)len[fr] ? rows[fr * FS + i] : make_float2(0.f, 0.f);
  }
};

// Asynchronous copies of rows fr0 .. fr0 + nfr - 1 (len points each, from
// base[fr]) into dst at stride ds: every thread issues its share without
// waiting, and the CTA waits for them where it needs them.
__device__ void copy_rows_async(float2* dst, int ds, const float2* const* base, int fr0, int nfr,
                                int len) {
  const int total = nfr * len;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int fr = i / len, k = i - fr * len;
    __pipeline_memcpy_async(dst + (size_t)(fr0 + fr) * ds + k, base[fr0 + fr] + k, sizeof(float2));
  }
}

template <int Set>
__global__ void __launch_bounds__(kThreads, 2)
subband_fft_conv_kernel(Args g, Plan p, const float2* __restrict__ tab, int Rt, int FS) {
  extern __shared__ float4 smem_f4[];
  Meta& m = *reinterpret_cast<Meta*>(smem_f4);
  const bool two = g.b != nullptr;          // the second operand is transformed here
  const bool spectrum = !two && g.spec == nullptr;
  const int r0 = blockIdx.x * Rt;
  const int nrows = min(Rt, g.rows - r0);
  const int nfr = two ? 2 * nrows : nrows;
  float2* buf_a = reinterpret_cast<float2*>(smem_f4 + sizeof(Meta) / sizeof(float4));
  float2* buf_b = buf_a + (two ? 2 : 1) * Rt * FS;
  float2* spec_s = buf_b + (two ? 2 : 1) * Rt * FS;   // the precomputed spectrum's rows

  // frames [0, nrows): operand a of rows r0..; [nrows, 2 nrows): operand b
  if (threadIdx.x < nfr) {
    const int fr = threadIdx.x;
    const bool second = fr >= nrows;
    const int r = r0 + (second ? fr - nrows : fr);
    const int b = r / g.F, f = r - b * g.F;
    if (second) {
      m.base[fr] = g.b + b * g.b_bstride + (size_t)f * g.b_len;
      m.off[fr] = 0;
      m.len[fr] = g.b_len;
    } else {
      m.base[fr] = g.a + b * g.a_bstride + (size_t)f * g.a_len;
      m.off[fr] = g.a_off;
      m.len[fr] = g.a_len;
      if (g.spec != nullptr) m.spec_row[fr] = g.spec + b * g.spec_bstride + (size_t)f * p.M;
    }
  }
  __syncthreads();

  // the operands' rows into buf_b (free until the second stage) and the
  // precomputed spectrum's rows into spec_s, in flight together; the first
  // stage waits for the operands only
  copy_rows_async(buf_b, FS, m.base, 0, nrows, g.a_len);
  if (two) copy_rows_async(buf_b, FS, m.base, nrows, nrows, g.b_len);
  __pipeline_commit();
  if (g.spec != nullptr) copy_rows_async(spec_s, p.M, m.spec_row, 0, nrows, p.M);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  const int R0 = p.radix[0];
  run_stage<Set>(R0, RowLoad{buf_b, FS, m.off, m.len}, buf_a, nfr, p.M, FS, p.pad_shift, 1,
                 tab + p.tw_off[0], tab + p.root_off[0], p.M);
  float2* Z = run_fft<Set>(p, tab, buf_a, buf_b, nfr, FS, R0, 1, p.M);
  __pipeline_wait_prior(0);
  __syncthreads();

  if (spectrum) {
    for (int fr = 0; fr < nrows; ++fr) {
      float2* o = g.out + (size_t)(r0 + fr) * p.M;
      for (int k = threadIdx.x; k < p.M; k += blockDim.x)
        o[k] = Z[fr * FS + padded(k, p.pad_shift)];
    }
    return;
  }

  // conj(fft(a) * fft(b)) (or * conj(fft(b))) into the other buffer: the
  // forward stages on it give n times the conjugate of the inverse
  float2* P = Z == buf_a ? buf_b : buf_a;
  for (int fr = 0; fr < nrows; ++fr) {
    const float2* za = Z + fr * FS;
    const float2* zb = two ? Z + (nrows + fr) * FS : spec_s + fr * p.M;
    float2* o = P + fr * FS;
    for (int k = threadIdx.x; k < p.M; k += blockDim.x) {
      const int kp = padded(k, p.pad_shift);
      float2 v = zb[two ? kp : k];
      if (g.conj_b) v.y = -v.y;
      const float2 q = cmul(za[kp], v);
      o[kp] = make_float2(q.x, -q.y);
    }
  }
  const float2* Rv = run_fft<Set>(p, tab, P, Z, nrows, FS, 1, 0,
                                  g.out_off + g.out_len);

  const float inv = 1.f / (float)p.M;
  for (int fr = 0; fr < nrows; ++fr) {
    const float2* src = Rv + fr * FS;
    float2* o = g.out + (size_t)(r0 + fr) * g.out_len;
    for (int i = threadIdx.x; i < g.out_len; i += blockDim.x) {
      const float2 v = src[padded(g.out_off + i, p.pad_shift)];
      o[i] = make_float2(v.x * inv, -v.y * inv);
    }
  }
}

bool read_plan(const int* h, Plan* p) {
  p->M = h[0];
  p->n_stages = h[1];
  p->pad_shift = h[2];
  if (p->n_stages < 1 || p->n_stages > kMaxStages || p->M < 2) return false;
  int len = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = h[3 + s];
    p->tw_off[s] = h[3 + kMaxStages + s];
    p->root_off[s] = h[3 + 2 * kMaxStages + s];
    if (s < p->n_stages) len *= p->radix[s];
  }
  return len == p->M;
}

template <int Set>
int launch(cudaStream_t stream, const Args& g, const Plan& p, const float* table) {
  const void* kernel = (const void*)subband_fft_conv_kernel<Set>;
  static const int attr = allow_smem(kernel);
  if (attr) return attr;
  const int FS = padded(p.M - 1, p.pad_shift) + 1;
  const int frames = g.b != nullptr ? 2 : 1;
  const int spec_points = g.spec != nullptr ? p.M : 0;
  auto smem = [&](int tile) {
    return sizeof(Meta) + ((size_t)2 * frames * FS + spec_points) * tile * sizeof(float2);
  };
  const int Rt = choose_tile(kernel, kThreads, 1, g.rows, kMaxRows, smem,
                             [](int tile) { return tile + 1; });
  if (Rt == 0) return (int)cudaErrorInvalidValue;
  subband_fft_conv_kernel<Set><<<(g.rows + Rt - 1) / Rt, kThreads, smem(Rt), stream>>>(
      g, p, reinterpret_cast<const float2*>(table), Rt, FS);
  return (int)cudaGetLastError();
}

}  // namespace

// rows = B F; a, b, spec, out: interleaved complex float.  out holds B F
// rows of out_len points: r[out_off + i] of the circular product, or the
// spectrum of a (n points a row) when b and spec are both null.
extern "C" int subband_fft_conv(const float* a, long long a_bstride, int a_len, int a_off,
                                const float* b, long long b_bstride, int b_len,
                                const float* spec, long long spec_bstride, int conj_b,
                                float* out, int out_off, int out_len, int B, int F,
                                const int* header, const float* table, cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || B < 1 || F < 1 || a_len < 1 || a_off < 0 ||
      a_off + a_len > p.M || (b != nullptr && (b_len < 1 || b_len > p.M)) || out_off < 0 ||
      out_len < 1 || out_off + out_len > p.M)
    return (int)cudaErrorInvalidValue;
  Args g{reinterpret_cast<const float2*>(a), reinterpret_cast<const float2*>(b),
         reinterpret_cast<const float2*>(spec), reinterpret_cast<float2*>(out),
         a_bstride, b_bstride, spec_bstride, a_len, a_off, b_len, conj_b, out_off, out_len,
         F, B * F};
  switch (radix_set(p)) {
#define LAUNCH(set) return launch<set>(stream, g, p, table)
    case kPow2: LAUNCH(kPow2);
    case kSmall: LAUNCH(kSmall);
    case 7: LAUNCH(7);
    case 11: LAUNCH(11);
    case 13: LAUNCH(13);
    case 17: LAUNCH(17);
    case 19: LAUNCH(19);
    case 23: LAUNCH(23);
    case 29: LAUNCH(29);
    case 31: LAUNCH(31);
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}
