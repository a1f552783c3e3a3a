// K2 — STFT analysis and ISTFT synthesis as FFTs in shared memory.
//
// Replaces the TPU's conv-formulated STFT/ISTFT (buddy_tpu/ops/stft.py:
// _stft_conv :154, _istft_conv :317), a tap sum of hop-sample blocks against
// a dense window-folded DFT basis: O(n^2) operations per frame.  Here every
// frame is a real FFT of n = n_fft points, packed as a complex FFT of
// M = n/2 points (z_k = x_2k + i x_2k+1) and split into the n/2 + 1 bins by
// a post-twiddle pass: O(n log n) per frame.
//
// What bounds it on the H100: bytes.  At the operator geometry (8 x 517
// frames of 1024, 513 bins) one call must read 2.1 MB of signal and write
// 17 MB of spectrum, ~5.7 us at 3.35 TB/s, against ~0.1 GFLOP of FFT
// (~1.6 us at 67 TFLOP/s float32).  The design therefore touches device
// memory once each way: a CTA loads the signal span of Tt consecutive
// frames into shared memory, runs the whole FFT there (Stockham stages,
// ping-pong between two buffers, no bit reversal), and stores the bins with
// the frame index fastest across threads, so that each bin's Tt frames go
// out as one contiguous run of the (N, F, T) output.  Tt is chosen per call
// from the occupancy the runtime reports: the CTAs per SM times each CTA's
// work is minimised, with at least two CTAs on every SM where the work
// allows (the operator's RIR and `cons` spectra have only ~100 frames an
// utterance and get tiles of a few frames).
//
// The plan (radices, twiddles computed in float64 and stored as float32,
// window support) is built by buddy_tpu_torch/ops/stft.py::StftPlan and read
// from device memory; the stages and butterflies are fft.cuh's, shared with
// K3.  Everything is float32 and no fast-math intrinsic is used.  Radices
// 2, 4 and 8 are butterflies without multiplies (8 with 1/sqrt(2)), 3 and 5
// butterflies with literal constants, one prime from 7 to 31 (17 for the
// model's n = 510 = 2*3*5*17) a direct DFT that pairs q with R - q.  Each
// kernel is compiled per set of radices ({2, 4, 8},
// adding {3, 5}, adding one prime), so that the power-of-two plans keep the
// registers of a radix-8 stage and not those of a 31-point DFT; those run
// 512 threads a CTA on long spectra, the others 256.  Frames of
// power-of-two length are padded by one float2 in 16 against bank conflicts
// of the strided Stockham stores.
//
// The synthesis is the analysis's adjoint: each output block of hop samples
// gathers the inverse FFTs of the taps frames that overlap it, recomputing
// the frames at a tile's edges (taps - 1 of Tb + taps - 1), and sums them
// in a fixed order: no atomics, bit-identical run to run.  Both kernels take
// per-bin weights, so the pair serves forward and backward of stft and
// istft.  Complex data is interleaved float (torch.view_as_real layout).
//
// The chirp route takes every other n_fft from 2 to 8192 (odd ones, and
// even ones whose n/2 has a prime factor above 31 or two above 5), as the
// TPU's tap basis does.  The DFT of a frame is a Bluestein step: with the
// chirp w_k = exp(-i pi k^2 / n), X_f = w_f sum_s (x_s w_s) conj(w_{f-s}), a
// linear convolution that a circular one of M >= support + F - 1 points
// holds exactly.  M is a length of the butterflies alone (8, 4, 2, 3, 5;
// the kSmall instantiation), and the convolution runs as the forward
// stages, a pointwise product with the filter's spectrum (built on the host
// in float64, divided by M) and its conjugate, and the forward stages again
// (FFT(conj(A B)) = conj(M IFFT(A B))), so no inverse stage is compiled.  A
// frame is one complex sequence with a zero imaginary part: two frames in
// one sequence would need M >= 2 n - 1, which at n = 8191 no longer fits
// a frame's two buffers in shared memory; at M <= 12288 one frame's take
// 204 KB.  The analysis reads the signal straight from device memory in its
// first stage (w_s folded in) and writes the bins as the packed route does.
// The synthesis is the adjoint: y_s = Re(w_s conj(E_s)) from the bins'
// conj(w_f bin_w z_f) through the synthesis filter (lags s - f); the frames
// of a tile of output blocks run in chunks as many as shared memory holds,
// and each output sample adds its frames in ascending order (a chunk's sum
// goes through the output itself, which only its own thread touches).

#include "fft.cuh"

namespace {

// threads per CTA: 256, or 512 for the power-of-two plans on long spectra
// (>= kLongSpectrum frames), whose tiles have enough butterflies per stage
// to keep twice the warps busy while the others wait on shared memory
constexpr int kThreads = 256, kThreadsLong = 512, kLongSpectrum = 256;
constexpr int kMaxTile = 16;            // frames (analysis) or blocks (synthesis) per CTA

constexpr int kPacked = 0, kChirp = 1;    // ops/stft.py PACKED, CHIRP

struct Plan {
  int n_fft, hop, support, M, n_stages, pad_shift, post_off;
  int radix[kMaxStages], tw_off[kMaxStages], root_off[kMaxStages];
  int route, chirp_off, ba_off, bs_off;   // M: n/2 (packed) or the convolution's length (chirp)
};

// The analysis's first stage reads the signal tile directly: packed point k
// of frame fr is window * (x[fr hop + 2k], x[fr hop + 2k + 1]), zero past
// the window's support (for the operators' hann(512) in 1024 half the
// loads of the first stage are skipped).
struct SignalLoad {
  const float* sig;
  const float* win;
  int hop, support;
  __device__ float2 operator()(int fr, int k) const {
    const int s = 2 * k;
    const float* x = sig + fr * hop + s;
    return make_float2(s < support ? __ldg(win + s) * x[0] : 0.f,
                       s + 1 < support ? __ldg(win + s + 1) * x[1] : 0.f);
  }
};

// out[n, f, t] = bin_w[f] * sum_s win[s] x[n, t hop + s] exp(-2 pi i f s / n_fft)
// x: (N, nb, hop) float, the centre-padded signal; out: (N, F, T) float2.
template <int Set, int Threads>
__global__ void __launch_bounds__(Threads, 2)
stft_analysis_kernel(const float* __restrict__ x, const float* __restrict__ win,
                     const float2* __restrict__ tab, const float* __restrict__ bin_w,
                     float2* __restrict__ out, Plan p, int nb, int T, int Tt, int FS) {
  extern __shared__ float4 smem_f4[];
  float2* buf_a = reinterpret_cast<float2*>(smem_f4);
  float2* buf_b = buf_a + Tt * FS;
  float* sig = reinterpret_cast<float*>(buf_b + Tt * FS);
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * Tt;
  const int nt = min(Tt, T - t0);
  const int F = p.M + 1;

  const int span = (nt - 1) * p.hop + p.support;
  const float* xs = x + ((size_t)n * nb + t0) * p.hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) sig[i] = xs[i];
  __syncthreads();

  const int R0 = p.radix[0];
  run_stage<Set>(R0, SignalLoad{sig, win, p.hop, p.support}, buf_a, nt, p.M, FS, p.pad_shift, 1,
            tab + p.tw_off[0], tab + p.root_off[0], p.M);
  const float2* Z = run_fft<Set>(p, tab, buf_a, buf_b, nt, FS, R0, 1, p.M);

  // real split, bins f and M - f from Z_f and Z_{M-f}; tt fastest so that
  // each bin's frames go out as one contiguous run
  const float2* post = tab + p.post_off;
  float2* on = out + (size_t)n * F * T + t0;
  const int half = p.M / 2;
  for (int i = threadIdx.x; i < nt * (half + 1); i += blockDim.x) {
    const int f = i / nt, tt = i - f * nt;
    const float2* zf = Z + tt * FS;
    if (f == 0) {
      const float2 z0 = zf[0];
      on[tt] = make_float2((z0.x + z0.y) * __ldg(bin_w), 0.f);
      on[(size_t)p.M * T + tt] = make_float2((z0.x - z0.y) * __ldg(bin_w + p.M), 0.f);
      continue;
    }
    const int g = p.M - f;
    const float2 a = zf[padded(f, p.pad_shift)], b = zf[padded(g, p.pad_shift)];
    // X_f = (Z_f + conj Z_g) / 2 - i e_f (Z_f - conj Z_g) / 2, e_f = exp(-2 pi i f / n)
    const float2 sum_f = make_float2(a.x + b.x, a.y - b.y), dif_f = make_float2(a.x - b.x, a.y + b.y);
    const float2 ef = cmul(__ldg(post + f), dif_f);
    const float wf = 0.5f * __ldg(bin_w + f);
    on[(size_t)f * T + tt] = make_float2((sum_f.x + ef.y) * wf, (sum_f.y - ef.x) * wf);
    if (g != f) {
      const float2 sum_g = make_float2(b.x + a.x, b.y - a.y), dif_g = make_float2(b.x - a.x, b.y + a.y);
      const float2 eg = cmul(__ldg(post + g), dif_g);
      const float wg = 0.5f * __ldg(bin_w + g);
      on[(size_t)g * T + tt] = make_float2((sum_g.x + eg.y) * wg, (sum_g.y - eg.x) * wg);
    }
  }
}

// out[n, b, h] = sum_{t = b - j, 0 <= j < taps, 0 <= t < T} win[s] y_t[s],  s = j hop + h < support,
// y_t[s] = sum_f bin_w[f] Re(z[n, f, t] exp(2 pi i f s / n_fft)).
// z: (N, F, T) float2; out: (N, nb_out, hop) float.
template <int Set, int Threads>
__global__ void __launch_bounds__(Threads, 2)
stft_synthesis_kernel(const float2* __restrict__ z, const float* __restrict__ win,
                      const float2* __restrict__ tab, const float* __restrict__ bin_w,
                      float* __restrict__ out, Plan p, int nb_out, int T, int Tb, int FS) {
  extern __shared__ float4 smem_f4[];
  const int taps = (p.support + p.hop - 1) / p.hop;
  const int nfr_max = Tb + taps - 1;
  float2* buf_a = reinterpret_cast<float2*>(smem_f4);
  float2* buf_b = buf_a + nfr_max * FS;
  const int n = blockIdx.y;
  const int b0 = blockIdx.x * Tb;
  const int nbt = min(Tb, nb_out - b0);
  const int tlo = max(0, b0 - taps + 1), thi = min(T, b0 + nbt);
  const int nfr = thi - tlo;
  const int F = p.M + 1;
  const int half = p.M / 2;

  // pack conj(Z), Z_f = (Y_f + conj Y_g) + i e_f^* (Y_f - conj Y_g), g = M - f,
  // with Y the weighted bins halved except DC and Nyquist (whose imaginary
  // parts are dropped): the forward FFT of conj(Z) is the conjugate of the
  // inverse FFT of Z, whose real and imaginary parts are the even and odd
  // samples of the frame
  const float2* post = tab + p.post_off;
  const float2* zn = z + (size_t)n * F * T + tlo;
  for (int i = threadIdx.x; i < nfr * (half + 1); i += blockDim.x) {
    const int f = i / nfr, tt = i - f * nfr;
    float2* o = buf_a + tt * FS;
    if (f == 0) {
      const float y0 = zn[tt].x * __ldg(bin_w), ym = zn[(size_t)p.M * T + tt].x * __ldg(bin_w + p.M);
      o[0] = make_float2(y0 + ym, -(y0 - ym));
      continue;
    }
    const int g = p.M - f;
    const float wf = 0.5f * __ldg(bin_w + f), wg = 0.5f * __ldg(bin_w + g);
    const float2 a = cscale(zn[(size_t)f * T + tt], wf), b = cscale(zn[(size_t)g * T + tt], wg);
    {
      const float2 s = make_float2(a.x + b.x, a.y - b.y), d = make_float2(a.x - b.x, a.y + b.y);
      const float2 e = __ldg(post + f);
      const float2 ed = cmul(make_float2(e.x, -e.y), d);          // e_f^* d
      o[padded(f, p.pad_shift)] = make_float2(s.x - ed.y, -(s.y + ed.x));   // conj(s + i ed)
    }
    if (g != f) {
      const float2 s = make_float2(b.x + a.x, b.y - a.y), d = make_float2(b.x - a.x, b.y + a.y);
      const float2 e = __ldg(post + g);
      const float2 ed = cmul(make_float2(e.x, -e.y), d);
      o[padded(g, p.pad_shift)] = make_float2(s.x - ed.y, -(s.y + ed.x));
    }
  }
  // points at or beyond (support + 1) / 2 are outside the window: the last
  // stage does not store them
  const float2* Y = run_fft<Set>(p, tab, buf_a, buf_b, nfr, FS, 1, 0, (p.support + 1) / 2);

  // overlap-add in a fixed order of taps
  float* on = out + ((size_t)n * nb_out + b0) * p.hop;
  for (int i = threadIdx.x; i < nbt * p.hop; i += blockDim.x) {
    const int bb = i / p.hop, h = i - bb * p.hop;
    const int b = b0 + bb;
    float acc = 0.f;
    for (int j = 0; j < taps; ++j) {
      const int t = b - j, s = j * p.hop + h;
      if (t < tlo || t >= thi || s >= p.support) continue;
      const float2 r = Y[(t - tlo) * FS + padded(s >> 1, p.pad_shift)];
      acc = fmaf(__ldg(win + s), (s & 1) ? -r.y : r.x, acc);
    }
    on[i] = acc;
  }
}


// The chirp route's first stage of the analysis: a_s = win[s] x[fr hop + s] w_s,
// zero from the window's support on.
struct ChirpSignalLoad {
  const float* sig;
  const float* win;
  const float2* chirp;
  int hop, support;
  __device__ float2 operator()(int fr, int k) const {
    if (k >= support) return make_float2(0.f, 0.f);
    const float v = __ldg(win + k) * sig[(size_t)fr * hop + k];
    const float2 c = __ldg(chirp + k);
    return make_float2(v * c.x, v * c.y);
  }
};

// ... of the synthesis: a_f = conj(bin_w[f] z[f, t0 + fr]) w_f, zero from F on.
struct ChirpSpecLoad {
  const float2* z;
  const float* bin_w;
  const float2* chirp;
  int T, F;
  __device__ float2 operator()(int fr, int k) const {
    if (k >= F) return make_float2(0.f, 0.f);
    const float2 v = z[(size_t)k * T + fr];
    const float bw = __ldg(bin_w + k);
    return cmul(make_float2(bw * v.x, -bw * v.y), __ldg(chirp + k));
  }
};

// The circular convolution of the first stage's sequences with a filter of
// spectrum filt (divided by M), returned as conj(c): the forward stages,
// A <- conj(A filt), the forward stages again.  kmax: outputs needed.
template <class Load>
__device__ const float2* chirp_convolve(const Plan& p, const float2* __restrict__ tab,
                                        const Load& load, float2* buf_a, float2* buf_b, int nfr,
                                        int FS, const float2* __restrict__ filt, int kmax) {
  const int R0 = p.radix[0];
  run_stage<kSmall>(R0, load, buf_a, nfr, p.M, FS, p.pad_shift, 1, tab + p.tw_off[0],
                    tab + p.root_off[0], p.M);
  float2* A = run_fft<kSmall>(p, tab, buf_a, buf_b, nfr, FS, R0, 1, p.M);
  for (int i = threadIdx.x; i < nfr * p.M; i += blockDim.x) {
    const int fr = i / p.M, k = i - fr * p.M;
    float2* v = A + fr * FS + padded(k, p.pad_shift);
    const float2 u = cmul(*v, __ldg(filt + k));
    *v = make_float2(u.x, -u.y);
  }
  return run_fft<kSmall>(p, tab, A, A == buf_a ? buf_b : buf_a, nfr, FS, 1, 0, kmax);
}

// As stft_analysis_kernel, for the chirp route: X_f = bin_w[f] w_f conj(E_f).
template <int Threads>
__global__ void __launch_bounds__(Threads, 2)
stft_chirp_analysis_kernel(const float* __restrict__ x, const float* __restrict__ win,
                           const float2* __restrict__ tab, const float* __restrict__ bin_w,
                           float2* __restrict__ out, Plan p, int nb, int T, int Tt, int FS) {
  extern __shared__ float4 smem_f4[];
  float2* buf_a = reinterpret_cast<float2*>(smem_f4);
  float2* buf_b = buf_a + Tt * FS;
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * Tt;
  const int nt = min(Tt, T - t0);
  const int F = p.n_fft / 2 + 1;
  const float2* chirp = tab + p.chirp_off;
  const ChirpSignalLoad load{x + ((size_t)n * nb + t0) * p.hop, win, chirp, p.hop, p.support};
  const float2* E = chirp_convolve(p, tab, load, buf_a, buf_b, nt, FS, tab + p.ba_off, F);
  float2* on = out + (size_t)n * F * T + t0;
  for (int i = threadIdx.x; i < nt * F; i += blockDim.x) {
    const int f = i / nt, tt = i - f * nt;
    const float2 e = E[tt * FS + padded(f, p.pad_shift)];
    const float2 c = cmul(__ldg(chirp + f), make_float2(e.x, -e.y));
    const float bw = __ldg(bin_w + f);
    on[(size_t)f * T + tt] = make_float2(c.x * bw, c.y * bw);
  }
}

// As stft_synthesis_kernel, for the chirp route; fc frames a chunk.
template <int Threads>
__global__ void __launch_bounds__(Threads, 2)
stft_chirp_synthesis_kernel(const float2* __restrict__ z, const float* __restrict__ win,
                            const float2* __restrict__ tab, const float* __restrict__ bin_w,
                            float* __restrict__ out, Plan p, int nb_out, int T, int Tb, int fc,
                            int FS) {
  extern __shared__ float4 smem_f4[];
  const int taps = (p.support + p.hop - 1) / p.hop;
  float2* buf_a = reinterpret_cast<float2*>(smem_f4);
  float2* buf_b = buf_a + fc * FS;
  const int n = blockIdx.y;
  const int b0 = blockIdx.x * Tb;
  const int nbt = min(Tb, nb_out - b0);
  const int tlo = max(0, b0 - taps + 1), thi = min(T, b0 + nbt);
  const int F = p.n_fft / 2 + 1;
  const float2* chirp = tab + p.chirp_off;
  float* on = out + ((size_t)n * nb_out + b0) * p.hop;
  for (int c0 = tlo; c0 < thi; c0 += fc) {
    const int nfr = min(fc, thi - c0);
    const ChirpSpecLoad load{z + (size_t)n * F * T + c0, bin_w, chirp, T, F};
    const float2* E = chirp_convolve(p, tab, load, buf_a, buf_b, nfr, FS, tab + p.bs_off,
                                     p.support);
    // each output sample adds this chunk's frames, ascending
    for (int i = threadIdx.x; i < nbt * p.hop; i += blockDim.x) {
      const int bb = i / p.hop, h = i - bb * p.hop, b = b0 + bb;
      float acc = c0 == tlo ? 0.f : on[i];
      for (int t = max(c0, b - taps + 1); t < min(c0 + nfr, b + 1); ++t) {
        const int s = (b - t) * p.hop + h;
        if (s >= p.support) continue;
        const float2 e = E[(t - c0) * FS + padded(s, p.pad_shift)], c = __ldg(chirp + s);
        acc = fmaf(__ldg(win + s), c.x * e.x + c.y * e.y, acc);
      }
      on[i] = acc;
    }
    __syncthreads();
  }
}

bool read_plan(const int* h, Plan* p) {
  p->n_fft = h[0];
  p->hop = h[1];
  p->support = h[2];
  p->M = h[3];
  p->n_stages = h[4];
  p->pad_shift = h[5];
  p->post_off = h[6];
  p->route = h[7 + 3 * kMaxStages];
  const bool chirp = p->route == kChirp;
  if (chirp) {
    p->chirp_off = h[8 + 3 * kMaxStages];
    p->ba_off = h[9 + 3 * kMaxStages];
    p->bs_off = h[10 + 3 * kMaxStages];
  }
  if (p->n_stages < 1 || p->n_stages > kMaxStages || p->hop < 1 || p->support < 1 ||
      p->support > p->n_fft || (p->route != kPacked && !chirp) ||
      (!chirp && 2 * p->M != p->n_fft) || (chirp && p->M < p->support + p->n_fft / 2))
    return false;
  int len = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = h[7 + s];
    p->tw_off[s] = h[7 + kMaxStages + s];
    p->root_off[s] = h[7 + 2 * kMaxStages + s];
    if (s < p->n_stages) {
      const int r = p->radix[s];
      if (!(r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 7 || r == 11 || r == 13 || r == 17 ||
            r == 19 || r == 23 || r == 29 || r == 31) ||
          (chirp && r != 2 && r != 3 && r != 4 && r != 5 && r != 8))
        return false;
      len *= r;
    }
  }
  return len == p->M;
}

int frame_stride(const Plan& p) { return padded(p.M - 1, p.pad_shift) + 1; }

template <int Set, int Threads>
int launch_analysis(cudaStream_t stream, const float* x, const float* win, const float* table,
                    const float* bin_w, float* out, const Plan& p, int N, int nb, int T) {
  const void* kernel = (const void*)stft_analysis_kernel<Set, Threads>;
  static const int attr = allow_smem(kernel);
  if (attr) return attr;
  const int FS = frame_stride(p);
  auto smem = [&](int tile) {
    return (size_t)2 * tile * FS * sizeof(float2) +
           (((size_t)(tile - 1) * p.hop + p.support) * sizeof(float) + 15) / 16 * 16;
  };
  const int Tt =
      choose_tile(kernel, Threads, N, T, kMaxTile, smem, [](int tile) { return tile + 1; });
  if (Tt == 0) return (int)cudaErrorInvalidValue;
  stft_analysis_kernel<Set, Threads><<<dim3((T + Tt - 1) / Tt, N), Threads, smem(Tt), stream>>>(
      x, win, reinterpret_cast<const float2*>(table), bin_w, reinterpret_cast<float2*>(out), p,
      nb, T, Tt, FS);
  return (int)cudaGetLastError();
}

template <int Set, int Threads>
int launch_synthesis(cudaStream_t stream, const float* z, const float* win, const float* table,
                     const float* bin_w, float* out, const Plan& p, int N, int nb_out, int T) {
  const void* kernel = (const void*)stft_synthesis_kernel<Set, Threads>;
  static const int attr = allow_smem(kernel);
  if (attr) return attr;
  const int FS = frame_stride(p);
  const int taps = (p.support + p.hop - 1) / p.hop;
  auto smem = [&](int tile) { return (size_t)2 * (tile + taps - 1) * FS * sizeof(float2); };
  const int Tb = choose_tile(kernel, Threads, N, nb_out, kMaxTile, smem,
                             [&](int tile) { return tile + taps; });
  if (Tb == 0) return (int)cudaErrorInvalidValue;
  stft_synthesis_kernel<Set, Threads><<<dim3((nb_out + Tb - 1) / Tb, N), Threads, smem(Tb),
                                            stream>>>(
      reinterpret_cast<const float2*>(z), win, reinterpret_cast<const float2*>(table), bin_w,
      out, p, nb_out, T, Tb, FS);
  return (int)cudaGetLastError();
}

int chirp_analysis(cudaStream_t stream, const float* x, const float* win, const float* table,
                   const float* bin_w, float* out, const Plan& p, int N, int nb, int T) {
  const void* kernel = (const void*)stft_chirp_analysis_kernel<kThreads>;
  static const int attr = allow_smem(kernel);
  if (attr) return attr;
  const int FS = frame_stride(p);
  auto smem = [&](int tile) { return (size_t)2 * tile * FS * sizeof(float2); };
  const int Tt =
      choose_tile(kernel, kThreads, N, T, kMaxTile, smem, [](int tile) { return tile + 1; });
  if (Tt == 0) return (int)cudaErrorInvalidValue;
  stft_chirp_analysis_kernel<kThreads><<<dim3((T + Tt - 1) / Tt, N), kThreads, smem(Tt),
                                         stream>>>(
      x, win, reinterpret_cast<const float2*>(table), bin_w, reinterpret_cast<float2*>(out), p,
      nb, T, Tt, FS);
  return (int)cudaGetLastError();
}

int chirp_synthesis(cudaStream_t stream, const float* z, const float* win, const float* table,
                    const float* bin_w, float* out, const Plan& p, int N, int nb_out, int T) {
  const void* kernel = (const void*)stft_chirp_synthesis_kernel<kThreads>;
  static const int attr = allow_smem(kernel);
  if (attr) return attr;
  const int FS = frame_stride(p);
  const int taps = (p.support + p.hop - 1) / p.hop;
  const int fit = (int)(kSmemMax / (2 * FS * sizeof(float2)));      // frames a chunk can hold
  auto chunk = [&](int tile) { return tile + taps - 1 < fit ? tile + taps - 1 : fit; };
  auto smem = [&](int tile) { return (size_t)2 * chunk(tile) * FS * sizeof(float2); };
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int Tb = choose_tile(kernel, kThreads, N, nb_out, kMaxTile, smem,
                             [&](int tile) { return tile + taps; });
  if (Tb == 0) return (int)cudaErrorInvalidValue;
  stft_chirp_synthesis_kernel<kThreads><<<dim3((nb_out + Tb - 1) / Tb, N), kThreads, smem(Tb),
                                          stream>>>(
      reinterpret_cast<const float2*>(z), win, reinterpret_cast<const float2*>(table), bin_w,
      out, p, nb_out, T, Tb, chunk(Tb), FS);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stft_analysis(const float* x, const float* win, const float* table,
                             const float* bin_w, float* out, const int* header, int N, int nb,
                             int T, cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (p.route == kChirp) return chirp_analysis(stream, x, win, table, bin_w, out, p, N, nb, T);
  switch (radix_set(p)) {
#define LAUNCH(set, threads) \
  return launch_analysis<set, threads>(stream, x, win, table, bin_w, out, p, N, nb, T)
    case kPow2:
      if (T >= kLongSpectrum) LAUNCH(kPow2, kThreadsLong);
      LAUNCH(kPow2, kThreads);
    case kSmall: LAUNCH(kSmall, kThreads);
    case 7: LAUNCH(7, kThreads);
    case 11: LAUNCH(11, kThreads);
    case 13: LAUNCH(13, kThreads);
    case 17: LAUNCH(17, kThreads);
    case 19: LAUNCH(19, kThreads);
    case 23: LAUNCH(23, kThreads);
    case 29: LAUNCH(29, kThreads);
    case 31: LAUNCH(31, kThreads);
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int stft_synthesis(const float* z, const float* win, const float* table,
                              const float* bin_w, float* out, const int* header, int N,
                              int nb_out, int T, cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (nb_out != T + (p.support + p.hop - 1) / p.hop - 1) return (int)cudaErrorInvalidValue;
  if (p.route == kChirp) return chirp_synthesis(stream, z, win, table, bin_w, out, p, N, nb_out, T);
  switch (radix_set(p)) {
#define LAUNCH(set, threads) \
  return launch_synthesis<set, threads>(stream, z, win, table, bin_w, out, p, N, nb_out, T)
    case kPow2:
      if (T >= kLongSpectrum) LAUNCH(kPow2, kThreadsLong);
      LAUNCH(kPow2, kThreads);
    case kSmall: LAUNCH(kSmall, kThreads);
    case 7: LAUNCH(7, kThreads);
    case 11: LAUNCH(11, kThreads);
    case 13: LAUNCH(13, kThreads);
    case 17: LAUNCH(17, kThreads);
    case 19: LAUNCH(19, kThreads);
    case 23: LAUNCH(23, kThreads);
    case 29: LAUNCH(29, kThreads);
    case 31: LAUNCH(31, kThreads);
#undef LAUNCH
    default: return (int)cudaErrorInvalidValue;
  }
}
