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
// from device memory; everything is float32 and no fast-math intrinsic is
// used.  Radices 2, 4 and 8 are butterflies without multiplies (8 with
// 1/sqrt(2)), 3 and 5 butterflies with literal constants, one prime from 7
// to 31 (17 for the model's n = 510 = 2*3*5*17) a direct DFT that pairs q
// with R - q.  Each kernel is compiled per set of radices ({2, 4, 8},
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

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kMaxStages = 12;          // ops/stft.py MAX_STAGES
// threads per CTA: 256, or 512 for the power-of-two plans on long spectra
// (>= kLongSpectrum frames), whose tiles have enough butterflies per stage
// to keep twice the warps busy while the others wait on shared memory
constexpr int kThreads = 256, kThreadsLong = 512, kLongSpectrum = 256;
constexpr int kMaxTile = 16;            // frames (analysis) or blocks (synthesis) per CTA
constexpr size_t kSmemMax = 227 * 1024;

struct Plan {
  int n_fft, hop, support, M, n_stages, pad_shift, post_off;
  int radix[kMaxStages], tw_off[kMaxStages], root_off[kMaxStages];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }   // -i a
__host__ __device__ __forceinline__ int padded(int i, int shift) { return i + (i >> shift); }

// In-place forward DFT of R points: v_q <- sum_r v_r exp(-2 pi i r q / R).
template <int R>
__device__ __forceinline__ void dft(float2* v, const float2* __restrict__ roots) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (R == 4) {
    const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
    const float2 a2 = cadd(v[1], v[3]), a3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(a0, a2);
    v[2] = csub(a0, a2);
    v[1] = cadd(a1, a3);
    v[3] = csub(a1, a3);
  } else if constexpr (R == 8) {
    // two 4-point DFTs of the even and odd points, joined by W8^q
    constexpr float kH = 0.707106781186547524f;   // 1 / sqrt(2)
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e, roots);
    dft<4>(o, roots);
    o[1] = make_float2(kH * (o[1].x + o[1].y), kH * (o[1].y - o[1].x));   // (1 - i) / sqrt(2)
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(kH * (o[3].y - o[3].x), -kH * (o[3].x + o[3].y));  // (-1 - i) / sqrt(2)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = cadd(e[q], o[q]);
      v[q + 4] = csub(e[q], o[q]);
    }
  } else if constexpr (R == 3) {
    constexpr float kS = 0.866025403784438647f;   // sin(2 pi / 3)
    const float2 t1 = cadd(v[1], v[2]);
    const float2 t2 = make_float2(fmaf(-0.5f, t1.x, v[0].x), fmaf(-0.5f, t1.y, v[0].y));
    const float2 t3 = mul_mi(cscale(csub(v[1], v[2]), kS));
    v[0] = cadd(v[0], t1);
    v[1] = cadd(t2, t3);
    v[2] = csub(t2, t3);
  } else if constexpr (R == 5) {
    constexpr float kC1 = 0.309016994374947424f, kC2 = -0.809016994374947424f;   // cos(2pi/5), cos(4pi/5)
    constexpr float kS1 = 0.951056516295153572f, kS2 = 0.587785252292473129f;    // sin(2pi/5), sin(4pi/5)
    const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
    const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
    const float2 v0 = v[0];
    const float2 c1 = make_float2(v0.x + kC1 * a1.x + kC2 * a2.x, v0.y + kC1 * a1.y + kC2 * a2.y);
    const float2 c2 = make_float2(v0.x + kC2 * a1.x + kC1 * a2.x, v0.y + kC2 * a1.y + kC1 * a2.y);
    const float2 s1 = mul_mi(make_float2(kS1 * b1.x + kS2 * b2.x, kS1 * b1.y + kS2 * b2.y));
    const float2 s2 = mul_mi(make_float2(kS2 * b1.x - kS1 * b2.x, kS2 * b1.y - kS1 * b2.y));
    v[0] = cadd(v0, cadd(a1, a2));
    v[1] = cadd(c1, s1);
    v[4] = csub(c1, s1);
    v[2] = cadd(c2, s2);
    v[3] = csub(c2, s2);
  } else {
    // odd prime: with a_r = v_r + v_{R-r}, b_r = v_r - v_{R-r} and roots
    // w_m = (cos, -sin)(2 pi m / R): v_q = v0 + sum_r a_r cos + i b_r w.y,
    // v_{R-q} the same with the sine term negated
    constexpr int H = (R - 1) / 2;
    float2 a[H], b[H];
    const float2 v0 = v[0];
    float2 sum = v0;
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      a[r - 1] = cadd(v[r], v[R - r]);
      b[r - 1] = csub(v[r], v[R - r]);
      sum = cadd(sum, a[r - 1]);
    }
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      float2 c = v0, s = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 w = __ldg(roots + (r * q) % R);
        c = make_float2(fmaf(a[r - 1].x, w.x, c.x), fmaf(a[r - 1].y, w.x, c.y));
        s = make_float2(fmaf(b[r - 1].x, w.y, s.x), fmaf(b[r - 1].y, w.y, s.y));
      }
      v[q] = make_float2(c.x - s.y, c.y + s.x);        // c + i s
      v[R - q] = make_float2(c.x + s.y, c.y - s.x);    // c - i s
    }
    v[0] = sum;
  }
}

// One Stockham stage of radix R over nfr frames: butterfly j of a frame
// reads points j + r M/R, twiddles them by exp(-2 pi i k r / (Ns R)) with
// k = j mod Ns, and writes its outputs to (j - k) R + k + q Ns.  Outputs at
// or beyond kmax are not needed and not stored.  A thread keeps one j (and,
// for the small radices, its twiddles in registers) across the frames it
// visits, so the loop has no integer division; where a frame has fewer
// butterflies than the block has threads, frames are taken side by side.
template <int R, class Load>
__device__ void stage(const Load& load, float2* __restrict__ dst, int nfr, int M, int FS,
                      int shift, int Ns, const float2* __restrict__ tw,
                      const float2* __restrict__ roots, int kmax) {
  constexpr bool kKeepTwiddles = R <= 8;
  const int nb = M / R;
  int j0 = threadIdx.x, jstep = blockDim.x, fr0 = 0, frstep = 1;
  if (nb < (int)blockDim.x) {
    frstep = blockDim.x / nb;
    fr0 = threadIdx.x / nb;
    j0 = threadIdx.x - fr0 * nb;
    jstep = nb;
    if (fr0 >= frstep) return;
  }
  for (int j = j0; j < nb; j += jstep) {
    const int k = j % Ns;
    const float2* t = tw + k * (R - 1);
    float2 tk[kKeepTwiddles ? R - 1 : 1];
    if constexpr (kKeepTwiddles) {
#pragma unroll
      for (int r = 1; r < R; ++r) tk[r - 1] = k > 0 ? __ldg(t + r - 1) : make_float2(1.f, 0.f);
    }
    const int d = (j - k) * R + k;
    for (int fr = fr0; fr < nfr; fr += frstep) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = load(fr, j + r * nb);
      if (k > 0) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], kKeepTwiddles ? tk[r - 1] : __ldg(t + r - 1));
      }
      dft<R>(v, roots);
      float2* o = dst + fr * FS;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int idx = d + q * Ns;
        if (idx < kmax) o[padded(idx, shift)] = v[q];
      }
    }
  }
}

// The radices a kernel is compiled for: {2, 4, 8} (Set = kPow2), adding 3
// and 5 (kSmall), or also the plan's direct-DFT prime P (Set = P).
constexpr int kPow2 = 0, kSmall = 1;

template <int Set, class Load>
__device__ void run_stage(int R, const Load& load, float2* dst, int nfr, int M, int FS, int shift,
                          int Ns, const float2* tw, const float2* roots, int kmax) {
#define STAGE(r) stage<r>(load, dst, nfr, M, FS, shift, Ns, tw, roots, kmax)
  if (R == 8) {
    STAGE(8);
  } else if (R == 4) {
    STAGE(4);
  } else if (R == 2) {
    STAGE(2);
  } else if constexpr (Set != kPow2) {
    if (R == 3) {
      STAGE(3);
    } else if (R == 5) {
      STAGE(5);
    } else if constexpr (Set > 5) {
      STAGE(Set);
    }
  }
#undef STAGE
}

struct SmemLoad {
  const float2* src;
  int FS, shift;
  __device__ float2 operator()(int fr, int k) const { return src[fr * FS + padded(k, shift)]; }
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

// The stages from `first` on, ping-pong between a and b (Ns: the length of
// the stages before); returns the buffer that holds the result.
template <int Set>
__device__ float2* run_fft(const Plan& p, const float2* __restrict__ tab, float2* a, float2* b,
                           int nfr, int FS, int Ns, int first, int kmax_last) {
  for (int s = first; s < p.n_stages; ++s) {
    __syncthreads();
    const int R = p.radix[s];
    run_stage<Set>(R, SmemLoad{a, FS, p.pad_shift}, b, nfr, p.M, FS, p.pad_shift, Ns,
              tab + p.tw_off[s], tab + p.root_off[s], s == p.n_stages - 1 ? kmax_last : p.M);
    Ns *= R;
    float2* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  return a;
}

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

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

bool read_plan(const int* h, Plan* p) {
  p->n_fft = h[0];
  p->hop = h[1];
  p->support = h[2];
  p->M = h[3];
  p->n_stages = h[4];
  p->pad_shift = h[5];
  p->post_off = h[6];
  if (p->n_stages < 1 || p->n_stages > kMaxStages || 2 * p->M != p->n_fft || p->hop < 1 ||
      p->support < 1 || p->support > p->n_fft)
    return false;
  int len = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = h[7 + s];
    p->tw_off[s] = h[7 + kMaxStages + s];
    p->root_off[s] = h[7 + 2 * kMaxStages + s];
    if (s < p->n_stages) {
      const int r = p->radix[s];
      if (!(r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 7 || r == 11 || r == 13 || r == 17 ||
            r == 19 || r == 23 || r == 29 || r == 31))
        return false;
      len *= r;
    }
  }
  return len == p->M;
}

int frame_stride(const Plan& p) { return padded(p.M - 1, p.pad_shift) + 1; }

// CTAs of `kernel` an SM holds at `smem` bytes each, asked of the runtime
// once per pair: the launches are tens of microseconds, the query is not
// free on the host.
int ctas_per_sm(const void* kernel, int threads, size_t smem) {
  static std::mutex lock;
  static std::map<std::pair<const void*, size_t>, int> known;   // threads: fixed per kernel
  const std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_pair(kernel, smem);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem)) n = 0;
    it = known.emplace(key, n).first;
  }
  return it->second;
}

// The tile (frames or blocks per CTA) that minimises the CTAs per SM times
// each CTA's work, among the tiles that keep two CTAs on an SM and give
// every SM two of them where the work allows (the operator's short RIR
// spectra, ~100 frames an utterance, get tiles of a few frames); 0 if
// not even one frame fits.
template <class Smem, class Work>
int choose_tile(const void* kernel, int threads, int N, int count, Smem smem, Work work) {
  const long sms = sm_count();
  int best = 0;
  long best_cost = 0;
  bool best_ok = false;
  for (int tile = kMaxTile; tile >= 1; --tile) {
    const size_t bytes = smem(tile);
    if (bytes > kSmemMax) continue;
    const int per_sm = ctas_per_sm(kernel, threads, bytes);
    if (per_sm < 1) continue;
    const long ctas = (long)N * ((count + tile - 1) / tile);
    const bool ok = per_sm >= 2 && ctas >= 2 * sms;
    const long cost = (ctas + sms - 1) / sms * work(tile);
    if (best == 0 || (ok && !best_ok) || (ok == best_ok && cost < best_cost)) {
      best = tile;
      best_cost = cost;
      best_ok = ok;
    }
  }
  return best;
}

int allow_smem(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemMax);
}

// kPow2, kSmall or the one direct-DFT prime; -1 for radices no kernel has
int radix_set(const Plan& p) {
  int set = kPow2;
  for (int s = 0; s < p.n_stages; ++s) {
    const int r = p.radix[s];
    if (r == 3 || r == 5) {
      set = set == kPow2 ? kSmall : set;
    } else if (r != 2 && r != 4 && r != 8) {
      if (set > 5 && set != r) return -1;
      set = r;
    }
  }
  return set;
}

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
  const int Tt = choose_tile(kernel, Threads, N, T, smem, [](int tile) { return tile + 1; });
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
  const int Tb = choose_tile(kernel, Threads, N, nb_out, smem, [&](int tile) { return tile + taps; });
  if (Tb == 0) return (int)cudaErrorInvalidValue;
  stft_synthesis_kernel<Set, Threads><<<dim3((nb_out + Tb - 1) / Tb, N), Threads, smem(Tb),
                                            stream>>>(
      reinterpret_cast<const float2*>(z), win, reinterpret_cast<const float2*>(table), bin_w,
      out, p, nb_out, T, Tb, FS);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stft_analysis(const float* x, const float* win, const float* table,
                             const float* bin_w, float* out, const int* header, int N, int nb,
                             int T, cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || N < 1 || T < 1) return (int)cudaErrorInvalidValue;
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
