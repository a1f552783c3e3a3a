// Complex FFTs in shared memory for Hopper, shared by K2 (stft.cu) and K3
// (subband_conv.cu): Stockham stages over several frames at once, the
// butterflies, and the host-side choice of a tile from the occupancy.
//
// A plan (the caller's struct, with the members M, n_stages, pad_shift and
// per stage radix, tw_off and root_off) is built on the host by
// buddy_tpu_torch/ops/fft_plan.py: radices 8, 4, 2, 3, 5 and at most one
// prime from 7 to 31 (a direct DFT), twiddles computed in float64 and
// stored as float32 in a table read from device memory.  Everything is
// float32 and no fast-math intrinsic is used.  A stage reads its R inputs
// through a loader (shared memory, or the caller's own for a first stage
// straight from device memory) and stores to a ping-pong buffer; frames of
// power-of-two length are padded by one float2 in 16 against bank
// conflicts of the strided stores.  Each file that includes this header
// compiles its own copy (everything is in an anonymous namespace).

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kMaxStages = 12;          // ops/fft_plan.py MAX_STAGES
constexpr size_t kSmemMax = 227 * 1024;

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

// The stages from `first` on, ping-pong between a and b (Ns: the length of
// the stages before); returns the buffer that holds the result.
template <int Set, class Plan>
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

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

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

// The tile (frames, blocks or rows per CTA, at most max_tile) that minimises the CTAs per SM times
// each CTA's work, among the tiles that keep two CTAs on an SM and give
// every SM two of them where the work allows (the operator's short RIR
// spectra, ~100 frames an utterance, get tiles of a few frames); 0 if
// not even one frame fits.
template <class Smem, class Work>
int choose_tile(const void* kernel, int threads, int N, int count, int max_tile, Smem smem,
                Work work) {
  const long sms = sm_count();
  int best = 0;
  long best_cost = 0;
  bool best_ok = false;
  for (int tile = max_tile; tile >= 1; --tile) {
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
template <class Plan>
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

}  // namespace
