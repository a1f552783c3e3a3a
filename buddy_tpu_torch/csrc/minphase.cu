// K5 — the minimum-phase projection of the blind operator's RIR, forward and
// backward, each direction one launch with its transforms inside.
//
// Replaces buddy_tpu/ops/minphase.py::minimum_phase_version (:38, with
// hilbert :27) and the DFTs it runs through, buddy_tpu/ops/dft.py cfft
// (:208) and _cfft_2stage (:241, two matmul-DFT stages for the TPU).  For a
// real row h of L samples and n = 2L:
//
//   H = fft(h, n),  m = |H|,  phi = -Im ifft(w fft(log(m + 1e-8))),
//   y = Re ifft(m e^{i phi})[:L],
//
// w the flipped 2 heaviside(linspace(-1, 1, n)): 2 on [0, n/2), 0 on
// [n/2, n) for the even n used here (w[0] = 2, w[n/2] = 0: the JAX
// semantics, not the textbook cepstral fold).  The backward is the
// explicit formula of buddy_tpu_torch/ops/minphase.py
// (minimum_phase_backward_plain), zero gradient where |H| = 0.
//
// Every sequence of the chain is real with a symmetry: m and log m are
// even, phi is odd, ifft(m e^{i phi}) is real; in the backward the spectrum
// of the phase's gradient is real and odd.  So each of the four transforms
// a direction is a real FFT of n points, packed as a complex FFT of L = n/2
// points (z_j = x_2j + i x_2j+1) and split into (or, for the last, formed
// from) the n/2 + 1 bins of a half spectrum.  The forward saves the half
// spectra of H and phi for the backward (12 bytes a bin).
//
// What bounds it on the H100: neither bytes nor operations.  A row moves
// 100 KB and needs ~2 MFLOP; the main path has only B = 8 rows, and the
// eager chain this replaces (four cuFFT calls, four passes, pads and casts)
// spent its time in host dispatch between ~10 launches.  Here each row is
// one thread-block cluster of kCluster CTAs (a non-portable size, 128 CTAs
// for the 8 rows), and the whole chain runs inside it in one launch; what
// bounds it is the latency of its steps and of the cluster barriers.
//
// The L points run as a four-step FFT, L = N1 x N2 (128 x 101 at the main
// path's L = 12928, ops/fft_plan.py::MinPhasePlan): CTA c gathers the
// points of a block of the N2 columns (points N2 j1 + j2), neighbouring
// threads on neighbouring points, runs their N1-point FFTs through
// fft.cuh's Stockham stages in shared memory, twiddles each output by
// exp(-2 pi i j2 k1 / L) and writes it to the row's exchange buffer.  After
// a cluster barrier, each CTA reads its k1 (in runs of neighbouring k1) and
// runs their N2-point DFTs (bins k1 + N1 k2) as direct sums in the paired
// form of fft.cuh's odd-prime butterfly, two output pairs a thread (101
// points: 202 registers in fft.cuh's register butterfly would spill), then
// the chain's elementwise pass on its bins, which writes the half spectrum
// the next transform gathers.  A CTA owns k1 together with N1 - k1, so the
// real split, which pairs bin f with L - f, never leaves the CTA.  The
// exchanges go through a scratch of 16 (L + 1) bytes a row in device memory
// (it stays in the L2), read with ld.global.cg; through distributed shared
// memory (the CTAs reading and writing each other's shared memory, one
// 8-byte access a lane) the same kernel was slower on the card (PERF.md,
// Findings).  Two cluster barriers a transform: after the exchange,
// and after the elementwise pass.  Every sum runs in a fixed order: two
// calls give identical bits.  Everything is float32 and no fast-math
// intrinsic is used.
//
// Every row length from 2 to 66560 runs (ops/fft_plan.py::minphase_route).
// The direct DFT takes N2 up to kMaxN2 = 1040 (its cost grows with N2: the
// 128 x 513 of an RIR as long as the tester's utterance costs five times
// the main path's 128 x 101 a point); that needs the column buffers and the
// rows to share their shared memory (below).  A length with no such
// factorisation (a prime, or a large prime times a small factor) takes a
// Bluestein step instead: Z_f = w_f sum_j (z_j w_j) conj(w_{f-j}), the chirp
// w_j = exp(-i pi j^2 / L), as a circular convolution of N = N1 N2 >= 2L - 1
// points (N1 = 128): the four-step FFT of N, the product with the filter's
// spectrum (built on the host in float64, divided by N) and its conjugate
// through the row's scratch, the four-step FFT again, and Z (natural
// order) through the scratch once more.  Its bins then leave the owner
// layout, so the chain's elementwise passes take runs of f a CTA from the
// scratch and keep their state in shared memory by the run's index; the
// route costs two more cluster barriers a transform.  The direct route
// is chosen where it costs fewer operations (the main path's 128 x 101
// keeps its plan and its bits).

#include <cooperative_groups.h>

#include "fft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;      // ops/fft_plan.py MINPHASE_CLUSTER: CTAs a row
constexpr int kMaxN1 = 128;       // MINPHASE_MAX_N1
constexpr int kMaxN2 = 1040;      // MINPHASE_MAX_N2
constexpr int kMaxSlots = 32;     // MINPHASE_MAX_SLOTS
constexpr int kThreads = 256;
constexpr int kLoads = 4;         // loads from the L2 a thread has in flight
constexpr float kEps = 1e-8f;
constexpr int kDirect = 0, kChirp = 1;    // MINPHASE_DIRECT, MINPHASE_CHIRP
constexpr int kHeaderTop = 13;            // header fields before the radices

struct Plan {
  int L, N1, N2, n_stages, pad_shift, slots, tw4_off, roots_off, post_off;
  int route, chirp_off, filt_off;
  int xch_len, z_len;                 // float2s of the row's exchange and chirp buffers
  int M;                              // = N1: the column FFT's length, as fft.cuh reads it
  int n1_shift;                       // log2 N1 where N1 is a power of two, else -1
  int radix[kMaxStages], tw_off[kMaxStages], root_off[kMaxStages];
  int count[kCluster];                // k1 a CTA owns
  int low[kCluster];                  // of them, k1 <= N1/2 (the first slots): one of each bin pair
  unsigned char slot[kMaxN1], k1_of[kCluster][kMaxSlots];
};

// Offsets (in floats) of a CTA's shared-memory arrays:
//   col_a, col_b  ping-pong of the column FFTs: ncol frames of FS points
//   rows   [j2][slot]       the column FFTs' twiddled outputs for this CTA's k1
//   spec   [k2][slot]       bins k1 + N1 k2 of the last transform
//   roots  the N2 roots exp(-2 pi i q / N2)
//   keep   a real half spectrum kept across transforms: direct [k2][slot],
//          k2 <= N2; chirp two bins for each of the CTA's pairs
// The column buffers and rows/spec are never live together (a cluster
// barrier lies between the column FFTs and the gather into rows, and between
// a transform's last read of spec and the next column FFTs): they share
// their space, which lets N2 reach kMaxN2.
struct Layout {
  int FS, ncol, col_a, col_b, rows, spec, roots, keep, floats;
};

// bins 0 .. L/2 of the chirp route's pairs that CTA `rank` takes
__host__ __device__ __forceinline__ int chirp_pairs(const Plan& p) {
  return (p.L / 2 + kCluster) / kCluster;
}

__host__ __device__ Layout layout(const Plan& p) {
  Layout l;
  l.FS = padded(p.N1 - 1, p.pad_shift) + 1;
  l.ncol = (p.N2 + kCluster - 1) / kCluster;
  l.col_a = 0;
  l.col_b = l.col_a + 2 * l.ncol * l.FS;
  l.rows = 0;
  l.spec = l.rows + 2 * p.N2 * p.slots;
  const int cols = l.col_b + 2 * l.ncol * l.FS, rows_spec = l.spec + 2 * p.N2 * p.slots;
  l.roots = cols > rows_spec ? cols : rows_spec;
  l.keep = l.roots + 2 * p.N2;
  l.floats = l.keep + (p.route == kChirp ? 2 * chirp_pairs(p) : (p.N2 + 1) * p.slots);
  return l;
}

struct Smem {
  float2 *col_a, *col_b, *rows, *spec, *roots;
  float* keep;
};

__device__ Smem carve(const Layout& l, float* base) {
  Smem s;
  s.col_a = reinterpret_cast<float2*>(base + l.col_a);
  s.col_b = reinterpret_cast<float2*>(base + l.col_b);
  s.rows = reinterpret_cast<float2*>(base + l.rows);
  s.spec = reinterpret_cast<float2*>(base + l.spec);
  s.roots = reinterpret_cast<float2*>(base + l.roots);
  s.keep = base + l.keep;
  return s;
}

// Bin f (0 <= f <= L) of a half spectrum in shared memory: in the CTA that
// owns k1 = f mod N1, at [f / N1][slot]; f = L sits at [N2][slot of k1 = 0].
__device__ __forceinline__ int k1_of_bin(const Plan& p, int f) {
  return p.n1_shift >= 0 ? (f & (p.N1 - 1)) : f % p.N1;
}

__device__ __forceinline__ int bin_index(const Plan& p, int f) {
  return (p.n1_shift >= 0 ? f >> p.n1_shift : f / p.N1) * p.slots + p.slot[k1_of_bin(p, f)];
}

// out_q = sum_j v_j exp(-2 pi i j q / N2) along each of this CTA's rows of
// s.rows, into s.spec: a_r = v_r + v_{N2-r} and b_r = v_r - v_{N2-r} in
// place, then for each pair (q, N2 - q): c = v_0 [+ (-1)^q v_{N2/2}] +
// sum_r a_r Re w_rq and s = sum_r b_r Im w_rq, r = 1 .. (N2-1)/2 in order;
// out_q = c + i s, out_{N2-q} = c - i s.  A thread takes the pairs q and
// q + nq/2 of one row (a_r, b_r read once for both); the threads of a warp
// take neighbouring rows (the same roots).
__device__ void direct_dft(const Plan& p, const Smem& s, int ns) {
  const int N2 = p.N2, SL = p.slots, H = (N2 - 1) / 2;
  float2* v = s.rows;
  for (int i = threadIdx.x; i < H * ns; i += blockDim.x) {
    const int r = 1 + i / ns, sl = i - (r - 1) * ns;
    const float2 x = v[r * SL + sl], y = v[(N2 - r) * SL + sl];
    v[r * SL + sl] = cadd(x, y);
    v[(N2 - r) * SL + sl] = csub(x, y);
  }
  __syncthreads();
  const int nq = N2 / 2 + 1, half = (nq + 1) / 2;
  const bool even = (N2 & 1) == 0;
  for (int i = threadIdx.x; i < half * ns; i += blockDim.x) {
    const int qa = i / ns, sl = i - qa * ns, qb = qa + half;
    const float2* col = v + sl;
    float2 ca = col[0], cb = col[0];
    if (even) {
      const float2 mid = col[(N2 / 2) * SL];
      ca = (qa & 1) ? csub(ca, mid) : cadd(ca, mid);
      cb = (qb & 1) ? csub(cb, mid) : cadd(cb, mid);
    }
    float2 ta = make_float2(0.f, 0.f), tb = ta;
    int ma = 0, mb = 0;
    for (int r = 1; r <= H; ++r) {
      ma += qa;
      if (ma >= N2) ma -= N2;
      mb += qb;
      if (mb >= N2) mb -= N2;
      const float2 a = col[r * SL], b = col[(N2 - r) * SL], wa = s.roots[ma], wb = s.roots[mb];
      ca = make_float2(fmaf(a.x, wa.x, ca.x), fmaf(a.y, wa.x, ca.y));
      ta = make_float2(fmaf(b.x, wa.y, ta.x), fmaf(b.y, wa.y, ta.y));
      cb = make_float2(fmaf(a.x, wb.x, cb.x), fmaf(a.y, wb.x, cb.y));
      tb = make_float2(fmaf(b.x, wb.y, tb.x), fmaf(b.y, wb.y, tb.y));
    }
    s.spec[qa * SL + sl] = make_float2(ca.x - ta.y, ca.y + ta.x);
    if (qa != 0 && 2 * qa != N2) s.spec[(N2 - qa) * SL + sl] = make_float2(ca.x + ta.y, ca.y - ta.x);
    if (qb < nq) {
      s.spec[qb * SL + sl] = make_float2(cb.x - tb.y, cb.y + tb.x);
      if (2 * qb != N2) s.spec[(N2 - qb) * SL + sl] = make_float2(cb.x + tb.y, cb.y - tb.x);
    }
  }
  __syncthreads();
}

// The complex FFT of L points, its input z_j given by gather(j) (loads from
// device memory): the bins k1 + N1 k2 this CTA owns land in s.spec.  The
// exchange between the two steps goes through the row's scratch xch
// ([j2][k1], in the L2) and a cluster barrier.  Ends with the CTA
// synchronised.
template <int Set, class Gather>
__device__ void four_step(const Plan& p, const Layout& l, const Smem& s,
                          const float2* __restrict__ tab, const cg::cluster_group& cl, int rank,
                          float2* __restrict__ xch, const Gather& gather) {
  const int col0 = rank * p.N2 / kCluster;
  const int ncol = (rank + 1) * p.N2 / kCluster - col0;
  if (ncol > 0) {
    // the columns' points, neighbouring threads on neighbouring j, kLoads
    // gathers a thread in flight
    const int total = ncol * p.N1;
    for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * blockDim.x) {
      float2 z[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * blockDim.x, j1 = i / ncol;
        if (i < total) z[u] = gather(p.N2 * j1 + col0 + (i - j1 * ncol));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * blockDim.x, j1 = i / ncol;
        if (i < total) s.col_a[(i - j1 * ncol) * l.FS + padded(j1, p.pad_shift)] = z[u];
      }
    }
    const float2* A = run_fft<Set>(p, tab, s.col_a, s.col_b, ncol, l.FS, 1, 0, p.N1);
    const float2* tw4 = tab + p.tw4_off;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int fr = i / p.N1, k1 = i - fr * p.N1, j2 = col0 + fr;
      xch[j2 * p.N1 + k1] =
          cmul(A[fr * l.FS + padded(k1, p.pad_shift)], __ldg(tw4 + j2 * p.N1 + k1));
    }
  }
  cl.sync();
  // this CTA's k1, every column
  const int ns = p.count[rank], total = p.N2 * ns;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * blockDim.x) {
    float2 z[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x, j2 = i / ns;
      if (i < total) z[u] = __ldcg(xch + j2 * p.N1 + p.k1_of[rank][i - j2 * ns]);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x, j2 = i / ns;
      if (i < total) s.rows[j2 * p.slots + (i - j2 * ns)] = z[u];
    }
  }
  __syncthreads();
  direct_dft(p, s, ns);
}

// pair(f, g, Z_f, Z_{g mod L}, index of f, index of g) once for every bin
// pair (f, g = L - f) of this CTA: f runs over the CTA's k1 <= N1/2, and g
// has k1 = N1 - k1; where that is k1 again (0 and N1/2), f <= g: f = 0
// pairs with the Nyquist bin L, f = L/2 with itself.
template <class Pair>
__device__ void for_pairs(const Plan& p, const Smem& s, int rank, const Pair& pair) {
  const int ns = p.low[rank];
  for (int i = threadIdx.x; i < ns * p.N2; i += blockDim.x) {
    const int k2 = i / ns, sl = i - k2 * ns;
    const int k1 = p.k1_of[rank][sl], f = k1 + p.N1 * k2;
    if ((k1 == 0 || 2 * k1 == p.N1) && 2 * f > p.L) continue;     // pairs within the column
    const int g = p.L - f;
    const int bf = k2 * p.slots + sl, bg = bin_index(p, g);
    pair(f, g, s.spec[bf], g == p.L ? s.spec[bf] : s.spec[bg], bf, bg);
  }
}

// bins f and g of the real FFT from the packed transform's Z_f and Z_g:
// X_f = (Z_f + conj Z_g)/2 - i e_f (Z_f - conj Z_g)/2, and X_g the same with
// f and g swapped
__device__ __forceinline__ float2 split(float2 zf, float2 zg, float2 ef) {
  const float2 sm = make_float2(0.5f * (zf.x + zg.x), 0.5f * (zf.y - zg.y));
  const float2 t = cmul(ef, make_float2(0.5f * (zf.x - zg.x), 0.5f * (zf.y + zg.y)));
  return make_float2(sm.x + t.y, sm.y - t.x);
}

// conj(U_f), U_f = (Y_f + conj Y_g)/2 + i conj(e_f) (Y_f - conj Y_g)/2: the
// packed spectrum whose inverse FFT of L points is y_2k + i y_2k+1, y the
// inverse real FFT of the Hermitian Y
__device__ __forceinline__ float2 unsplit_conj(float2 yf, float2 yg, float2 ef) {
  const float2 sm = make_float2(0.5f * (yf.x + yg.x), 0.5f * (yf.y - yg.y));
  const float2 t = cmul(make_float2(ef.x, -ef.y),
                        make_float2(0.5f * (yf.x - yg.x), 0.5f * (yf.y + yg.y)));
  return make_float2(sm.x - t.y, -(sm.y + t.x));
}

// y_2k = scale Re R_k, y_2k+1 = -scale Im R_k for the bins k this CTA owns,
// R the forward FFT of conj(U): the first L samples of the inverse
__device__ void store_samples(const Plan& p, const Smem& s, int rank, float* out, float scale) {
  const int ns = p.count[rank], k2_end = (p.N2 + 1) / 2;      // k < L/2 needs k2 < N2/2
  for (int i = threadIdx.x; i < ns * k2_end; i += blockDim.x) {
    const int k2 = i / ns, sl = i - k2 * ns;
    const int k = p.k1_of[rank][sl] + p.N1 * k2;
    const float2 r = s.spec[k2 * p.slots + sl];
    if (2 * k < p.L) out[2 * k] = r.x * scale;
    if (2 * k + 1 < p.L) out[2 * k + 1] = -r.y * scale;
  }
}

// fn(k, index in s.spec) for each bin k1 + N1 k2 this CTA owns.
template <class Fn>
__device__ void each_owned(const Plan& p, int rank, const Fn& fn) {
  const int ns = p.count[rank];
  for (int i = threadIdx.x; i < ns * p.N2; i += blockDim.x) {
    const int k2 = i / ns, sl = i - k2 * ns;
    fn(p.k1_of[rank][sl] + p.N1 * k2, k2 * p.slots + sl);
  }
}

// The complex FFT of L points of z_j = gather(j).  Direct: the four-step FFT,
// the bins this CTA owns in s.spec.  Chirp: the Bluestein step over N = N1 N2
// points, Z_f = w_f conj(E_f), E the four-step FFT of conj(A filt) and A that
// of z_j w_j; Z (f < L) lands in zb in natural order, the cluster
// synchronised.
template <int Set, bool Chirp, class Gather>
__device__ void transform(const Plan& p, const Layout& l, const Smem& s,
                          const float2* __restrict__ tab, const cg::cluster_group& cl, int rank,
                          float2* __restrict__ xch, float2* __restrict__ zb,
                          const Gather& gather) {
  if constexpr (!Chirp) {
    four_step<Set>(p, l, s, tab, cl, rank, xch, gather);
  } else {
    const float2* w = tab + p.chirp_off;
    const float2* filt = tab + p.filt_off;
    four_step<Set>(p, l, s, tab, cl, rank, xch, [&](int j) {
      return j < p.L ? cmul(gather(j), __ldg(w + j)) : make_float2(0.f, 0.f);
    });
    each_owned(p, rank, [&](int k, int bi) {
      const float2 u = cmul(s.spec[bi], __ldg(filt + k));
      zb[k] = make_float2(u.x, -u.y);
    });
    cl.sync();
    four_step<Set>(p, l, s, tab, cl, rank, xch, [&](int j) { return __ldcg(zb + j); });
    each_owned(p, rank, [&](int f, int bi) {
      const float2 e = s.spec[bi];
      if (f < p.L) zb[f] = cmul(__ldg(w + f), make_float2(e.x, -e.y));
    });
    cl.sync();
  }
}

// for_pairs over the transform's bins.  Chirp: CTA `rank` takes a run of f
// in 0 .. L/2 (Z from zb) and keeps its bins at 2 (f - f0) and the next.
template <bool Chirp, class Pair>
__device__ void pairs(const Plan& p, const Smem& s, int rank, const float2* __restrict__ zb,
                      const Pair& pair) {
  if constexpr (!Chirp) {
    for_pairs(p, s, rank, pair);
  } else {
    const int per = chirp_pairs(p), f0 = rank * per, f1 = min(p.L / 2 + 1, f0 + per);
    for (int f = f0 + threadIdx.x; f < f1; f += blockDim.x) {
      const int g = p.L - f, bf = 2 * (f - f0);
      pair(f, g, __ldcg(zb + f), __ldcg(zb + (g == p.L ? 0 : g)), bf, g == f ? bf : bf + 1);
    }
  }
}

// store_samples over the transform's bins (chirp: a run of k a CTA, from zb)
template <bool Chirp>
__device__ void store(const Plan& p, const Smem& s, int rank, const float2* __restrict__ zb,
                      float* out, float scale) {
  if constexpr (!Chirp) {
    store_samples(p, s, rank, out, scale);
  } else {
    const int K = (p.L + 1) / 2, per = (K + kCluster - 1) / kCluster;
    for (int k = rank * per + threadIdx.x; k < min(K, (rank + 1) * per); k += blockDim.x) {
      const float2 r = __ldcg(zb + k);
      out[2 * k] = r.x * scale;
      if (2 * k + 1 < p.L) out[2 * k + 1] = -r.y * scale;
    }
  }
}

// The packed input of a real row of device memory, zero from L on.
struct RowLoad {
  const float* x;
  int L;
  __device__ float2 operator()(int j) const {
    return make_float2(2 * j < L ? __ldg(x + 2 * j) : 0.f, 2 * j + 1 < L ? __ldg(x + 2 * j + 1) : 0.f);
  }
};

// y = Re ifft(m e^{i phi})[:L]; H (L + 1 bins) and phi saved for the backward.
template <int Set, bool Chirp>
__global__ void __launch_bounds__(kThreads)
minphase_fwd_kernel(const float* __restrict__ h, float* __restrict__ y, float2* __restrict__ Hs,
                    float* __restrict__ phis, float* __restrict__ scratch,
                    const float2* __restrict__ tab, const __grid_constant__ Plan p) {
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), row = blockIdx.y;
  const int L = p.L, n = 2 * L;
  const Layout l = layout(p);
  extern __shared__ float4 smem_f4[];
  const Smem s = carve(l, reinterpret_cast<float*>(smem_f4));
  for (int i = threadIdx.x; i < p.N2; i += blockDim.x) s.roots[i] = __ldg(tab + p.roots_off + i);
  const float2* e = tab + p.post_off;
  float2* Hr = Hs + (size_t)row * (L + 1);
  float* phr = phis + (size_t)row * (L + 1);
  float2* xch = reinterpret_cast<float2*>(scratch) + (size_t)row * (p.xch_len + p.z_len + L + 1);
  float2* zb = xch + p.xch_len;          // chirp: the convolution's input, then Z
  float2* hc = zb + p.z_len;             // the half spectrum between transforms
  float* hr = reinterpret_cast<float*>(hc);

  // 1: H = fft(h, n); keep m = |H|, gather log(m + 1e-8)
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, RowLoad{h + (size_t)row * L, L});
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    const float2 xf = split(zf, zg, __ldg(e + f)), xg = split(zg, zf, __ldg(e + g));
    const float mf = hypotf(xf.x, xf.y), mg = hypotf(xg.x, xg.y);
    Hr[f] = xf;
    Hr[g] = xg;
    s.keep[bf] = mf;
    s.keep[bg] = mg;
    hr[f] = logf(mf + kEps);
    hr[g] = logf(mg + kEps);
  });
  cl.sync();
  // 2: c = fft of the even sequence log m (real)
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) {
    const int a = 2 * j, b = 2 * j + 1;
    return make_float2(__ldcg(hr + (a <= L ? a : n - a)), __ldcg(hr + (b <= L ? b : n - b)));
  });
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    hr[f] = split(zf, zg, __ldg(e + f)).x;
    hr[g] = split(zg, zf, __ldg(e + g)).x;
  });
  cl.sync();
  // 3: phi = -Im ifft(w c) = Im fft(w c) / n; Y = m e^{i phi}, packed for the inverse
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) {
    const int a = 2 * j, b = 2 * j + 1;
    return make_float2(a < L ? 2.f * __ldcg(hr + a) : 0.f, b < L ? 2.f * __ldcg(hr + b) : 0.f);
  });
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    const float2 ef = __ldg(e + f), eg = __ldg(e + g);
    const float pf = split(zf, zg, ef).y / (float)n, pg = split(zg, zf, eg).y / (float)n;
    phr[f] = pf;
    phr[g] = pg;
    float sf, cf, sg, cg;
    sincosf(pf, &sf, &cf);
    sincosf(pg, &sg, &cg);
    const float2 yf = make_float2(s.keep[bf] * cf, s.keep[bf] * sf);
    const float2 yg = make_float2(s.keep[bg] * cg, s.keep[bg] * sg);
    hc[f] = unsplit_conj(yf, yg, ef);
    if (g < L) hc[g] = unsplit_conj(yg, yf, eg);
  });
  cl.sync();
  // 4: y = Re ifft(Y)[:L]
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) { return __ldcg(hc + j); });
  store<Chirp>(p, s, rank, zb, y + (size_t)row * L, 1.f / (float)L);
}

// dh = dL/dh from g = dL/dy and the forward's saved H and phi.
template <int Set, bool Chirp>
__global__ void __launch_bounds__(kThreads)
minphase_bwd_kernel(const float* __restrict__ gy, const float2* __restrict__ Hs,
                    const float* __restrict__ phis, float* __restrict__ dh,
                    float* __restrict__ scratch, const float2* __restrict__ tab,
                    const __grid_constant__ Plan p) {
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), row = blockIdx.y;
  const int L = p.L, n = 2 * L;
  const Layout l = layout(p);
  extern __shared__ float4 smem_f4[];
  const Smem s = carve(l, reinterpret_cast<float*>(smem_f4));
  for (int i = threadIdx.x; i < p.N2; i += blockDim.x) s.roots[i] = __ldg(tab + p.roots_off + i);
  const float2* e = tab + p.post_off;
  const float2* Hr = Hs + (size_t)row * (L + 1);
  const float* phr = phis + (size_t)row * (L + 1);
  float2* xch = reinterpret_cast<float2*>(scratch) + (size_t)row * (p.xch_len + p.z_len + L + 1);
  float2* zb = xch + p.xch_len;
  float2* hc = zb + p.z_len;
  float* hr = reinterpret_cast<float*>(hc);

  // 1: gW = fft(g, n) / n; with z_i = -phi: the gradient w.r.t. |H| through
  // the final product (kept) and gz = -i a, a = m (gW_i cos phi - gW_r sin phi)
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, RowLoad{gy + (size_t)row * L, L});
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    const float2 xs[2] = {split(zf, zg, __ldg(e + f)), split(zg, zf, __ldg(e + g))};
    const int fs[2] = {f, g}, bs[2] = {bf, bg};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 gw = make_float2(xs[k].x / (float)n, xs[k].y / (float)n);
      const float2 H = Hr[fs[k]];
      const float m = hypotf(H.x, H.y);
      float sn, cs;
      sincosf(phr[fs[k]], &sn, &cs);
      s.keep[bs[k]] = gw.x * cs + gw.y * sn;
      hr[fs[k]] = m * (gw.y * cs - gw.x * sn);
    }
  });
  cl.sync();
  // 2: fft(gz) = -i fft(a), a odd: its real part Im fft(a)
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) {
    const int a = 2 * j, b = 2 * j + 1;
    return make_float2(a <= L ? __ldcg(hr + a) : -__ldcg(hr + (n - a)),
                       b <= L ? __ldcg(hr + b) : -__ldcg(hr + (n - b)));
  });
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    hr[f] = split(zf, zg, __ldg(e + f)).y;
    hr[g] = split(zg, zf, __ldg(e + g)).y;
  });
  cl.sync();
  // 3: the log branch's gradient Re ifft(w fft(gz)) = Re fft(w q) / n, then
  // gH = (g_mag + g_log / (m + 1e-8)) H / m (0 where m = 0), packed for the inverse
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) {
    const int a = 2 * j, b = 2 * j + 1;
    return make_float2(a < L ? 2.f * __ldcg(hr + a) : 0.f, b < L ? 2.f * __ldcg(hr + b) : 0.f);
  });
  pairs<Chirp>(p, s, rank, zb, [&](int f, int g, float2 zf, float2 zg, int bf, int bg) {
    const float2 ef = __ldg(e + f), eg = __ldg(e + g);
    const float2 xs[2] = {split(zf, zg, ef), split(zg, zf, eg)};
    const int fs[2] = {f, g}, bs[2] = {bf, bg};
    float2 gH[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 H = Hr[fs[k]];
      const float m = hypotf(H.x, H.y);
      const float gm = s.keep[bs[k]] + (xs[k].x / (float)n) / (m + kEps);
      gH[k] = m == 0.f ? make_float2(0.f, 0.f) : make_float2(gm * H.x / m, gm * H.y / m);
    }
    hc[f] = unsplit_conj(gH[0], gH[1], ef);
    if (g < L) hc[g] = unsplit_conj(gH[1], gH[0], eg);
  });
  cl.sync();
  // 4: dh = Re n ifft(gH)[:L]
  transform<Set, Chirp>(p, l, s, tab, cl, rank, xch, zb, [&](int j) { return __ldcg(hc + j); });
  store<Chirp>(p, s, rank, zb, dh + (size_t)row * L, 2.f);
}

bool read_plan(const int* h, Plan* p) {
  p->L = h[0];
  p->N1 = p->M = h[1];
  p->n1_shift = -1;
  for (int k = 0; (1 << k) <= p->N1; ++k)
    if ((1 << k) == p->N1) p->n1_shift = k;
  p->N2 = h[2];
  p->n_stages = h[3];
  p->pad_shift = h[4];
  p->slots = h[6];
  p->tw4_off = h[7];
  p->roots_off = h[8];
  p->post_off = h[9];
  p->route = h[10];
  p->chirp_off = h[11];
  p->filt_off = h[12];
  const bool chirp = p->route == kChirp;
  p->xch_len = chirp ? p->N1 * p->N2 : p->L + 1;
  p->z_len = chirp ? p->N1 * p->N2 : 0;
  if (h[5] != kCluster || p->N1 < 2 || p->N1 > kMaxN1 || p->N2 < 1 || p->N2 > kMaxN2 ||
      p->L < 2 || (p->route != kDirect && !chirp) ||
      (chirp ? p->N1 * p->N2 < 2 * p->L - 1 : p->N1 * p->N2 != p->L) || p->slots < 1 ||
      p->slots > kMaxSlots || p->n_stages < 1 || p->n_stages > kMaxStages)
    return false;
  int len = 1;
  for (int s = 0; s < kMaxStages; ++s) {
    p->radix[s] = h[kHeaderTop + s];
    p->tw_off[s] = h[kHeaderTop + kMaxStages + s];
    p->root_off[s] = h[kHeaderTop + 2 * kMaxStages + s];
    if (s < p->n_stages) {
      const int r = p->radix[s];
      if (!(r == 2 || r == 3 || r == 4 || r == 5 || r == 8)) return false;
      len *= r;
    }
  }
  if (len != p->N1) return false;
  const int* slot = h + kHeaderTop + 3 * kMaxStages;
  const int* k1_of = slot + kMaxN1;
  for (int k = 0; k < kMaxN1; ++k) {
    const bool used = k < p->N1;
    if (used && (slot[k] < 0 || slot[k] >= p->slots)) return false;
    p->slot[k] = used ? (unsigned char)slot[k] : 0;
  }
  // each k1 once, in the slot the slot table gives it, with N1 - k1 in the
  // same CTA, the pairs' first members (k1 <= N1/2) first
  int owner[kMaxN1];
  for (int k = 0; k < kMaxN1; ++k) owner[k] = -1;
  int owned = 0;
  for (int c = 0; c < kCluster; ++c) {
    p->count[c] = p->low[c] = 0;
    for (int s = 0; s < kMaxSlots; ++s) {
      const int k = k1_of[c * kMaxSlots + s];
      if (k < 0) break;
      if (k >= p->N1 || owner[k] >= 0 || slot[k] != s || s >= p->slots) return false;
      owner[k] = c;
      p->k1_of[c][s] = (unsigned char)k;
      p->count[c] = s + 1;
      if (2 * k <= p->N1) {
        if (p->low[c] != s) return false;
        p->low[c] = s + 1;
      }
    }
    owned += p->count[c];
  }
  if (owned != p->N1) return false;
  for (int k = 0; k < p->N1; ++k)
    if (owner[(p->N1 - k) % p->N1] != owner[k]) return false;
  return true;
}

// Clusters of the kernel that the card holds at once at this configuration
// (0 if it cannot run one), asked of the runtime once per kernel and size;
// the kernel's shared-memory limit is raised at its first use.
int active_clusters(const void* kernel, const cudaLaunchConfig_t& cfg) {
  static std::mutex lock;
  static std::map<std::pair<const void*, size_t>, int> known;
  const std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_pair(kernel, cfg.dynamicSmemBytes);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0;
    if (allow_smem(kernel) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
      n = 0;
    it = known.emplace(key, n).first;
  }
  return it->second;
}

// One cluster of kCluster CTAs a row; a configuration the card cannot run
// is refused before the launch, and a refused launch is reported.
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int rows, cudaStream_t stream, const Plan& p,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)layout(p).floats * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if (cfg.dynamicSmemBytes > kSmemMax || active_clusters((const void*)kernel, cfg) < 1)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int minphase_forward(const float* h, float* y, float* Hs, float* phis,
                                float* scratch, const float* table, const int* header, int rows,
                                cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || rows < 1) return (int)cudaErrorInvalidValue;
  const float2* tab = reinterpret_cast<const float2*>(table);
  float2* H2 = reinterpret_cast<float2*>(Hs);
  const int set = radix_set(p);
  if (p.route == kChirp)
    return set == kPow2
               ? launch(minphase_fwd_kernel<kPow2, true>, rows, stream, p, h, y, H2, phis, scratch,
                        tab, p)
               : (int)cudaErrorInvalidValue;
  switch (set) {
    case kPow2:
      return launch(minphase_fwd_kernel<kPow2, false>, rows, stream, p, h, y, H2, phis, scratch,
                    tab, p);
    case kSmall:
      return launch(minphase_fwd_kernel<kSmall, false>, rows, stream, p, h, y, H2, phis, scratch,
                    tab, p);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int minphase_backward(const float* g, const float* Hs, const float* phis, float* dh,
                                 float* scratch, const float* table, const int* header, int rows,
                                 cudaStream_t stream) {
  Plan p;
  if (!read_plan(header, &p) || rows < 1) return (int)cudaErrorInvalidValue;
  const float2* tab = reinterpret_cast<const float2*>(table);
  const float2* H2 = reinterpret_cast<const float2*>(Hs);
  const int set = radix_set(p);
  if (p.route == kChirp)
    return set == kPow2
               ? launch(minphase_bwd_kernel<kPow2, true>, rows, stream, p, g, H2, phis, dh, scratch,
                        tab, p)
               : (int)cudaErrorInvalidValue;
  switch (set) {
    case kPow2:
      return launch(minphase_bwd_kernel<kPow2, false>, rows, stream, p, g, H2, phis, dh, scratch,
                    tab, p);
    case kSmall:
      return launch(minphase_bwd_kernel<kSmall, false>, rows, stream, p, g, H2, phis, dh, scratch,
                    tab, p);
    default: return (int)cudaErrorInvalidValue;
  }
}
