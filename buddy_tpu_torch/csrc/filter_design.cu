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
// design_subband_filter :341, design_filter :368 and the phasor of
// compute_H :390.  The linear interpolation across the EQ breakpoints is a
// (F x Q) matrix with two non-zeros per row there; here each frequency row
// carries its interval j[f] and weight t[f], and j ascends with f.
//
// What bounds it on the H100: bytes, and at the main-path shape (B=8,
// F=513, Nf=100, Q=27) too few of them to fill the card.  The forward reads
// 1.6 MB of phases and writes 3.3 MB of H (~1.5 us at 3.35 TB/s); the
// backward reads the phases and 3.3 MB of dL/dH and writes dL/dphases
// (~2.0 us).  So each direction is one launch of about one wave, and every
// point costs one expf and one sincosf:
//
// - A CTA owns a run of R consecutive frequency rows of one utterance b,
//   512 threads, so that 16 warps an SM hide the latency of the exp and
//   sincos chains.  The wrapper picks R (ops/filter_design.py::schedule):
//   F / (SMs / B) rounded up (16 CTAs of 33 rows a b at the main path),
//   halved until the CTA's shared memory fits, and passes it with qmax, the
//   most breakpoints any CTA's rows touch, which sizes the staged envelope.
//   A CTA forms log(full + 1e-6) once for the breakpoints its rows touch (2-6
//   of the 27 at the main path) and stages its rows' j and t and the OLA row,
//   all in shared memory; a point then reads its two rows there.
//   exp(p)^(-n) stays powf(expf(p), -n), as in the plain version: it runs
//   only on those few rows.
// - Each thread takes groups of four consecutive points: 16-byte loads of
//   the phases, the direct-path correction (and dL/dH), 16-byte stores of H
//   (two float4s for four complex values).  A thread issues the loads of all
//   its groups (up to kUnroll; one round at the main path) before the
//   staging above, so that one trip to device memory serves the CTA.  Rows
//   whose points do not start on four (F Nf not a multiple of 4) take the
//   scalar path.
// - The backward writes dL/dphases and keeps dL/dI in shared memory.  The
//   gradients of the weights and decays are linear in dL/dI, so each CTA
//   takes its own share to the end: it sums dL/dI over its rows into
//   per-breakpoint partial rows (weights t and 1 - t, rows in ascending
//   order), divides them by full + 1e-6 and reduces them over n into a
//   pair of scalars per (e, k) (one warp an (e, k): lanes over n in order,
//   then a shuffle tree; zeros for the breakpoints its rows do not touch),
//   written to a scratch that stays in the L2.  The CTA that draws the last
//   ticket of its b (an atomic decides who sums, not the order) loads all
//   the CTAs' pairs at once and adds them in CTA order (a warp an (e, k),
//   lane c taking CTA c, then the same shuffle tree).  dL/dI never
//   reaches device memory, there is no float atomic, and two calls give
//   identical bits.
//
// Gradients follow torch's convention for a real loss of complex H
// (gH = dL/dRe H + i dL/dIm H).  Everything is float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 2;              // groups of four points a thread has in flight
// dynamic shared memory a CTA may ask for: the card's 227 KB less room for
// the backward's static arrays (which count against the same limit)
constexpr size_t kSmemMax = 223 * 1024;

struct Dims {
  int F, Nf, E, bands, Q, pad;  // pad = 1 when the EQ extremes are fixed zero rows
  int R, nb, qmax;              // rows a CTA, CTAs a b, most breakpoints a CTA touches
};

// The CTA's rows [r0, r1) and the breakpoints [q0, q0 + nq) they touch.
struct Rows {
  int r0, r1, q0, nq;
};

__device__ Rows rows_of(const int* __restrict__ jrow, const Dims& d, int blk) {
  Rows r;
  r.r0 = blk * d.R;
  r.r1 = min(d.F, r.r0 + d.R);
  r.q0 = __ldg(jrow + r.r0);
  r.nq = __ldg(jrow + r.r1 - 1) + 2 - r.q0;
  return r;
}

// A CTA's staged arrays: lf[(q - q0) Nf + n] = log(full + 1e-6) (and, for
// the backward, fe = full + 1e-6) of its breakpoints (room for qmax), the
// OLA row, exp(p) and w of its b ([e][k]), its rows' t and j - q0, and
// lo[qq], the first of its rows with j - q0 >= qq (qq <= nq; j ascends);
// then, 8-byte aligned, the backward's rows of dL/dI.  The wrapper's
// smem_bytes mirrors these sizes.
struct Staged {
  float *lf, *fe, *ola, *dec, *wt, *t, *tail;
  int *j, *lo;
};

__host__ __device__ size_t staged_floats(const Dims& d, bool bwd) {
  const size_t n = (size_t)(bwd ? 2 : 1) * d.qmax * d.Nf + d.Nf + 2 * (size_t)d.E * d.bands +
                   2 * (size_t)d.R + d.qmax + 1;
  return (n + 1) & ~(size_t)1;
}

__device__ Staged carve(const Dims& d, float* base, bool with_fe) {
  Staged st;
  st.lf = base;
  st.fe = with_fe ? base + d.qmax * d.Nf : nullptr;
  st.ola = base + (with_fe ? 2 : 1) * d.qmax * d.Nf;
  st.dec = st.ola + d.Nf;
  st.wt = st.dec + d.E * d.bands;
  st.t = st.wt + d.E * d.bands;
  st.j = reinterpret_cast<int*>(st.t + d.R);
  st.lo = st.j + d.R;
  st.tail = base + staged_floats(d, with_fe);
  return st;
}

// full[b, q, n] + 1e-6 for one q of the staged b; q indexes the EQ breakpoints.
__device__ __forceinline__ float full_plus_eps(const Staged& st, const Dims& d, int q, int n) {
  const int k = q - d.pad;
  float env = 0.f;
  if (k >= 0 && k < d.bands)
    for (int e = 0; e < d.E; ++e)
      env += st.wt[e * d.bands + k] * powf(st.dec[e * d.bands + k], -(float)n);
  return env + 1e-6f;
}

// The loads of device memory first (the b's parameters, the OLA row, the
// rows' j and t), then the log envelope of the CTA's breakpoints.
__device__ void stage(const float* __restrict__ p, const float* __restrict__ w,
                      const int* __restrict__ jrow, const float* __restrict__ trow,
                      const float* __restrict__ ola, const Dims& d, int b, const Rows& r,
                      const Staged& st) {
  const int rows = r.r1 - r.r0;
  for (int i = threadIdx.x; i < d.E * d.bands; i += blockDim.x) {
    st.dec[i] = expf(__ldg(p + (size_t)b * d.E * d.bands + i));
    st.wt[i] = __ldg(w + (size_t)b * d.E * d.bands + i);
  }
  for (int i = threadIdx.x; i < d.Nf; i += blockDim.x) st.ola[i] = __ldg(ola + i);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    st.j[i] = __ldg(jrow + r.r0 + i) - r.q0;
    st.t[i] = __ldg(trow + r.r0 + i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r.nq * d.Nf; i += blockDim.x) {
    const int qq = i / d.Nf, n = i - qq * d.Nf;
    const float v = full_plus_eps(st, d, r.q0 + qq, n);
    st.lf[i] = logf(v);
    if (st.fe) st.fe[i] = v;
  }
  if (st.fe) {            // the backward's row ranges: j - q0 ascends from 0
    for (int fl = threadIdx.x; fl < rows; fl += blockDim.x) {
      for (int qq = fl > 0 ? st.j[fl - 1] + 1 : 0; qq <= st.j[fl]; ++qq) st.lo[qq] = fl;
      if (fl == rows - 1)
        for (int qq = st.j[fl] + 1; qq <= r.nq; ++qq) st.lo[qq] = rows;
    }
  }
  __syncthreads();
}

// exp(I) of point (f, n) of the CTA, I the interpolated log envelope.
__device__ __forceinline__ float envelope(const Staged& st, const Rows& r, int Nf, int f, int n) {
  const int jq = st.j[f - r.r0] * Nf + n;
  const float t = st.t[f - r.r0];
  return expf((1.f - t) * st.lf[jq] + t * st.lf[jq + Nf]);
}

// Runs the CTA's points [r0 Nf, r1 Nf) of one b: groups of four starting on
// a multiple of four (load(i) -> V, then group(i, f, n, V) for the first
// point), the rest one at a time (point(i, f, n)).  Every thread issues the
// loads of up to kUnroll groups, then (first round only) staged() runs,
// then the groups are computed; neighbouring threads take neighbouring
// groups.
template <class V, class Load, class Staging, class Group, class Point>
__device__ void for_points(const Dims& d, const Rows& r, bool vec, const Load& load,
                           const Staging& staged, const Group& group, const Point& point) {
  const int i0 = r.r0 * d.Nf, i1 = r.r1 * d.Nf;
  const int a = vec ? min(i1, (i0 + 3) & ~3) : i1, e = vec ? max(a, i1 & ~3) : i1;
  const int groups = (e - a) / 4, per_round = kUnroll * blockDim.x;
  const int rounds = max(1, (groups + per_round - 1) / per_round);
  for (int round = 0; round < rounds; ++round) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = round * per_round + u * blockDim.x + threadIdx.x;
      if (g < groups) v[u] = load(a + 4 * g);
    }
    if (round == 0) staged();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = round * per_round + u * blockDim.x + threadIdx.x, i = a + 4 * g;
      if (g < groups) group(i, i / d.Nf, i % d.Nf, v[u]);
    }
  }
  for (int i = i0 + threadIdx.x; i < a; i += blockDim.x) point(i, i / d.Nf, i % d.Nf);
  for (int i = e + threadIdx.x; i < i1; i += blockDim.x) point(i, i / d.Nf, i % d.Nf);
}

// The four points i .. i + 3 from (f, n) of the first, row by row.
__device__ __forceinline__ void step(int& f, int& n, int Nf) {
  if (++n == Nf) {
    n = 0;
    ++f;
  }
}

struct FwdIn {
  float4 ph, dp;
};

__global__ void __launch_bounds__(kThreads)
design_fwd_kernel(const float* __restrict__ p, const float* __restrict__ w,
                  const float* __restrict__ phases, const int* __restrict__ jrow,
                  const float* __restrict__ trow, const float* __restrict__ ola,
                  const float* __restrict__ dpc, float2* __restrict__ H, const Dims d, bool vec) {
  extern __shared__ float4 smem_f4[];
  const Staged st = carve(d, reinterpret_cast<float*>(smem_f4), false);
  const int b = blockIdx.y;
  const size_t base = (size_t)b * d.F * d.Nf;
  const Rows r = rows_of(jrow, d, blockIdx.x);
  auto value = [&](int f, int n, float dp, float ph) {
    const float A = (envelope(st, r, d.Nf, f, n) + 1e-6f) * st.ola[n] + dp;
    float s, c;
    sincosf(ph, &s, &c);
    return make_float2(A * c, A * s);
  };
  for_points<FwdIn>(
      d, r, vec,
      [&](int i) {
        return FwdIn{__ldg(reinterpret_cast<const float4*>(phases + base + i)),
                     __ldg(reinterpret_cast<const float4*>(dpc + i))};
      },
      [&] { stage(p, w, jrow, trow, ola, d, b, r, st); },
      [&](int i, int f, int n, const FwdIn& v) {
        const float2 h0 = value(f, n, v.dp.x, v.ph.x);
        step(f, n, d.Nf);
        const float2 h1 = value(f, n, v.dp.y, v.ph.y);
        step(f, n, d.Nf);
        const float2 h2 = value(f, n, v.dp.z, v.ph.z);
        step(f, n, d.Nf);
        const float2 h3 = value(f, n, v.dp.w, v.ph.w);
        float4* o = reinterpret_cast<float4*>(H + base + i);
        o[0] = make_float4(h0.x, h0.y, h1.x, h1.y);
        o[1] = make_float4(h2.x, h2.y, h3.x, h3.y);
      },
      [&](int i, int f, int n) {
        H[base + i] = value(f, n, __ldg(dpc + i), __ldg(phases + base + i));
      });
}

struct BwdIn {
  float4 ph, dp, ga, gb;
};

// sum of v over a warp's lanes, a fixed tree
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// dL/dphases, and dL/dweights and dL/ddecay through the CTAs' partial sums;
// part: (B, nb, bands, E) float2 (d weights, d decay), tickets: B zeroed
// counters (left zero).
__global__ void __launch_bounds__(kThreads)
design_bwd_kernel(const float* __restrict__ p, const float* __restrict__ w,
                  const float* __restrict__ phases, const float2* __restrict__ gH,
                  const int* __restrict__ jrow, const float* __restrict__ trow,
                  const float* __restrict__ ola, const float* __restrict__ dpc,
                  float* __restrict__ gphases, float2* __restrict__ part,
                  unsigned* __restrict__ tickets, float* __restrict__ gp, float* __restrict__ gw,
                  const Dims d, bool vec) {
  extern __shared__ float4 smem_f4[];
  const Staged st = carve(d, reinterpret_cast<float*>(smem_f4), true);
  float* gI = st.tail;                 // [f - r0][n]; then the last CTA's pairs
  __shared__ bool last;
  const int b = blockIdx.y, blk = blockIdx.x;
  const size_t base = (size_t)b * d.F * d.Nf;
  const Rows r = rows_of(jrow, d, blk);
  const int i0 = r.r0 * d.Nf;
  // (dL/dphases, dL/dI) of one point
  auto grads = [&](int f, int n, float dp, float ph, float gx, float gy, float* gph) {
    const float P = envelope(st, r, d.Nf, f, n);
    const float o = st.ola[n];
    const float A = (P + 1e-6f) * o + dp;
    float s, c;
    sincosf(ph, &s, &c);
    *gph = A * (gy * c - gx * s);
    return (gx * c + gy * s) * o * P;
  };
  for_points<BwdIn>(
      d, r, vec,
      [&](int i) {
        const float4* g4 = reinterpret_cast<const float4*>(gH + base + i);
        return BwdIn{__ldg(reinterpret_cast<const float4*>(phases + base + i)),
                     __ldg(reinterpret_cast<const float4*>(dpc + i)), __ldg(g4), __ldg(g4 + 1)};
      },
      [&] { stage(p, w, jrow, trow, ola, d, b, r, st); },
      [&](int i, int f, int n, const BwdIn& v) {
        float4 out;
        float* gi = gI + (i - i0);
        gi[0] = grads(f, n, v.dp.x, v.ph.x, v.ga.x, v.ga.y, &out.x);
        step(f, n, d.Nf);
        gi[1] = grads(f, n, v.dp.y, v.ph.y, v.ga.z, v.ga.w, &out.y);
        step(f, n, d.Nf);
        gi[2] = grads(f, n, v.dp.z, v.ph.z, v.gb.x, v.gb.y, &out.z);
        step(f, n, d.Nf);
        gi[3] = grads(f, n, v.dp.w, v.ph.w, v.gb.z, v.gb.w, &out.w);
        *reinterpret_cast<float4*>(gphases + base + i) = out;
      },
      [&](int i, int f, int n) {
        const float2 g = __ldg(gH + base + i);
        gI[i - i0] = grads(f, n, __ldg(dpc + i), __ldg(phases + base + i), g.x, g.y,
                           gphases + base + i);
      });
  __syncthreads();
  // the partial rows of breakpoints q0 .. q0 + nq - 1 over this CTA's rows
  // (rows with j = q - 1 weigh q by t, rows with j = q by 1 - t, ascending),
  // divided by full + 1e-6, into lf's place (no longer read)
  float* g_full = st.lf;
  for (int i = threadIdx.x; i < r.nq * d.Nf; i += blockDim.x) {
    const int qq = i / d.Nf, n = i - qq * d.Nf;
    float acc = 0.f;
    const int a = qq > 0 ? st.lo[qq - 1] : 0, m = st.lo[qq], e = st.lo[qq + 1];
#pragma unroll 4
    for (int fl = a; fl < m; ++fl) acc += st.t[fl] * gI[fl * d.Nf + n];
#pragma unroll 4
    for (int fl = m; fl < e; ++fl) acc += (1.f - st.t[fl]) * gI[fl * d.Nf + n];
    g_full[i] = acc / st.fe[i];
  }
  __syncthreads();
  // the CTA's (d weights, d decay) of every (e, k), a warp each: zero where
  // its rows do not touch breakpoint q = k + pad
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float2* pc = part + ((size_t)b * d.nb + blk) * d.bands * d.E;
  for (int task = threadIdx.x >> 5; task < d.bands * d.E; task += warps) {
    const int k = task / d.E, e = task - k * d.E, qq = k + d.pad - r.q0;
    float sw = 0.f, sp = 0.f;
    if (qq >= 0 && qq < r.nq) {
      const float pe = st.dec[e * d.bands + k], we = st.wt[e * d.bands + k];
      for (int n = lane; n < d.Nf; n += 32) {
        const float decayed = powf(pe, -(float)n), g = g_full[qq * d.Nf + n];
        sw += g * decayed;
        sp += g * we * (-(float)n) * decayed;
      }
      sw = warp_sum(sw);
      sp = warp_sum(sp);
    }
    if (lane == 0) pc[task] = make_float2(sw, sp);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == (unsigned)(d.nb - 1);
  __syncthreads();
  if (!last) return;
  // the b's last CTA: every CTA's pairs at once into shared memory
  // ([task][c]), then a warp a task adds them in CTA order (lane c takes
  // CTA c, c + 32, ...)
  __threadfence();
  const int tasks = d.bands * d.E;
  float2* pairs = reinterpret_cast<float2*>(gI);
  const float2* pb = part + (size_t)b * d.nb * tasks;
  for (int i = threadIdx.x; i < tasks * d.nb; i += blockDim.x) {
    const int c = i / tasks, task = i - c * tasks;
    pairs[task * d.nb + c] = __ldcg(pb + i);
  }
  __syncthreads();
  for (int task = threadIdx.x >> 5; task < tasks; task += warps) {
    const int k = task / d.E, e = task - k * d.E;
    float sw = 0.f, sp = 0.f;
    for (int c = lane; c < d.nb; c += 32) {
      const float2 v = pairs[task * d.nb + c];
      sw += v.x;
      sp += v.y;
    }
    sw = warp_sum(sw);
    sp = warp_sum(sp);
    if (lane == 0) {
      const size_t pi = ((size_t)b * d.E + e) * d.bands + k;
      gw[pi] = sw;
      gp[pi] = sp;
    }
  }
  if (threadIdx.x == 0) tickets[b] = 0u;
}

// floats of a CTA's dynamic shared memory: the staged arrays (with fe for
// the backward) and, for the backward, its rows of dL/dI (then the last
// CTA's pairs)
size_t smem_floats(const Dims& d, bool bwd) {
  const size_t gi = (size_t)d.R * d.Nf, pairs = 2 * (size_t)d.bands * d.E * d.nb;
  return staged_floats(d, bwd) + (bwd ? (gi > pairs ? gi : pairs) : 0);
}

// The shape and the wrapper's schedule, checked: R rows a CTA, nb CTAs a b,
// breakpoints 2 <= qmax <= Q, and the CTA's shared memory within the cap.
bool read_dims(int B, int F, int Nf, int E, int bands, int Q, int pad, int R, int nb, int qmax,
               bool bwd, Dims* d) {
  *d = Dims{F, Nf, E, bands, Q, pad, R, nb, qmax};
  return B >= 1 && F >= 1 && Nf >= 1 && E >= 1 && bands >= 1 && bands + 2 * pad == Q &&
         R >= 1 && nb == (F + R - 1) / R && qmax >= 2 && qmax <= Q &&
         smem_floats(*d, bwd) * sizeof(float) <= kSmemMax;
}

int allow_smem(const void* kernel) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemMax);
}

}  // namespace

extern "C" int filter_design_fwd(const float* p, const float* w, const float* phases,
                                 const int* jrow, const float* trow, const float* ola,
                                 const float* dpc, float* H, int B, int F, int Nf, int E, int bands,
                                 int Q, int pad, int R, int nb, int qmax, cudaStream_t stream) {
  Dims d;
  if (!read_dims(B, F, Nf, E, bands, Q, pad, R, nb, qmax, false, &d))
    return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem((const void*)design_fwd_kernel);
  if (attr) return attr;
  design_fwd_kernel<<<dim3(d.nb, B), kThreads, sizeof(float) * smem_floats(d, false), stream>>>(
      p, w, phases, jrow, trow, ola, dpc, reinterpret_cast<float2*>(H), d, (F * Nf) % 4 == 0);
  return (int)cudaGetLastError();
}

extern "C" int filter_design_bwd(const float* p, const float* w, const float* phases,
                                 const float* gH, const int* jrow, const float* trow,
                                 const float* ola, const float* dpc, float* gphases, float* part,
                                 unsigned* tickets, float* gp, float* gw, int B, int F, int Nf,
                                 int E, int bands, int Q, int pad, int R, int nb, int qmax,
                                 cudaStream_t stream) {
  Dims d;
  if (!read_dims(B, F, Nf, E, bands, Q, pad, R, nb, qmax, true, &d))
    return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem((const void*)design_bwd_kernel);
  if (attr) return attr;
  design_bwd_kernel<<<dim3(d.nb, B), kThreads, sizeof(float) * smem_floats(d, true), stream>>>(
      p, w, phases, reinterpret_cast<const float2*>(gH), jrow, trow, ola, dpc, gphases,
      reinterpret_cast<float2*>(part), tickets, gp, gw, d, (F * Nf) % 4 == 0);
  return (int)cudaGetLastError();
}
