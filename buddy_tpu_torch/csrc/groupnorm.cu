// K1 — GroupNorm(+SiLU) forward and backward.
//
// Replaces the Pallas pair of scripts/tpu_pallas_gn_probe.py (pallas_gn:
// _stats_kernel :39, _norm_kernel :55) and the vjp of what it computes,
// buddy_tpu/models/layers.py::GroupNormAct: groups over contiguous channel
// blocks, float32 statistics from per-channel first and second moments
// (var = E[x^2] - E[x]^2), eps inside the rsqrt, affine, then SiLU when
// asked.
//
// Layout: x, dy, y and dx are (B, HW, C) contiguous (an NCHW tensor in
// channels_last memory format), bfloat16 or float32; each thread moves 16
// bytes at a time (8 bf16 or 4 float channels; channel counts that are not
// a multiple of that take one channel a thread).
//
// What bounds it on the H100: bytes.  A pass does a few operations an
// element, far below the card's ridge, so the least time is the bytes over
// 3.35 TB/s: the forward reads x and writes y, the backward reads x and dy
// and writes dx.  The TPU carried its sums across a sequential grid; here
// blocks run in parallel in no order, so the statistics are a two-level
// reduction without atomics, summed in a fixed order (bit-identical run to
// run):
//
// two launches a pass.  The statistics kernel gives each CTA a slab of rows
// of one utterance (the slab count sized from the SM count); each thread
// keeps its channels' sums in registers over the whole slab and the CTA
// reduces them once, at the end, to per-group partials.  The second kernel
// forms the group statistics and the per-channel coefficients in its
// prologue from those partials and normalises (or forms dx); it walks the
// slabs in the reverse order, so that its first CTAs find the statistics
// pass's last rows still in the L2.  The backward's second kernel also sums
// d weight and d bias from per-channel partials, in extra CTAs, when they
// are asked for.  (A persistent cooperative variant that walked the tensor
// in L2-sized chunks was measured slower at all four of the U-Net's shapes:
// PERF.md, Findings.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// CTAs of kThreads an SM (forward, backward; their registers are capped to fit)
constexpr int kThreads = 256, kFwdCtas = 4, kBwdCtas = 2;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// 16-byte vectors of VEC channels: loaded raw, converted to float at use
// ---------------------------------------------------------------------------
template <class T, int VEC> struct Io;

template <> struct Io<float, 4> {
  typedef float4 Raw;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Io<bf16, 8> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) {
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    uint4 q;
    bf16* h = reinterpret_cast<bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};
template <class T> struct Io<T, 1> {
  typedef T Raw;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& q, float* v) { v[0] = to_float(q); }
  static __device__ __forceinline__ void store(T* p, const float* v) { *p = from_float(v[0]); }
  static __device__ __forceinline__ float to_float(float q) { return q; }
  static __device__ __forceinline__ float to_float(bf16 q) { return __bfloat162float(q); }
  static __device__ __forceinline__ T from_float(float v) {
    if constexpr (sizeof(T) == 4) return v; else return __float2bfloat16(v);
  }
};

// rows each thread has in flight: its loads of kUnroll rows are issued
// before any is used, so that enough bytes are on the way to fill the
// memory system (a 16-byte load at a time per thread would not)
constexpr int kUnroll = 4;

__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }

// d silu(u) / du times g
__device__ __forceinline__ float silu_grad(float u, float g) {
  const float s = 1.f / (1.f + expf(-u));
  return g * (s * (1.f + u * (1.f - s)));
}

// One CTA over rows [r0, r1) of one utterance: thread t takes channels
// lane VEC.. of rows r0 + sub, r0 + sub + rpi, ... (lane = t mod L,
// sub = t / L, L = C / VEC, rpi = threads / L).
struct Tile {
  int lane, sub, rpi;
  bool active;
  __device__ Tile(int C, int vec) {
    const int L = C / vec;
    rpi = blockDim.x / L;
    lane = threadIdx.x % L;
    sub = threadIdx.x / L;
    active = sub < rpi;
  }
};

// The CTA's per-thread sums s[2][VEC] -> per-channel sums out[2][C] in
// shared memory, in a fixed order (red: 2 rpi C floats of scratch).
template <int VEC>
__device__ void reduce_channels(const float (&s)[2][VEC], const Tile& t, int C, float* red,
                                float* out) {
  if (t.active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[t.sub * C + t.lane * VEC + i] = s[0][i];
      red[(t.rpi + t.sub) * C + t.lane * VEC + i] = s[1][i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    const int k = c / C, ch = c - k * C;
    const float* r = red + k * t.rpi * C + ch;
    float acc = 0.f;
    for (int j = 0; j < t.rpi; ++j) acc += r[j * C];
    out[c] = acc;
  }
  __syncthreads();
}

// Per-group sums over the C / gs groups, from per-channel sums ch[2][C]
// (weighted by w[c] when w is given) -> dst (2 floats a group: [g][0], [g][1]).
__device__ void write_group_partials(const float* ch, int C, int gs, const float* w, float* dst) {
  const int G = C / gs;
  for (int i = threadIdx.x; i < 2 * G; i += blockDim.x) {
    const int g = i >> 1, k = i & 1;
    float acc = 0.f;
    for (int j = 0; j < gs; ++j) {
      const int c = g * gs + j;
      acc += w ? w[c] * ch[k * C + c] : ch[k * C + c];
    }
    dst[i] = acc;
  }
}

// Sum n_parts partial vectors of nv floats (part p at src + p * stride) in
// a fixed order -> dst[nv] in shared memory (scratch: blockDim floats):
// `ways` threads a value each sum every ways-th part (several loads in
// flight), then one adds theirs.
__device__ void sum_partials(const float* src, int n_parts, long stride, int nv, float* scratch,
                             float* dst) {
  constexpr int U = 8;                  // loads in flight a thread, added in order
  const int ways = max(1, (int)blockDim.x / nv);
  const int mine = ways == 1 ? nv : ways * nv;
  for (int t = threadIdx.x; t < mine; t += blockDim.x) {
    const int v = t % nv, w = t / nv;
    float acc = 0.f;
    for (int p0 = w; p0 < n_parts; p0 += U * ways) {
      float q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * ways;
        q[u] = p < n_parts ? src[p * stride + v] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) acc += q[u];
    }
    if (ways == 1) dst[v] = acc; else scratch[t] = acc;
  }
  __syncthreads();
  if (ways == 1) return;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < ways; ++w) acc += scratch[w * nv + v];
    dst[v] = acc;
  }
  __syncthreads();
}

// mean and rstd of G groups from their sums (s1, s2) -> ms[2 G]; the
// per-channel a = rstd w, sh = bias - mean a -> a_s, sh_s.
__device__ void forward_coefficients(const float* gsum, int G, int gs, float count, float eps,
                                     const float* w, const float* bias, float* ms, float* a_s,
                                     float* sh_s) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float m = gsum[2 * g] / count;
    const float m2 = gsum[2 * g + 1] / count;
    ms[2 * g] = m;
    ms[2 * g + 1] = rsqrtf(m2 - m * m + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < G * gs; c += blockDim.x) {
    const int g = c / gs;
    const float a = ms[2 * g + 1] * w[c];
    a_s[c] = a;
    sh_s[c] = bias[c] - ms[2 * g] * a;
  }
  __syncthreads();
}

// a and sh of C channels from the forward's mean and rstd (mr: 2 floats a
// group of the utterance).
__device__ void affine_from_stats(const float* mr, int C, int gs, const float* w,
                                  const float* bias, float* a_s, float* sh_s) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / gs;
    const float a = mr[2 * g + 1] * w[c];
    a_s[c] = a;
    sh_s[c] = bias[c] - mr[2 * g] * a;
  }
  __syncthreads();
}

// c2, c3 of G groups (-> cc[2 G]) from the weighted sums (A1 = sum w du,
// A2 = sum w du x) and the group's mean and rstd.
__device__ void backward_coefficients(const float* gsum, const float* mr, int G, float count,
                                      float* cc) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float mean = mr[2 * g], rstd = mr[2 * g + 1];
    const float m1 = gsum[2 * g] / count;
    const float m2 = rstd * (gsum[2 * g + 1] - mean * gsum[2 * g]) / count;
    cc[2 * g] = -rstd * rstd * m2;
    cc[2 * g + 1] = -rstd * m1 + mean * rstd * rstd * m2;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the passes over a tile of rows: x points at (b, row 0, channel 0)
// ---------------------------------------------------------------------------
template <class T, int VEC>
__device__ void stats_rows(const T* x, int C, int r0, int r1, const Tile& t, float (&s)[2][VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[0][i] = s[1][i] = 0.f;
  if (!t.active) return;
  const T* p = x + t.lane * VEC;
  for (int r = r0 + t.sub; r < r1; r += kUnroll * t.rpi) {
    typename Io<T, VEC>::Raw q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * t.rpi < r1) q[u] = Io<T, VEC>::load(p + (size_t)(r + u * t.rpi) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.rpi >= r1) break;
      float v[VEC];
      Io<T, VEC>::unpack(q[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[0][i] += v[i];
        s[1][i] = fmaf(v[i], v[i], s[1][i]);
      }
    }
  }
}

template <class T, int VEC>
__device__ void apply_rows(const T* x, T* y, int C, int r0, int r1, const Tile& t,
                           const float* a_s, const float* sh_s, bool act) {
  if (!t.active) return;
  float a[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = a_s[t.lane * VEC + i];
    sh[i] = sh_s[t.lane * VEC + i];
  }
  const size_t off = t.lane * VEC;
  for (int r = r0 + t.sub; r < r1; r += kUnroll * t.rpi) {
    typename Io<T, VEC>::Raw q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * t.rpi < r1) q[u] = Io<T, VEC>::load(x + (size_t)(r + u * t.rpi) * C + off);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.rpi >= r1) break;
      float v[VEC];
      Io<T, VEC>::unpack(q[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float w = fmaf(v[i], a[i], sh[i]);
        v[i] = act ? silu(w) : w;
      }
      Io<T, VEC>::store(y + (size_t)(r + u * t.rpi) * C + off, v);
    }
  }
}

// s[0] = sum du, s[1] = sum du x, du the gradient at the pre-activation
template <class T, int VEC>
__device__ void bwd_stats_rows(const T* x, const T* dy, int C, int r0, int r1, const Tile& t,
                               const float* a_s, const float* sh_s, bool act,
                               float (&s)[2][VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[0][i] = s[1][i] = 0.f;
  if (!t.active) return;
  float a[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = a_s[t.lane * VEC + i];
    sh[i] = sh_s[t.lane * VEC + i];
  }
  const size_t off = t.lane * VEC;
  for (int r = r0 + t.sub; r < r1; r += kUnroll * t.rpi) {
    typename Io<T, VEC>::Raw qx[kUnroll], qg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * t.rpi < r1) {
        const size_t o = (size_t)(r + u * t.rpi) * C + off;
        qx[u] = Io<T, VEC>::load(x + o);
        qg[u] = Io<T, VEC>::load(dy + o);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.rpi >= r1) break;
      float v[VEC], g[VEC];
      Io<T, VEC>::unpack(qx[u], v);
      Io<T, VEC>::unpack(qg[u], g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float du = act ? silu_grad(fmaf(v[i], a[i], sh[i]), g[i]) : g[i];
        s[0][i] += du;
        s[1][i] = fmaf(du, v[i], s[1][i]);
      }
    }
  }
}

// dx = a du + c2 x + c3 (cc: c2, c3 of the range's groups)
template <class T, int VEC>
__device__ void bwd_apply_rows(const T* x, const T* dy, T* dx, int C, int r0, int r1,
                               const Tile& t, const float* a_s, const float* sh_s,
                               const float* cc, int gs, bool act) {
  if (!t.active) return;
  float a[VEC], sh[VEC], c2[VEC], c3[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.lane * VEC + i;
    a[i] = a_s[c];
    sh[i] = sh_s[c];
    c2[i] = cc[2 * (c / gs)];
    c3[i] = cc[2 * (c / gs) + 1];
  }
  const size_t off = t.lane * VEC;
  for (int r = r0 + t.sub; r < r1; r += kUnroll * t.rpi) {
    typename Io<T, VEC>::Raw qx[kUnroll], qg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * t.rpi < r1) {
        const size_t o = (size_t)(r + u * t.rpi) * C + off;
        qx[u] = Io<T, VEC>::load(x + o);
        qg[u] = Io<T, VEC>::load(dy + o);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * t.rpi >= r1) break;
      float v[VEC], g[VEC];
      Io<T, VEC>::unpack(qx[u], v);
      Io<T, VEC>::unpack(qg[u], g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float du = act ? silu_grad(fmaf(v[i], a[i], sh[i]), g[i]) : g[i];
        g[i] = fmaf(a[i], du, fmaf(c2[i], v[i], c3[i]));
      }
      Io<T, VEC>::store(dx + (size_t)(r + u * t.rpi) * C + off, g);
    }
  }
}

struct Shape {
  int B, HW, C, G, gs, S, RS;            // RS: rows a slab (S slabs an utterance)
  float count, eps;
};

// shared memory of a kernel over C channels and G groups, in bytes:
// reduce_channels' scratch and channel sums, a and sh, the groups' sums and
// statistics, and a float a thread
inline size_t smem_bytes(int C, int G, int threads, int vec) {
  return sizeof(float) * ((size_t)2 * threads * vec + 4 * C + 4 * G + threads);
}

// ---------------------------------------------------------------------------
// two launches a pass
// ---------------------------------------------------------------------------
// part[b][s][G][2]: per-group (sum x, sum x^2) of slab s
template <class T, int VEC>
__global__ void __launch_bounds__(kThreads, kFwdCtas)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, Shape sh) {
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int s = blockIdx.x, b = blockIdx.y;
  const Tile t(sh.C, VEC);
  float acc[2][VEC];
  stats_rows<T, VEC>(x + (size_t)b * sh.HW * sh.C, sh.C, s * sh.RS, min(sh.HW, (s + 1) * sh.RS),
                     t, acc);
  float* ch = sm + 2 * t.rpi * sh.C;
  reduce_channels<VEC>(acc, t, sh.C, sm, ch);
  write_group_partials(ch, sh.C, sh.gs, nullptr, part + ((size_t)b * sh.S + s) * sh.G * 2);
}

// y = act(x a + sh); the statistics from part; mr[b][G][2] = (mean, rstd)
// written by each utterance's first CTA
template <class T, int VEC>
__global__ void __launch_bounds__(kThreads, kFwdCtas)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ part,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ mr, Shape sh, int act) {
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  float *a_s = sm, *sh_s = sm + sh.C, *gsum = sm + 2 * sh.C, *ms = gsum + 2 * sh.G,
        *scratch = ms + 2 * sh.G;
  const int s = sh.S - 1 - blockIdx.x, b = sh.B - 1 - blockIdx.y;
  sum_partials(part + (size_t)b * sh.S * sh.G * 2, sh.S, sh.G * 2, sh.G * 2, scratch, gsum);
  forward_coefficients(gsum, sh.G, sh.gs, sh.count, sh.eps, w, bias, ms, a_s, sh_s);
  if (s == 0)
    for (int i = threadIdx.x; i < 2 * sh.G; i += blockDim.x) mr[(size_t)b * sh.G * 2 + i] = ms[i];
  const Tile t(sh.C, VEC);
  const size_t base = (size_t)b * sh.HW * sh.C;
  apply_rows<T, VEC>(x + base, y + base, sh.C, s * sh.RS, min(sh.HW, (s + 1) * sh.RS), t, a_s,
                     sh_s, act);
}

// pg[b][s][G][2]: per-group (sum w du, sum w du x); pc[b][s][2][C] the
// per-channel (sum du, sum du x) when d weight is asked for
template <class T, int VEC>
__global__ void __launch_bounds__(kThreads, kBwdCtas)
gn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ mr, float* __restrict__ pg,
                    float* __restrict__ pc, Shape sh, int act) {
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int s = blockIdx.x, b = blockIdx.y;
  const Tile t(sh.C, VEC);
  float* a_s = sm + 2 * t.rpi * sh.C + 2 * sh.C;   // past the reduction's scratch
  float* sh_s = a_s + sh.C;
  affine_from_stats(mr + (size_t)b * sh.G * 2, sh.C, sh.gs, w, bias, a_s, sh_s);
  const size_t base = (size_t)b * sh.HW * sh.C;
  float acc[2][VEC];
  bwd_stats_rows<T, VEC>(x + base, dy + base, sh.C, s * sh.RS, min(sh.HW, (s + 1) * sh.RS), t,
                         a_s, sh_s, act, acc);
  float* ch = sm + 2 * t.rpi * sh.C;
  reduce_channels<VEC>(acc, t, sh.C, sm, ch);
  const size_t slab = (size_t)b * sh.S + s;
  write_group_partials(ch, sh.C, sh.gs, w, pg + slab * sh.G * 2);
  if (pc)
    for (int i = threadIdx.x; i < 2 * sh.C; i += blockDim.x) pc[slab * 2 * sh.C + i] = ch[i];
}

// d weight[c] = sum_b rstd (sum du x - mean sum du), d bias[c] = sum_b sum du
// for the 32 channels [c0, c0 + 32), from the per-channel partials
// pc[b][s][2][C] = (sum du, sum du x) of slab s.  scratch: 2 blockDim floats.
__device__ void weight_grads(const float* pc, int S, const float* mr, int B, int C, int gs,
                             int c0, float* scratch, float* dw, float* db) {
  const int c = c0 + (threadIdx.x & 31), rows = blockDim.x / 32, bb = threadIdx.x / 32;
  const int G = C / gs;
  float sw = 0.f, sb = 0.f;
  if (c < C) {
    for (int b = bb; b < B; b += rows) {
      const float* p = pc + (size_t)b * S * 2 * C + c;
      float du = 0.f, dux = 0.f;
      for (int s = 0; s < S; ++s) {
        du += p[(size_t)s * 2 * C];
        dux += p[(size_t)s * 2 * C + C];
      }
      const float* m = mr + ((size_t)b * G + c / gs) * 2;
      sw += m[1] * (dux - m[0] * du);
      sb += du;
    }
  }
  scratch[threadIdx.x] = sw;
  scratch[blockDim.x + threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.x < 32 && c < C) {
    float aw = 0.f, ab = 0.f;
    for (int r = 0; r < rows; ++r) {
      aw += scratch[r * 32 + threadIdx.x];
      ab += scratch[blockDim.x + r * 32 + threadIdx.x];
    }
    dw[c] = aw;
    db[c] = ab;
  }
  __syncthreads();
}

// dx; CTAs past the B S tiles sum d weight and d bias when dw is given
template <class T, int VEC>
__global__ void __launch_bounds__(kThreads, kBwdCtas)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ mr, const float* __restrict__ pg,
                    const float* __restrict__ pc, float* __restrict__ dw,
                    float* __restrict__ db, Shape sh, int act) {
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int tiles = sh.B * sh.S;
  if ((int)blockIdx.x >= tiles) {
    weight_grads(pc, sh.S, mr, sh.B, sh.C, sh.gs, (blockIdx.x - tiles) * 32, sm, dw, db);
    return;
  }
  const int tile = tiles - 1 - blockIdx.x;
  const int b = tile / sh.S, s = tile - b * sh.S;
  float *a_s = sm, *sh_s = sm + sh.C, *gsum = sm + 2 * sh.C, *cc = gsum + 2 * sh.G,
        *scratch = cc + 2 * sh.G;
  const float* mrb = mr + (size_t)b * sh.G * 2;
  affine_from_stats(mrb, sh.C, sh.gs, w, bias, a_s, sh_s);
  sum_partials(pg + (size_t)b * sh.S * sh.G * 2, sh.S, sh.G * 2, sh.G * 2, scratch, gsum);
  backward_coefficients(gsum, mrb, sh.G, sh.count, cc);
  const Tile t(sh.C, VEC);
  const size_t base = (size_t)b * sh.HW * sh.C;
  bwd_apply_rows<T, VEC>(x + base, dy + base, dx + base, sh.C, s * sh.RS,
                         min(sh.HW, (s + 1) * sh.RS), t, a_s, sh_s, cc, sh.gs, act);
}

template <class T, int VEC>
int forward_t(const void* xv, void* yv, const float* w, const float* bias, float* mr, float* part,
              Shape sh, int act, cudaStream_t stream) {
  const T* x = reinterpret_cast<const T*>(xv);
  T* y = reinterpret_cast<T*>(yv);
  const size_t smem = smem_bytes(sh.C, sh.G, kThreads, VEC);
  gn_stats_kernel<T, VEC><<<dim3(sh.S, sh.B), kThreads, smem, stream>>>(x, part, sh);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  gn_apply_kernel<T, VEC><<<dim3(sh.S, sh.B), kThreads, smem, stream>>>(x, y, part, w, bias, mr,
                                                                        sh, act);
  return (int)cudaGetLastError();
}

template <class T, int VEC>
int backward_t(const void* xv, const void* dyv, void* dxv, const float* w, const float* bias,
               const float* mr, float* pg, float* pc, float* dw, float* db, Shape sh, int act,
               cudaStream_t stream) {
  const T* x = reinterpret_cast<const T*>(xv);
  const T* dy = reinterpret_cast<const T*>(dyv);
  T* dx = reinterpret_cast<T*>(dxv);
  const size_t smem = smem_bytes(sh.C, sh.G, kThreads, VEC);
  gn_bwd_stats_kernel<T, VEC><<<dim3(sh.S, sh.B), kThreads, smem, stream>>>(
      x, dy, w, bias, mr, pg, dw ? pc : nullptr, sh, act);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int extra = dw ? (sh.C + 31) / 32 : 0;
  gn_bwd_apply_kernel<T, VEC><<<sh.B * sh.S + extra, kThreads, smem, stream>>>(
      x, dy, dx, w, bias, mr, pg, pc, dw, db, sh, act);
  return (int)cudaGetLastError();
}

// The shape, or false where the kernels do not take it: C a multiple of G
// and of the vector, a row of lanes within a CTA, slabs covering the rows.
bool make_shape(int B, int HW, int C, int G, int S, int RS, float eps, int vec, Shape* sh) {
  if (B < 1 || HW < 1 || C < 1 || G < 1 || C % G || S < 1 || RS < 1 || (long)S * RS < HW ||
      C % vec || C / vec > kThreads)
    return false;
  *sh = Shape{B, HW, C, G, C / G, S, RS, (float)HW * (C / G), eps};
  return true;
}

}  // namespace

// x, y: (B, HW, C) bfloat16 (bf16 = 1) or float32; w, bias: (C,) float32;
// mr: (B, G, 2) mean and rstd out; part: (B, S, G, 2) scratch.
extern "C" int gn_forward(const void* x, void* y, const float* w, const float* bias, float* mr,
                          float* part, int B, int HW, int C, int G, int S, int RS, float eps,
                          int bf16_io, int act, cudaStream_t stream) {
  const int wide = bf16_io ? 8 : 4;
  const int vec = C % wide == 0 ? wide : 1;
  Shape sh;
  if (!make_shape(B, HW, C, G, S, RS, eps, vec, &sh)) return (int)cudaErrorInvalidValue;
  if (bf16_io)
    return vec == 8 ? forward_t<bf16, 8>(x, y, w, bias, mr, part, sh, act, stream)
                    : forward_t<bf16, 1>(x, y, w, bias, mr, part, sh, act, stream);
  return vec == 4 ? forward_t<float, 4>(x, y, w, bias, mr, part, sh, act, stream)
                  : forward_t<float, 1>(x, y, w, bias, mr, part, sh, act, stream);
}

// dx from x, dy and the forward's mr; dw, db: (C,) float32, or null when
// not asked for (pc is then not written).  pg: (B, S, G, 2) and pc:
// (B, S, 2, C) scratch.
extern "C" int gn_backward(const void* x, const void* dy, void* dx, const float* w,
                           const float* bias, const float* mr, float* pg, float* pc, float* dw,
                           float* db, int B, int HW, int C, int G, int S, int RS, int bf16_io,
                           int act, cudaStream_t stream) {
  const int wide = bf16_io ? 8 : 4;
  const int vec = C % wide == 0 ? wide : 1;
  Shape sh;
  if (!make_shape(B, HW, C, G, S, RS, 0.f, vec, &sh) || (dw == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
#define BWD(T, V) backward_t<T, V>(x, dy, dx, w, bias, mr, pg, pc, dw, db, sh, act, stream)
  if (bf16_io) return vec == 8 ? BWD(bf16, 8) : BWD(bf16, 1);
  return vec == 4 ? BWD(float, 4) : BWD(float, 1);
#undef BWD
}
