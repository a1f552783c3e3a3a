// K7 — the WPE normal equations: (R + load I) G = P for a batch of small
// complex systems, load = diag_rel * Re trace(R) / n + eps formed in the
// kernel.
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
// The schedule, the same in both routes below (tests/test_torch_wpe_plan.py
// runs it in numpy float64):
// - the augmented matrix [R + load I | P] (load from Re trace(R) summed as
//   four partial sums over i mod 4, added in a fixed order);
// - implicit pivoting: rows never move.  Step k takes as pivot the live row
//   with the largest |a[i][k]|^2 (computed without a fused multiply-add),
//   the lowest row index on a tie, marks it dead and records it as U's row
//   k; every live row i gets l[i] = a[i][k] * (1 / a[p][k]), dead rows 0,
//   and a[i][j] -= l[i] * a[p][j] for the columns j > k, P's included;
// - back substitution on U's rows in step order: x_k = (U[k][n] - sum_j>k
//   U[k][j] x_j) * (1 / U[k][k]), taken column by column.
// The reciprocals are the hardware's approximation refined by two Newton
// steps (within an ulp or two of 1 / d).  Every order is fixed, so the
// pivot sequence, and every bit of G, is the same from call to call.
//
// Route 1, the registers (n <= 64; the main path's n = 50).  What bounds it
// is latency: the float64 work, 8 n^3 / 3 real operations a system (0.685
// GFLOP for the 2056 systems of a main-path call), takes ~20 us on the FP64
// pipes (~10 us on the tensor cores), but a system is a chain of n pivot
// searches, each a warp reduction, a broadcast and a reciprocal, and its
// matrix in registers (40 KB) leaves room for 3 systems an SM.  So:
// - one CTA a system, persistent (a grid of 3 CTAs an SM loops over the
//   systems); the next system's R and P are copied into shared memory with
//   cp.async while this one is solved;
// - the matrix in registers in a 2-D cyclic layout: lane l of warp w holds
//   rows r * 32 + l and columns c * PC + w (RS row and CS column slots a
//   thread, PC warps), so a column lives in one warp and a warp's columns
//   update together.  The instances (ops/wpe_solve.py::solve_route picks the
//   smallest that holds n + 1 columns): n <= 16, one warp; n <= 32, two;
//   n <= 51 and n <= 64, four warps and 64 rows.  Rows past n are zeros and
//   dead from the start, so they never pivot;
// - no barrier a step: the warp that owns column k+1 brings it up to date
//   with step k, searches it (the key's high words reduced with one
//   redux.sync and a ballot; the whole key, then the lowest row, only when
//   two lanes tie there; every lane forms its own candidate's reciprocal
//   before the reduction), writes the next multipliers, pivot row and
//   reciprocal to a ring in shared memory and hands the step to each other
//   warp through a named barrier of the pair (bar.arrive by it, bar.sync by
//   the other), then updates its other columns; the other warps apply steps
//   in order as they arrive;
// - each warp's columns of U's row k are written by the lane that holds row
//   p_k, into U's rows in shared memory (padded to PC * CS columns, so the
//   update reads without a predicate), and read back by that warp after a
//   __syncwarp: only the multipliers cross warps;
// - back substitution by warp 0 from U: lane s keeps row s's right-hand
//   side; the owner of x_k forms it with the stored reciprocal of the pivot
//   and broadcasts it through a shuffle, and every row above takes its share.
//
// Route 2, large n (65 <= n <= 1024): one CTA a system of a persistent
// grid; the float64 [A | P] lives in a device-memory workspace of one
// matrix a CTA (the wrapper allocates grid x n (n+1) double2); the pivot row
// and the multiplier column are staged in shared memory; three barriers a
// step (pivot search, staging, update), a warp a live row in the update.
// Off the main path, and memory-bound: the trailing update reads and writes
// n^3 / 3 elements through the L2.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLargeThreads = 512;
constexpr int kMaxN = 1024;
// multiplier columns in flight between the warps of a system: a warp is at
// most PC - 1 steps behind the last published one, so PC + 2 slots would do
constexpr int kRing = 8;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a - b c
__device__ __forceinline__ double2 cmsub(double2 a, double2 b, double2 c) {
  a.x = fma(-b.x, c.x, a.x);
  a.x = fma(b.y, c.y, a.x);
  a.y = fma(-b.x, c.y, a.y);
  a.y = fma(-b.y, c.x, a.y);
  return a;
}

// 1 / d: the hardware's approximation, then two Newton steps
__device__ __forceinline__ double rcp64(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  return fma(r, fma(-d, r, 1.0), r);
}

__device__ __forceinline__ double2 crcp(double2 z) {
  const double s = rcp64(z.x * z.x + z.y * z.y);
  return make_double2(z.x * s, -z.y * s);
}

// |v|^2's bits + 1: ordered as |v|^2 for a live row (|v|^2 >= 0); NaN as 0.
// A dead row's key is 0.
__device__ __forceinline__ uint64_t pivot_key(double2 v) {
  const double m = __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y));
  return (m == m ? (uint64_t)__double_as_longlong(m) : 0ull) + 1ull;
}

// The warp's largest key and, among the lanes that hold it, the lowest row.
__device__ __forceinline__ void warp_pivot(uint64_t key, unsigned row, uint64_t* best,
                                           unsigned* best_row) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(key >> 32));
  const unsigned lo = __reduce_max_sync(0xffffffffu,
                                        (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
  *best = ((uint64_t)hi << 32) | lo;
  *best_row = __reduce_min_sync(0xffffffffu, key == *best ? row : 0xffffffffu);
}

__device__ __forceinline__ double2 shfl(double2 v, int src) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

// A step is handed from the warp that pivots to each other warp of the system
// through a named barrier of the pair (publisher q, consumer w): the publisher
// writes its multipliers, pivot row and reciprocal and arrives (bar.arrive,
// no wait); the consumer waits (bar.sync).  Barrier 1 + q (PC - 1) + d, with
// d = (w - q - 1) mod PC, serves the steps q, q + PC, ...: a warp is never PC
// steps behind, so a barrier is never reused before its last use completed.
__device__ __forceinline__ int step_barrier(int q, int w, int pc) {
  return 1 + q * (pc - 1) + (w - q - 1 + pc) % pc;
}

__device__ __forceinline__ void step_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(2 * kWarp) : "memory");
}

__device__ __forceinline__ void step_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(2 * kWarp) : "memory");
}

// U's packed row k (columns k+1 .. m) starts here
__host__ __device__ __forceinline__ int urow(int k, int m) { return k * m - k * (k - 1) / 2; }

// the register route's dynamic shared memory: a guard, U's rows (padded to
// the layout's pc * cs columns), the pivots' reciprocals, a ring of kRing
// multiplier columns, the staging area of the next system's R and P and the
// ring's pivot rows (ops/wpe_solve.py mirrors it)
__host__ __device__ __forceinline__ size_t reg_smem(int n, int rs, int pc, int cs) {
  return sizeof(double2) * ((size_t)pc + urow(n, pc * cs - 1) + n + kRing * rs * kWarp) +
         sizeof(float2) * (size_t)n * (n + 1) + kRing * sizeof(int);
}

template <int RS>
__device__ __forceinline__ double2 pick(const double2 (&v)[RS], int r) {
  double2 out = v[0];
#pragma unroll
  for (int s = 1; s < RS; ++s)
    if (s == r) out = v[s];
  return out;
}

// The pivot of the column this warp holds (col: its rows r * 32 + lane):
// the live row with the largest key, the lowest row on a tie.  One redux of
// the keys' high words and a ballot settle it unless two lanes tie there;
// every lane forms the reciprocal of its own candidate before the reduction.
// Writes the next multipliers (0 for dead rows and the pivot row), the pivot
// row and the pivot's reciprocal, and hands the step to the other warps.
template <int RS, int PC>
__device__ __forceinline__ void look_ahead(const double2 (&col)[RS], uint64_t dead, int lane,
                                           double2* lnext, int* pnext, double2* inv_next, int q) {
  uint64_t key = 0;
  unsigned row = 0;
  double2 bv = make_double2(1.0, 0.0);
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = r * kWarp + lane;
    const uint64_t kk = (dead >> i) & 1 ? 0ull : pivot_key(col[r]);
    if (kk > key) { key = kk; row = i; bv = col[r]; }
  }
  const double2 ivl = crcp(bv);
  const unsigned hi = (unsigned)(key >> 32);
  const unsigned tied = __ballot_sync(0xffffffffu, hi == __reduce_max_sync(0xffffffffu, hi));
  int src = __ffs(tied) - 1;
  if (tied & (tied - 1)) {
    uint64_t best;
    unsigned p;
    warp_pivot(key, row, &best, &p);
    src = p & (kWarp - 1);
  }
  const int p1 = (int)__shfl_sync(0xffffffffu, row, src);
  const double2 iv = shfl(ivl, src);
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = r * kWarp + lane;
    const bool live = !((dead >> i) & 1) && i != p1;
    lnext[r * kWarp + lane] = live ? cmul(col[r], iv) : make_double2(0.0, 0.0);
  }
  if (lane == 0) {
    *pnext = p1;
    *inv_next = iv;
  }
  __syncwarp();  // lane 0's pivot row, read by the whole warp at its next step
#pragma unroll
  for (int v = 1; v < PC; ++v) step_arrive(step_barrier(q, (q + v) % PC, PC));
}

// a[.][c] -= l U[k][j] for this warp's columns j = c * PC + w of slots
// c0 <= c < c1, U's row read at Urow[j].  Rows of U are padded to PC * CS
// columns, so the padding columns read their zeros; a column below the
// step's first one is dead (pivoted) and reads whatever lies before the row:
// the loop has no branch and no predicate.
template <int RS, int PC, int CS>
__device__ __forceinline__ void rank1(double2 (&a)[RS][CS], const double2 (&l)[RS],
                                      const double2* Urow, int w, int c0, int c1) {
#pragma unroll
  for (int c = c0; c < c1; ++c) {
    const double2 u = Urow[c * PC + w];
#pragma unroll
    for (int r = 0; r < RS; ++r) a[r][c] = cmsub(a[r][c], l[r], u);
  }
}

// the lane holding row p writes its columns j >= k1 (slot cl: j >= k1 only
// from warp q on; the padding columns too) into U's row (Urow[j]); its row
// slot is matched by a recursion over R, so every register index is static
template <int R, int RS, int PC, int CS>
__device__ __forceinline__ void store_row(const double2 (&a)[RS][CS], double2* Urow, int rp,
                                          int w, int q, int cl) {
  if (rp == R) {
    if (w >= q) Urow[cl * PC + w] = a[R][cl];
#pragma unroll
    for (int c = cl + 1; c < CS; ++c) Urow[c * PC + w] = a[R][c];
  }
  if constexpr (R + 1 < RS) store_row<R + 1, RS, PC, CS>(a, Urow, rp, w, q, cl);
}

template <int RS, int PC, int CS>
__device__ __forceinline__ void write_urow(const double2 (&a)[RS][CS], double2* Urow, int p,
                                           int w, int q, int cl, int lane) {
  if (lane == (p & (kWarp - 1))) store_row<0, RS, PC, CS>(a, Urow, p / kWarp, w, q, cl);
}

// R and P of system sys into the staging area as float2, cp.async (8 bytes a
// copy, completion awaited with the next wait)
__device__ __forceinline__ void stage_async(const float2* R, const float2* P, float2* st, int sys,
                                            int n, int tid, int nthreads) {
  const float2* Rs = R + (size_t)sys * n * n;
  for (int i = tid; i < n * n; i += nthreads) __pipeline_memcpy_async(st + i, Rs + i, 8);
  const float2* Ps = P + (size_t)sys * n;
  for (int i = tid; i < n; i += nthreads) __pipeline_memcpy_async(st + n * n + i, Ps + i, 8);
  __pipeline_commit();
}

template <int RS, int PC, int CS, int MINB>
__global__ void __launch_bounds__(kWarp * PC, MINB)
wpe_solve_kernel(const float2* __restrict__ R, const float2* __restrict__ P,
                 float2* __restrict__ G, int batch, int n, double diag_rel, double eps) {
  constexpr int M = PC * CS - 1;  // U's rows hold columns k+1 .. M
  constexpr int kT = kWarp * PC;
  extern __shared__ __align__(16) double2 smem[];
  double2* U = smem + PC;         // after a guard that dead columns of row 0 may read
  double2* inv = U + urow(n, M);
  double2* lbuf = inv + n;
  float2* st = reinterpret_cast<float2*>(lbuf + kRing * RS * kWarp);
  int* piv = reinterpret_cast<int*>(st + n * (n + 1));
  const int lane = threadIdx.x & (kWarp - 1), w = threadIdx.x / kWarp;

  stage_async(R, P, st, blockIdx.x, n, threadIdx.x, kT);
  for (int sys = blockIdx.x; sys < batch; sys += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();
    // Re trace(R): four partial sums over i mod 4, added in a fixed order
    double tr0 = 0.0, tr1 = 0.0, tr2 = 0.0, tr3 = 0.0;
    for (int i = 0; i < n; i += 4) {
      tr0 += (double)st[i * n + i].x;
      if (i + 1 < n) tr1 += (double)st[(i + 1) * n + i + 1].x;
      if (i + 2 < n) tr2 += (double)st[(i + 2) * n + i + 2].x;
      if (i + 3 < n) tr3 += (double)st[(i + 3) * n + i + 3].x;
    }
    const double load = diag_rel * (((tr0 + tr1) + (tr2 + tr3)) / n) + eps;
    double2 a[RS][CS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int i = r * kWarp + lane;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = c * PC + w;
        float2 v = make_float2(0.f, 0.f);
        if (i < n && j < n) v = st[i * n + j];
        else if (i < n && j == n) v = st[n * n + i];
        a[r][c] = make_double2(v.x, v.y);
        if (i == j && i < n) a[r][c].x += load;
      }
    }
    uint64_t dead = n >= 64 ? 0ull : ~0ull << n;  // rows past n never pivot
    __syncthreads();  // the staging area is free: the next system's copy runs under this one
    if (sys + gridDim.x < batch) stage_async(R, P, st, sys + gridDim.x, n, threadIdx.x, kT);

#pragma unroll
    for (int cl = 0; cl < CS; ++cl) {
#pragma unroll 1
      for (int q = 0; q < PC; ++q) {
        // warp w's step k1: it applies elimination step k = k1 - 1 to its
        // columns; the owner of column k1 (w == q) first brings that column up
        // to date, pivots it and publishes step k1
        const int k1 = cl * PC + q, k = k1 - 1;
        if (k1 > n) break;
        if (k < 0) {
          if (w == 0) {
            double2 col[RS];
#pragma unroll
            for (int r = 0; r < RS; ++r) col[r] = a[r][0];
            look_ahead<RS, PC>(col, dead, lane, lbuf, piv, inv, 0);
          }
          continue;
        }
        if (PC > 1 && w != k % PC) step_wait(step_barrier(k % PC, w, PC));
        const int p = piv[k % kRing];
        dead |= 1ull << p;
        double2 l[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) l[r] = lbuf[(k % kRing) * RS * kWarp + r * kWarp + lane];
        double2* Uk = U + urow(k, M) - k1;  // U[k][j] at Uk[j]
        if (w == q && k1 < n) {
          double2 col[RS];
#pragma unroll
          for (int r = 0; r < RS; ++r) col[r] = a[r][cl];
          const double2 u = shfl(pick(col, p / kWarp), p & (kWarp - 1));  // U[k][k1]
#pragma unroll
          for (int r = 0; r < RS; ++r) col[r] = cmsub(col[r], l[r], u);
          look_ahead<RS, PC>(col, dead, lane, lbuf + (k1 % kRing) * RS * kWarp, piv + k1 % kRing,
                             inv + k1, q);
          write_urow<RS, PC, CS>(a, Uk, p, w, q, cl, lane);
          __syncwarp();
          rank1<RS, PC, CS>(a, l, Uk, w, cl + 1, CS);
        } else {
          write_urow<RS, PC, CS>(a, Uk, p, w, q, cl, lane);
          __syncwarp();
          rank1<RS, PC, CS>(a, l, Uk, w, cl, CS);
        }
      }
    }
    __syncthreads();  // U complete

    if (w == 0) {
      // back substitution by warp 0: lane l keeps the right-hand sides of U's rows
      // s = t * 32 + l; the owner of x_k forms it with the pivot's stored
      // reciprocal and broadcasts it; every row above takes its share (rows at
      // and below k take 0 by a select, so there is no branch)
      double2 x[RS], un[RS];
      int base[RS];
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        const int s = t * kWarp + lane;
        base[t] = urow(s, M) - s - 1;  // U[s][j] at U[base + j]
        x[t] = s < n ? U[base[t] + n] : make_double2(0.0, 0.0);
        un[t] = U[base[t] + n - 1];
      }
      double2 ivn = inv[n - 1];
      for (int k = n - 1; k >= 0; --k) {
        double2 u[RS];
#pragma unroll
        for (int t = 0; t < RS; ++t) {
          u[t] = un[t];
          un[t] = U[base[t] + k - 1];  // the next column's, ahead of this one's chain
        }
        const double2 iv = ivn;
        ivn = inv[k > 0 ? k - 1 : 0];
        const double2 xk = shfl(cmul(pick(x, k / kWarp), iv), k & (kWarp - 1));
#pragma unroll
        for (int t = 0; t < RS; ++t) {
          const int s = t * kWarp + lane;
          const double2 upd = cmsub(x[t], u[t], xk);
          x[t] = s < k ? upd : (s == k ? xk : x[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        const int s = t * kWarp + lane;
        if (s < n) G[(size_t)sys * n + s] = make_float2((float)x[t].x, (float)x[t].y);
      }
    }
  }
}

// ---- route 2: large n, the matrix in a device-memory workspace -------------

__host__ __device__ __forceinline__ size_t large_smem(int n) {
  return sizeof(double2) * (5 * (size_t)n + 1) + sizeof(int) * n + n +
         (sizeof(uint64_t) + sizeof(unsigned)) * (kLargeThreads / kWarp);
}

__global__ void __launch_bounds__(kLargeThreads)
wpe_solve_large_kernel(const float2* __restrict__ R, const float2* __restrict__ P,
                       float2* __restrict__ G, int batch, int n, double diag_rel, double eps,
                       double2* __restrict__ work) {
  extern __shared__ __align__(16) double2 smem[];
  double2* lcol = smem;          // n multipliers
  double2* prow = lcol + n;      // the pivot row, columns 0 .. n
  double2* inv = prow + n + 1;   // n pivot reciprocals
  double2* rhs = inv + n;        // U's last column in step order
  double2* xs = rhs + n;         // the solution
  uint64_t* wkey = reinterpret_cast<uint64_t*>(xs + n);
  unsigned* wrow = reinterpret_cast<unsigned*>(wkey + kLargeThreads / kWarp);
  int* perm = reinterpret_cast<int*>(wrow + kLargeThreads / kWarp);
  unsigned char* dead = reinterpret_cast<unsigned char*>(perm + n);
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), w = tid / kWarp;
  constexpr int kWarps = kLargeThreads / kWarp;
  const int ld = n + 1;
  double2* a = work + (size_t)blockIdx.x * n * ld;

  for (int sys = blockIdx.x; sys < batch; sys += gridDim.x) {
    const float2* Rs = R + (size_t)sys * n * n;
    for (int i = w; i < n; i += kWarps) {
      for (int j = lane; j < n; j += kWarp) {
        const float2 v = Rs[(size_t)i * n + j];
        a[(size_t)i * ld + j] = make_double2(v.x, v.y);
      }
      if (lane == 0) {
        const float2 v = P[(size_t)sys * n + i];
        a[(size_t)i * ld + n] = make_double2(v.x, v.y);
      }
    }
    for (int i = tid; i < n; i += kLargeThreads) dead[i] = 0;
    __syncthreads();
    double tr[4] = {0.0, 0.0, 0.0, 0.0};  // as the register route: four partial sums
    for (int i = 0; i < n; ++i) tr[i & 3] += a[(size_t)i * ld + i].x;
    const double load = diag_rel * (((tr[0] + tr[1]) + (tr[2] + tr[3])) / n) + eps;
    __syncthreads();
    for (int i = tid; i < n; i += kLargeThreads) a[(size_t)i * ld + i].x += load;
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      uint64_t key = 0;
      unsigned row = 0;
      for (int i = tid; i < n; i += kLargeThreads) {
        const uint64_t kk = dead[i] ? 0ull : pivot_key(a[(size_t)i * ld + k]);
        if (kk > key) { key = kk; row = i; }
      }
      uint64_t best;
      unsigned brow;
      warp_pivot(key, row, &best, &brow);
      if (lane == 0) { wkey[w] = best; wrow[w] = brow; }
      __syncthreads();
      best = 0;
      unsigned p = 0xffffffffu;
      for (int v = 0; v < kWarps; ++v)
        if (wkey[v] > best || (wkey[v] == best && wrow[v] < p)) { best = wkey[v]; p = wrow[v]; }
      const double2* ap = a + (size_t)p * ld;
      const double2 iv = crcp(ap[k]);
      for (int j = k + 1 + tid; j <= n; j += kLargeThreads) prow[j] = ap[j];
      for (int i = tid; i < n; i += kLargeThreads) {
        const bool live = !dead[i] && i != (int)p;
        lcol[i] = live ? cmul(a[(size_t)i * ld + k], iv) : make_double2(0.0, 0.0);
        if (i == (int)p) dead[i] = 1;
      }
      if (tid == 0) { inv[k] = iv; perm[k] = (int)p; }
      __syncthreads();
      for (int i = w; i < n; i += kWarps) {
        if (dead[i]) continue;
        const double2 li = lcol[i];
        double2* ai = a + (size_t)i * ld;
        for (int j = k + 1 + lane; j <= n; j += kWarp) ai[j] = cmsub(ai[j], li, prow[j]);
      }
      __syncthreads();
    }

    for (int s = tid; s < n; s += kLargeThreads) rhs[s] = a[(size_t)perm[s] * ld + n];
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {  // every thread forms x_k (the same bits)
      const double2 xk = cmul(rhs[k], inv[k]);
      if (tid == k % kLargeThreads) xs[k] = xk;
      for (int s = tid; s < k; s += kLargeThreads)
        rhs[s] = cmsub(rhs[s], a[(size_t)perm[s] * ld + k], xk);
      __syncthreads();
    }
    for (int s = tid; s < n; s += kLargeThreads)
      G[(size_t)sys * n + s] = make_float2((float)xs[s].x, (float)xs[s].y);
    __syncthreads();
  }
}

template <int RS, int PC, int CS, int MINB>
int launch_inst(int grid, size_t smem, cudaStream_t stream, const float2* R, const float2* P,
                float2* G, int batch, int n, double diag_rel, double eps) {
  const void* kernel = (const void*)wpe_solve_kernel<RS, PC, CS, MINB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (attr != cudaSuccess) return (int)attr;
  wpe_solve_kernel<RS, PC, CS, MINB><<<grid, kWarp * PC, smem, stream>>>(R, P, G, batch, n,
                                                                         diag_rel, eps);
  return (int)cudaGetLastError();
}

int launch_reg(int inst, int grid, size_t smem, cudaStream_t stream, const float2* R,
               const float2* P, float2* G, int batch, int n, double diag_rel, double eps) {
  switch (inst) {
    case 0: return launch_inst<1, 1, 17, 16>(grid, smem, stream, R, P, G, batch, n, diag_rel, eps);
    case 1: return launch_inst<1, 2, 17, 8>(grid, smem, stream, R, P, G, batch, n, diag_rel, eps);
    case 2: return launch_inst<2, 4, 13, 3>(grid, smem, stream, R, P, G, batch, n, diag_rel, eps);
    default: return launch_inst<2, 4, 17, 2>(grid, smem, stream, R, P, G, batch, n, diag_rel, eps);
  }
}

// the register instances: the largest n each holds (n + 1 <= PC * CS, n <= 32 RS), RS
const int kRegMaxN[4] = {16, 32, 51, 64};
const int kRegRS[4] = {1, 1, 2, 2}, kRegPC[4] = {1, 2, 4, 4}, kRegCS[4] = {17, 17, 13, 17};

}  // namespace

// route: 0-3 a register instance, 4 the large route (work: grid x n (n+1)
// double2).  smem: the plan's dynamic shared memory, checked against this
// file's.  Returns a cudaError_t.
extern "C" int wpe_solve(const float* R, const float* P, float* G, int batch, int n,
                         double diag_rel, double eps, int route, long long smem, void* work,
                         int grid, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || route < 0 || route > 4) return (int)cudaErrorInvalidValue;
  const float2* R2 = reinterpret_cast<const float2*>(R);
  const float2* P2 = reinterpret_cast<const float2*>(P);
  float2* G2 = reinterpret_cast<float2*>(G);
  if (route < 4) {
    if (n > kRegMaxN[route] || (route > 0 && n <= kRegMaxN[route - 1]) ||
        (size_t)smem != reg_smem(n, kRegRS[route], kRegPC[route], kRegCS[route]))
      return (int)cudaErrorInvalidValue;
    if (grid <= 0) return (int)cudaErrorInvalidValue;
    return launch_reg(route, grid, (size_t)smem, stream, R2, P2, G2, batch, n, diag_rel, eps);
  }
  if (n <= kRegMaxN[3] || n > kMaxN || work == nullptr || grid <= 0 ||
      (size_t)smem != large_smem(n))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      (const void*)wpe_solve_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)large_smem(kMaxN));
  if (attr != cudaSuccess) return (int)attr;
  wpe_solve_large_kernel<<<grid, kLargeThreads, (size_t)smem, stream>>>(
      R2, P2, G2, batch, n, diag_rel, eps, reinterpret_cast<double2*>(work));
  return (int)cudaGetLastError();
}
