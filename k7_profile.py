#!/usr/bin/env python3
"""Where K7's time goes on one CUDA card (kernel ``csrc/wpe_solve.cu``).

    python3 k7_profile.py

1. Latencies of the operations K7's pivot chain is made of, in cycles, from
   a dependent chain of 1000 of each (one warp alone, and 396 CTAs of 128
   threads at once, three an SM as K7's register route runs): DFMA,
   DMUL + DADD, a float64 shuffle, redux.sync, a ballot, rcp.approx.f64, an
   IEEE float64 division, a shared-memory load, a barrier of four warps, a
   store + __syncwarp + load.
2. The register route at the main path's shape (the WPE systems of the 8
   in-repo degraded utterances, 2056 systems of 50 unknowns), built from a
   copy of the source with clock64() probes added by a text pass (the
   probed copy goes to buddy_tpu_torch/_build/, which .gitignore lists):
   for the first system of CTA 0, the median over steps of the cycles from
   one step's hand-off to the next (the publication interval), split into
   the hand-off (published -> seen by the next owner) and the owner's chain
   (seen -> published), and the cycles of the load, the elimination and the
   back substitution; with all 2056 systems (the grid of 3 CTAs an SM) and
   with one system alone.  The probes cost a few percent of the kernel's time.

Needs one CUDA card and nvcc; prints the card (nvidia-smi name and power
limit) first.  Nothing here is used by the port.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

LATENCY_SRC = r'''
#include <cuda_runtime.h>
__device__ long long g_lat[16];
__global__ void lat_kernel(double seed, int iters) {
  __shared__ double sm[256];
  __shared__ int si[64];
  const int lane = threadIdx.x & 31;
  double x = seed + lane, y = seed * 0.5;
  unsigned u = lane + (unsigned)seed;
  sm[threadIdx.x] = x;
  si[threadIdx.x & 63] = lane;
  __syncthreads();
  long long t0, t1;
#define TIME(slot, body) \
  t0 = clock64(); for (int i = 0; i < iters; ++i) { body; } t1 = clock64(); \
  if (threadIdx.x == 0 && blockIdx.x == 0) g_lat[slot] = t1 - t0;
  TIME(0, x = fma(x, y, 1.0))
  TIME(1, x = __dadd_rn(__dmul_rn(x, y), 1.0))
  TIME(2, x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31) + 1e-300)
  TIME(3, u = __reduce_max_sync(0xffffffffu, u + lane) - 31)
  TIME(4, u = __ballot_sync(0xffffffffu, (u >> (lane & 7)) & 1) + lane)
  TIME(5, double r; asm volatile("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x)); x = r + 1.0)
  TIME(6, x = 1.0 / x + 1.0)
  int idx = lane;
  TIME(7, idx = si[(idx + 1) & 63])
  TIME(8, __syncthreads())
  TIME(9, sm[threadIdx.x] = x; __syncwarp(); x = sm[threadIdx.x ^ 1] + 1.0)
  if (x == 12345.0 || u == 777u || idx == 999) g_lat[15] = 1;
}
extern "C" int lat_run(long long* out, int threads, int blocks) {
  lat_kernel<<<blocks, threads>>>(1.0000001, 1000);
  cudaError_t e = cudaDeviceSynchronize();
  if (e) return (int)e;
  return (int)cudaMemcpyFromSymbol(out, g_lat, sizeof(long long) * 16);
}
'''
LATENCY_OPS = ["DFMA", "DMUL+DADD", "SHFL f64", "REDUX", "BALLOT", "RCP.approx f64",
               "1.0/x f64", "LDS", "BAR 4 warps", "STS+syncwarp+LDS"]

PROBES = '''
__device__ long long g_probe[4][80][8];
__device__ long long g_bs[4];
#define PROBE(pt) do { if (blockIdx.x == 0 && sys == 0 && lane == 0 && k1 < 80) \\
  g_probe[w][k1][pt] = clock64(); } while (0)
#define BPROBE(pt) do { if (blockIdx.x == 0 && sys == 0 && threadIdx.x == 0) \\
  g_bs[pt] = clock64(); } while (0)
'''
# (anchor in csrc/wpe_solve.cu, text put after it)
PROBE_POINTS = [
    ("        if (k1 > n) break;\n", "        PROBE(0);\n"),                  # step start
    ("        const int p = piv[k % kRing];\n", "        PROBE(1);\n"),         # step seen
    ("                             inv + k1, q);\n", "          PROBE(5);\n"),  # step published
    ("    __pipeline_wait_prior(0);\n", "    BPROBE(2);\n"),                   # load start
    ("    __syncthreads();  // U complete\n", "    BPROBE(0);\n"),             # elimination end
]
PROBE_BEFORE = [
    ("    __syncthreads();  // the staging area is free", "    BPROBE(3);\n"),  # load end
    ("#pragma unroll\n      for (int t = 0; t < RS; ++t) {\n        const int s = t * kWarp + lane;"
     "\n        if (s < n) G[", "      BPROBE(1);\n"),                           # back subst. end
]


def probed_source() -> str:
    from buddy_tpu_torch.ops import _build
    src = open(_build.source_path("wpe_solve")).read()
    anchor = "template <int RS, int PC, int CS, int MINB>\n__global__"
    if src.count(anchor) != 1:
        raise AssertionError("csrc/wpe_solve.cu: the kernel template is not where expected")
    src = src.replace(anchor, PROBES + anchor)
    for at, text in PROBE_POINTS:
        if src.count(at) != 1:
            raise AssertionError(f"csrc/wpe_solve.cu: probe anchor not found once: {at!r}")
        src = src.replace(at, at + text)
    for at, text in PROBE_BEFORE:
        if src.count(at) != 1:
            raise AssertionError(f"csrc/wpe_solve.cu: probe anchor not found once: {at!r}")
        src = src.replace(at, text + at)
    return src + '''
extern "C" int probe_read(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  if (e) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + 4 * 80 * 8, g_bs, sizeof(g_bs));
}
'''


def build(name: str, src: str) -> ctypes.CDLL:
    from buddy_tpu_torch.ops import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, name + ".cu")
    so = os.path.join(_build.BUILD_DIR, "lib" + name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    # the probed copy includes csrc/'s headers as the source does
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k7_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import buddy_tpu_torch.sampling.wpe as wpe
    from buddy_tpu_torch.ops import wpe_solve as K7
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    lat = build("k7_latency", LATENCY_SRC)
    for threads, blocks in ((32, 1), (128, 396)):
        buf = np.zeros(16, np.int64)
        if lat.lat_run(ctypes.c_void_p(buf.ctypes.data), threads, blocks) != 0:
            raise AssertionError("latency kernel failed")
        print(f"latency, cycles an operation ({blocks} CTA(s) of {threads} threads): "
              + json.dumps({op: round(buf[i] / 1000, 1) for i, op in enumerate(LATENCY_OPS)}),
              flush=True)

    dev = torch.device("cuda")
    ys = torch.from_numpy(cs.load_wavs("degraded", 8, 65536)).to(dev)[:, 0]
    Y = STFT(512, 128, hann_window(512), pad_mode="constant", device=dev).stft(ys)
    taps = 50
    Yt = wpe._build_y_tilde(Y, taps, 2)
    Yn = Yt / torch.clamp(torch.abs(Y) ** 2, min=1e-10)[..., None, :]
    R = (Yn @ Yt.conj().transpose(-1, -2)).contiguous()
    P = (Yn @ Y.conj()[..., None])[..., 0].contiguous()
    nsys = P.numel() // taps
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build("k7_probed", probed_source())
    lib.wpe_solve.argtypes = K7._SIGNATURES["wpe_solve"]
    reference = K7.wpe_solve(R, P)
    pc = K7.REG_INSTANCES[K7.solve_route(taps).index][2]
    for batch in (nsys, 1):
        plan = K7.solve_route(taps, batch, sms)
        G = torch.empty_like(torch.view_as_real(P))
        for _ in range(2):
            err = lib.wpe_solve(R.data_ptr(), P.data_ptr(), G.data_ptr(), batch, taps, 1e-6, 1e-10,
                                plan.index, plan.smem_bytes, None, plan.grid,
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise AssertionError(f"probed wpe_solve: CUDA error {err}")
            torch.cuda.synchronize()
        got = torch.view_as_complex(G).reshape(-1, taps)[:batch]
        if not torch.equal(got, reference.reshape(-1, taps)[:batch]):
            raise AssertionError("the probed kernel's G differs from the kernel's")
        buf = np.zeros(4 * 80 * 8 + 4, np.int64)
        if lib.probe_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
            raise AssertionError("probe read failed")
        bs, pr = buf[-4:], buf[:-4].reshape(4, 80, 8)
        rows = []
        for k1 in range(2, taps):
            q, published_before = k1 % pc, pr[(k1 - 1) % pc, k1 - 1, 5]
            rows.append([pr[q, k1, 1] - published_before, pr[q, k1, 5] - pr[q, k1, 1],
                         pr[q, k1, 5] - published_before])
        med = np.median(np.array(rows), 0).astype(int).tolist()
        print(f"register route, {batch} system(s) (grid {plan.grid}), CTA 0's first system, "
              f"cycles: step hand-off {med[0]}, owner's chain {med[1]}, publication interval "
              f"{med[2]} (medians over steps 2-{taps - 1}); load {int(bs[3] - bs[2])}, "
              f"elimination {int(bs[0] - bs[3])}, back substitution {int(bs[1] - bs[0])}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
