#!/usr/bin/env python3
"""Where K10's Hopper convolution spends its time on one CUDA card (kernel
``qc_conv_sm90_kernel``, ``buddy_tpu_torch/csrc/qconv_sm90.cu``).

    python3 k10_profile.py

At three main-path shapes of the int8 U-Net (B=8, bf16 output with bias:
the top 3x3 128 -> 128 at 256x528, a 3x3 256 -> 256 at 128x264, the 1x1
384 -> 128 at 256x528), built into buddy_tpu_torch/_build/ (which
.gitignore lists) from the kernel's source: the knock-outs as copies cut at
one line each, the probes by defining the source's ``QC_PROBE`` markers in a
header included at the build (``PROBES``):

1. knock-outs: the device us of a launch (CUDA events, the median of 10,
   each after an L2 flush) of the kernel as it is, and of copies that load
   each weight slice only for the first four k-blocks (the rest reuse the
   slots: wrong sums, no weight traffic), that issue no wgmma, and that
   write no output; each copy's sums are not checked, only timed;
2. a timeline of every CTA of output-channel tile 0 (%globaltimer at entry,
   when its first box has arrived and its A fragments are loaded, at the end
   of its main loop, after the epilogue's staging and after its stores, and
   its SM): the medians of each span, the CTAs alive on average and the
   SMs' busy share;
3. the main loop of every such CTA split, for thread 0 (warpgroup 0, which
   issues the loads) and thread 128 (warpgroup 1), into clock64() cycles
   spent waiting for a box, loading A with ldmatrix, waiting for a weight
   slice, issuing the wgmmas, in wgmma.wait_group and in the release (the
   slot arrivals, and for thread 0 the issue of later loads): medians over
   the CTAs.

The probes cost a few percent.  Needs one CUDA card and nvcc; prints the
card (nvidia-smi name and power limit) first.  Nothing here is used by the
port.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPES = [("3x3", 128, 128, 256, 528), ("3x3", 256, 256, 128, 264), ("1x1", 384, 128, 256, 528)]
MAX_CTAS = 70000


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"k10_profile: the source no longer holds {old.strip()!r} once")
    return src.replace(old, new)


def knockouts(src: str) -> dict:
    """The kernel as it is and three copies with a part taken out, each cut
    in at one line of the source."""
    load_b = "    mbar_expect_tx(full_b(bs), kBBytes);\n"
    mma = "    for (int ks = 0; ks < 4; ++ks) wgmma_s8_m64n128k32(acc, a[ks], desc + 2 * ks);\n"
    epi = "  // epilogue: every warp past its last tap"
    return {
        "kernel": src,
        "no weight reloads": sub(src, load_b, "    if (q >= kBStages) {\n"
                                              "      mbar_arrive(full_b(bs));\n      return;\n"
                                              "    }\n" + load_b),
        "no wgmma": sub(src, mma, "    for (int ks = 0; ks < 4; ++ks) acc[ks] += a[ks][0] ^ "
                                  "(int)desc;\n"),
        "no epilogue": sub(src, epi, "  int sum = 0;\n#pragma unroll\n  for (int i = 0; i < 64; "
                                     "++i) sum += acc[i];\n  if (sum == 0x7fffffff) "
                                     "reinterpret_cast<int*>(p.y)[tid] = sum;\n  return;\n" + epi),
    }


# The kernel's QC_PROBE markers: clock64() cycles a thread spends in each
# main-loop span (the time since the previous marker: 0 box wait, 1
# ldmatrix, 2 weight wait, 3 wgmma issue, 4 wgmma wait, 5 release, 6 the
# rest), %globaltimer at entry, at the first A, after the main loop and
# after the staging; threads 0 and 128 of the CTAs of output-channel tile 0
# and phase 0 copy them to g_prof at the end.  The wait after the main loop
# counts with the wgmma waits.
PROBES = """
#include <cuda_runtime.h>
__device__ long long g_prof[18 * %(n)d];
#define QC_PROBE(point) QC_PROBE_##point
#define QC_TICK(i) do { const long long n_ = clock64(); qc_cyc[i] += n_ - qc_last; \\
                        qc_last = n_; } while (0)
#define QC_NOW() ((long long)globaltimer_ns())
#define QC_PROBE_entry long long qc_cyc[7] = {0, 0, 0, 0, 0, 0, 0}, qc_last = clock64(), \\
                       qc_ts[4]; qc_ts[0] = QC_NOW()
#define QC_PROBE_load QC_TICK(6)
#define QC_PROBE_box QC_TICK(0)
#define QC_PROBE_lda asm volatile("" ::"r"(a[3][3]) : "memory"); QC_TICK(1)
#define QC_PROBE_slice QC_TICK(2)
#define QC_PROBE_issue QC_TICK(3)
#define QC_PROBE_wait QC_TICK(4)
#define QC_PROBE_release QC_TICK(5)
#define QC_PROBE_first qc_ts[1] = QC_NOW()
#define QC_PROBE_main QC_TICK(4); qc_ts[2] = QC_NOW()
#define QC_PROBE_staged qc_ts[3] = QC_NOW()
#define QC_PROBE_end \\
  const bool qc_mine = blockIdx.x < %(n)d && blockIdx.y == 0 && blockIdx.z == 0; \\
  if (qc_mine && (tid == 0 || tid == 128)) \\
    for (int i_ = 0; i_ < 6; ++i_) g_prof[18 * blockIdx.x + (tid == 0 ? 0 : 6) + i_] = qc_cyc[i_]; \\
  __syncthreads(); \\
  if (qc_mine && tid == 0) { \\
    unsigned smid_; \\
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(smid_)); \\
    long long* d_ = g_prof + 18 * blockIdx.x + 12; \\
    d_[0] = qc_ts[0]; d_[1] = qc_ts[1] - qc_ts[0]; d_[2] = qc_ts[2] - qc_ts[1]; \\
    d_[3] = qc_ts[3] - qc_ts[2]; d_[4] = (QC_NOW() - qc_ts[2]) | ((long long)smid_ << 48); \\
  }
extern "C" int qc_profile_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, (size_t)n * 18 * 8);
}
""" % {"n": MAX_CTAS}


def build(name: str, src: str, header: str | None = None) -> ctypes.CDLL:
    """``src`` compiled as the port's build does, with ``header`` (the
    probes) included first."""
    from buddy_tpu_torch.ops import _build, qconv as Q
    path = os.path.join(_build.BUILD_DIR, f"k10_profile_{name.replace(' ', '_')}.cu")
    with open(path, "w") as f:
        f.write(src)
    flags = list(_build.NVCC_FLAGS)
    if header is not None:
        with open(path[:-3] + ".h", "w") as f:
            f.write(header)
        flags += ["-include", path[:-3] + ".h"]
    out = subprocess.run([_build._nvcc(), *flags, "-o", path[:-3] + ".so", path],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(path[:-3] + ".so")
    lib.qc_conv_sm90.argtypes = Q._SM90_SIGNATURES["qc_conv_sm90"]
    lib.qc_conv_sm90.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k10_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from buddy_tpu_torch.ops import _build, qconv as Q
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(_build.source_path("qconv_sm90")) as f:
        src = f.read()
    libs = {name: build(name, s) for name, s in knockouts(src).items()}
    prof = build("probed", src, PROBES)
    prof.qc_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    prof.qc_profile_read.restype = ctypes.c_int
    sm90_lib = Q._sm90_lib
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    flush = torch.zeros(2 * torch.cuda.get_device_properties(0).L2_cache_size, dtype=torch.uint8,
                        device=dev)

    def timed(fn, reps=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush.bitwise_not_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) * 1e3)
        return round(sorted(times)[len(times) // 2], 1)

    for kind, cin, cout, h, w in SHAPES:
        k = 3 if kind.endswith("3x3") else 1
        x = torch.randn((8, cin, h, w), generator=gen).to(dev, torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wt = (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        out = {"shape": [kind, cin, cout, h, w], "device_us": {}}
        with torch.no_grad():
            xq, sx = Q.quantize_act(x)
            wq, sw = Q.quantize_weight(Q._derived(wt, kind).contiguous())
            call = lambda: Q.int8_conv(xq, wq, sw, kind, out_dtype=torch.bfloat16, s_x=sx,
                                       bias=b, route="sm90")
            try:
                for name, lib in list(libs.items()) + [("probed", prof)]:
                    Q._sm90_lib = lambda lib=lib: lib
                    out["device_us"][name] = timed(call)
            finally:
                Q._sm90_lib = sm90_lib
        n = 8 * ((h + 7) // 8) * ((w + 15) // 16)
        buf = np.zeros(18 * n, dtype=np.int64)
        if prof.qc_profile_read(buf.ctypes.data, n) != 0:
            raise RuntimeError("k10_profile: reading the probes failed")
        d = buf.reshape(n, 18)
        med = lambda v: int(np.median(v))
        parts = ("box wait", "ldmatrix", "weight wait", "wgmma issue", "wgmma wait", "release")
        out["main_loop_cycles"] = {
            who: {p: med(d[:, off + i]) for i, p in enumerate(parts)}
            for who, off in (("thread 0 (warpgroup 0, issues the loads)", 0),
                             ("thread 128 (warpgroup 1)", 6))}
        entry, first, main, staged = d[:, 12], d[:, 13], d[:, 14], d[:, 15]
        rest, sm = d[:, 16] & ((1 << 48) - 1), d[:, 16] >> 48
        life = first + main + rest
        span = (entry + life).max() - entry.min()
        busy = 0
        for s_ in np.unique(sm):
            ivs = sorted(zip(entry[sm == s_], entry[sm == s_] + life[sm == s_]))
            lo, hi = ivs[0]
            for a, e in ivs[1:]:
                if a > hi:
                    busy, lo, hi = busy + hi - lo, a, e
                else:
                    hi = max(hi, e)
            busy += hi - lo
        out["cta_timeline_ns"] = {"first box and A": med(first), "main loop": med(main),
                                  "epilogue staging": med(staged),
                                  "epilogue stores": med(rest - staged), "lifetime": med(life),
                                  "CTAs": int(n), "SMs": int(len(np.unique(sm))),
                                  "CTAs alive on average": round(float(life.sum() / span), 1),
                                  "SM busy share": round(float(busy / len(np.unique(sm)) / span),
                                                         3)}
        print(json.dumps(out), flush=True)
        del x, xq, wq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
