#!/usr/bin/env python3
"""Two builds of kernel K11 (FIR resampling, ``csrc/upfirdn.cu``) on one card,
in turns.

    python3 k11_compare.py A.cu B.cu [rounds]      # needs one CUDA card

Builds each source with the port's nvcc flags (``ops/_build.py``), then runs
``rounds`` (default 2) of A, B, B, A: at the top up- and down-block shapes of
``chip_smoke.py``'s phase 9 run (a) (float32, channels_last, the shipped
[1, 3, 3, 1] kernel), the forward and the input vjp, each timed as device us
a launch after an L2 flush (the profiler, 20 calls, one K11 launch a call
and no other kernel), and the outputs of every turn bit for bit with the
first turn's.  Prints the card's name and power limit, one JSON line a turn
and a SUMMARY line (each build's median a launch and its byte bound); the
whole goes to chiprun_out/k11_compare.json.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import chip_smoke as cs


def build(src: str, out_dir: str) -> ctypes.CDLL:
    from buddy_tpu_torch.ops import _build, resample as R
    lib = os.path.join(out_dir, os.path.basename(os.path.dirname(os.path.abspath(src))) + "_"
                       + os.path.basename(src) + ".so")
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{run.stdout}{run.stderr}")
    so = ctypes.CDLL(lib)
    so.upfirdn.argtypes = R._SIGNATURES["upfirdn"]
    so.upfirdn.restype = ctypes.c_int
    return so


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k11_compare: no CUDA device is available", file=sys.stderr)
        return 2
    from buddy_tpu_torch.ops import _build, resample as R
    srcs = argv[:2]
    rounds = int(argv[2]) if len(argv) > 2 else 2
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="k11_compare_")
    libs = [build(s, tmp) for s in srcs]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    cases = {}
    for what, shape, gain, args in (("up", cs.FIR_TOP["up"], 4.0, dict(up=2, pad=(2, 1))),
                                    ("down", cs.FIR_TOP["down"], 1.0, dict(down=2, pad=(1, 1)))):
        kern = R.fir_kernel((1, 3, 3, 1), gain)
        x = cl(torch.randn(shape, generator=gen).to(dev))
        ay = R.make_axis(shape[2], 4, args.get("up", 1), args.get("down", 1), args["pad"])
        ax = R.make_axis(shape[3], 4, args.get("up", 1), args.get("down", 1), args["pad"])
        g = cl(torch.randn((shape[0], shape[1], ay.out, ax.out), generator=gen).to(dev))
        n_bytes = 4 * (x.numel() + g.numel())
        cases[f"{what} fwd"] = (lambda x=x, k=kern, a=args: R.upfirdn2d(x, k, **a), n_bytes)
        cases[f"{what} vjp"] = (lambda g=g, k=kern, ay=ay, ax=ax: R.upfirdn2d_backward(g, k, ay, ax),
                                n_bytes)
    turns, first = [], {}
    for i in [0, 1, 1, 0] * rounds:
        _build._libs["upfirdn"] = libs[i]
        res = {"build": srcs[i]}
        with torch.no_grad():
            for name, (call, _) in cases.items():
                out = call()
                if name in first and not torch.equal(out, first[name]):
                    raise AssertionError(f"{name}: {srcs[i]} differs from the first turn's output")
                first.setdefault(name, out)
                res[name] = cs.one_launch(call, cs.K11_KERNEL, f"{srcs[i]} {name}")
        print(json.dumps(res), flush=True)
        turns.append(res)
    summary = {"card": smi.stdout.strip(), "bound_us": {
        name: round(n / cs.PEAK_BYTES_PER_S * 1e6, 2) for name, (_, n) in cases.items()}}
    for i, src in enumerate(srcs):
        summary[src] = {name: round(float(np.median([t[name] for t in turns
                                                      if t["build"] == src])), 2)
                        for name in cases}
    print("SUMMARY " + json.dumps(summary), flush=True)
    with open(os.path.join(cs.OUT_DIR, "k11_compare.json"), "w") as f:
        json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
