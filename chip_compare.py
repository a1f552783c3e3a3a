#!/usr/bin/env python3
"""Two checkouts of the port on one CUDA card, in turns: the main path's
wall and device time a step, K6's and K7's device time and K6's wrapper
host time, and the shipped geometries' output digests.

    python3 chip_compare.py PARENT CHANGE [PAIRS]

PARENT and CHANGE are directories that each hold a checkout of this repo
(``buddy_tpu_torch/`` at their root).  Each measurement runs in a process of
its own, in the order parent, change, change, parent, repeated PAIRS times
(default 2); each process builds its tree's kernels into that tree's
``buddy_tpu_torch/_build/``.  The helpers (timing, L2 flush, the main path's
tester, the digests) are this checkout's ``chip_smoke.py``; only
``buddy_tpu_torch`` comes from the tree under test.  One JSON line a run,
then a summary line; everything also goes to chiprun_out/compare.json, and
each run's Python profile of one ``do_test()`` to
chiprun_out/compare_python_<run>.txt.
"""

import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_times(dev) -> dict:
    """K6 (forward, backward) and K7 at the main path's shapes: device us a
    call (profiler, summed over the kernels a call launches), cold after an
    L2 flush and warm; and K6's wrappers' host us a call (200 calls back to
    back with no synchronisation inside: the device runs behind, so this is
    the host's dispatch), the forward with inputs that require grad, as in
    the operator's inner loop; the same host time for K2's analysis and
    synthesis at the operator's geometry and K5's forward at Nf = 100."""
    import torch
    import chip_smoke as cs
    import buddy_tpu_torch.sampling.wpe as wpe
    from buddy_tpu_torch.config import compose
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    import numpy as np
    from buddy_tpu_torch.ops import filter_design as K6, minphase as K5
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.ops import wpe_solve as K7
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    args = compose("conf_VCTK.yaml", ["tester=blind_dereverberation_BUDDy"])
    op = BlindSubbandFiltering(args["tester"]["informed_dereverberation"]["op_hp"],
                               sample_rate=16000, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    params, _ = op.reset_batched(8, generator=torch.Generator(device=dev).manual_seed(2))
    decay, weights, phases = params["decay"], params["weights"], params["phases"]
    gH = torch.complex(torch.randn(phases.shape, generator=g, device=dev),
                       torch.randn(phases.shape, generator=g, device=dev))
    geom = op._design_geometry
    ys = torch.from_numpy(cs.load_wavs("degraded", 8, 65536)).to(dev)[:, 0]
    Y = STFT(512, 128, hann_window(512), pad_mode="constant", device=dev).stft(ys)
    Yt = wpe._build_y_tilde(Y, 50, 2)
    Yn = Yt / torch.clamp(torch.abs(Y) ** 2, min=1e-10)[..., None, :]
    R = (Yn @ Yt.conj().transpose(-1, -2)).contiguous()
    P = (Yn @ Y.conj()[..., None])[..., 0].contiguous()
    calls = {"filter_design_fwd": lambda: K6.filter_design(decay, weights, phases, geom),
             "filter_design_bwd": lambda: K6.filter_design_backward(decay, weights, phases, gH,
                                                                    geom),
             "wpe_solve": lambda: K7.wpe_solve(R, P)}
    with torch.no_grad():
        out = {k: {"device_us": cs.device_us_per_call(c),
                   "device_us_warm": cs.device_us_per_call(c, cold=False),
                   "kernels": sorted(cs.profile_device_us(c, reps=2))}
               for k, c in calls.items()}
    leaves = [t.detach().requires_grad_(True) for t in (decay, weights, phases)]
    geo = STFT(1024, 128, np.pad(hann_window(512), (0, 512)), pad_mode="constant", device=dev)
    blocks, T = geo.frame_blocks(torch.randn((8, 65536 + 512), generator=g, device=dev))
    spec = K2.stft_analysis(blocks, geo.plan, T).contiguous()
    h = torch.randn((8, 128 * 101), generator=g, device=dev).requires_grad_(True)
    host = {"filter_design_fwd": lambda: K6.filter_design(*leaves, geom),
            "filter_design_bwd": calls["filter_design_bwd"],
            "stft_analysis": lambda: K2.stft_analysis(blocks, geo.plan, T),
            "stft_synthesis": lambda: K2.stft_synthesis(spec, geo.plan),
            "minphase_fwd": lambda: K5.minimum_phase_version(h)}
    for k, c in host.items():
        for _ in range(20):
            c()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            c()
        out.setdefault(k, {})["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return out


def main_path_times(dev, runs: int = 3) -> dict:
    """The main path (``chip_smoke.blind_tester``): one cold ``do_test()``,
    then ``runs`` timed ones (sampler wall ms a step), then one under the
    profiler: device ms a step, K6's share (kernels named ``design_*``),
    device launches a step and the idle share; then one under cProfile,
    whose 40 Python functions of most own time are returned as text."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    _, _, tester, sampler_s, run = cs.blind_tester(dev)
    run()
    T = tester.sampler.T
    steps = []
    for _ in range(runs):
        run()
        steps.append(sampler_s[-1] / T * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = [(cs.kernel_name(e.key), e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    prof_py = cProfile.Profile()
    prof_py.enable()
    run()
    prof_py.disable()
    text = io.StringIO()
    pstats.Stats(prof_py, stream=text).sort_stats("tottime").print_stats(40)
    return {"python_profile": text.getvalue(), "sampler_ms_per_step": steps, "device_ms_per_step": busy / T,
            "k6_device_ms_per_step": sum(r[1] for r in rows if r[0].startswith("design_")) / T,
            "launches_per_step": sum(r[2] for r in rows) / T,
            "idle": 1 - cs.device_busy_ms(prof) / (wall * 1e3)}


def one(tree: str) -> dict:
    """Every measurement of one tree, in this process."""
    import torch
    import chip_smoke as cs                     # this checkout's helpers
    sys.path.insert(0, os.path.abspath(tree))   # then the tree's port
    import buddy_tpu_torch
    from buddy_tpu_torch.device import resolve_device
    from buddy_tpu_torch.ops import _build
    if not os.path.abspath(buddy_tpu_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise AssertionError(f"buddy_tpu_torch came from {buddy_tpu_torch.__file__}, not {tree}")
    dev = resolve_device("cuda")
    _build.build()
    return {"tree": tree, "digests": cs.shipped_digests(dev), "kernels": kernel_times(dev),
            "main_path": main_path_times(dev), "card": torch.cuda.get_device_name(0)}


def main() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--one"] and len(argv) == 2:
        print("RESULT " + json.dumps(one(argv[1])), flush=True)
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[0], argv[1]
    pairs = int(argv[2]) if len(argv) == 3 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = [t for i in range(pairs)
             for t in ((parent, change) if i % 2 == 0 else (change, parent))]
    results = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, cwd=HERE, timeout=900)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        results.append(json.loads(line[0][7:]))
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out",
                               f"compare_python_{len(results)}.txt"), "w") as f:
            f.write(f"{tree}\n" + results[-1]["main_path"].pop("python_profile"))
        print(json.dumps(results[-1]), flush=True)
    summary = {}
    for name, tree in (("parent", parent), ("change", change)):
        mine = [r for r in results if r["tree"] == tree]
        summary[name] = {
            "sampler_ms_per_step": [round(v, 1) for r in mine
                                    for v in r["main_path"]["sampler_ms_per_step"]],
            **{k: [round(r["main_path"][k], 4) for r in mine]
               for k in ("device_ms_per_step", "k6_device_ms_per_step", "launches_per_step",
                         "idle")},
            **{f"{k} {m}": [round(r["kernels"][k][m], 2) for r in mine]
               for k in mine[0]["kernels"]
               for m in ("device_us", "device_us_warm", "host_us") if m in mine[0]["kernels"][k]}}
    same = all(r["digests"] == results[0]["digests"] for r in results)
    summary["digests equal across trees and runs"] = same
    with open(os.path.join(HERE, "chiprun_out", "compare.json"), "w") as f:
        json.dump({"order": order, "results": results, "summary": summary}, f, indent=1)
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
