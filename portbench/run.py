"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the program's build, weights and inputs from the seed,
one short warm batch) is timed from the start of this module to the start
of the window. The window runs the cell's driver for ``--seconds``, ending
at the end of its first whole batch or step past that length. With
``--trace 0`` the run reports the cell's end-to-end metrics; with
``--trace 1`` the window runs under the profiler and the run reports the
cell's per-layer metrics, with the device's busy seconds and a breakdown.
Then the program's state is freed and the check runs: each number
compared is printed beside its limit, as the last lines of standard error
and under ``checks``, the last key of the result, which is the last line
of standard output.

The run needs CUDA devices for the cell's chips: without them it exits
with code 2 and prints no result. Build and kernel caches stay inside the
checkout (``buddy_tpu_torch/_build/``; Triton's under
``portbench/.cache/``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import registry  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = {"jax", "jaxlib", "flax", "buddy_tpu"}
HANG_S = 900        # a run that has not ended by then prints where it is and exits


def fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout: only a cell's first
    run there compiles."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (``buddy_tpu_torch`` is not ``buddy_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def traced_window(driver, seconds: float) -> tuple:
    """The window under the profiler, with the launch counters, K1's calls
    and K11's launches recorded; returns (window, record)."""
    from portbench import program, trace
    before = program.read_counters()
    gn = program.GroupNormCalls(driver.trace_modules())
    program.k11_record(True)
    with trace.device_profile() as prof:
        w = driver.run_window(seconds)
    k11 = program.k11_record(False)
    gn.remove()
    after = program.read_counters()
    events = trace.device_events(prof)
    # the window's own wall time: the profiler's pads, its stop and the
    # reading of its events lie outside the work
    rec = {"events": events, "window_s": w["wall_s"], "steps": w["steps"],
           "busy_s": trace.busy_us(events) * 1e-6,
           "counters": {k: after[k] - before[k] for k in after},
           "gn_calls": gn.calls, "k11": k11}
    return w, rec


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str,
             extra=(), base: str = registry.HERE, benchmark=None, numbers=None) -> dict:
    """Everything of a run after the look for a chip: the result's keys.
    ``extra``: more overrides of the port's configuration (the control's
    lower precision); ``base`` and ``benchmark``: where the cells,
    configurations, readers and the metrics' list are found; ``numbers``:
    a dict that gets every number the check computes, compared or not."""
    import torch
    cell = registry.load_cell(name, base)
    config = registry.load_config(cell["config"], base)
    driver = registry.load_driver(cell["driver"]).Driver(cell, config, seed, device, extra)
    driver.setup()
    setup_s = time.perf_counter() - T0
    if device == "cuda":
        torch.cuda.synchronize()
    if traced:
        w, rec = traced_window(driver, seconds)
    else:
        w, rec = driver.run_window(seconds), None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    failed = driver.failed()
    metrics = {}
    if rec is None:
        values = {**driver.end_to_end(w), "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m, unit in registry.metrics_of(name, "end_to_end", benchmark):
            metrics[m] = {"value": values[m], "unit": unit}
    else:
        from portbench.roofline import PEAK_FLOPS
        from portbench.roofline.flops import unet_flops
        tr = cell["traffic"]
        mode, evals = driver.flops_mode()
        rec["peak_flops"] = PEAK_FLOPS[cell["precision"]]
        rec["flops_per_step"] = evals * unet_flops(
            config["network"], int(tr["batch"]), int(tr["audio_len"]),
            int(config["stft"]["n_fft"]), int(config["stft"]["hop_length"]), mode)
        for m, unit in registry.metrics_of(name, "per_layer", benchmark):
            v = registry.load_metric(m, base).read(rec)
            if v is not None:
                metrics[m] = {"value": v, "unit": unit}
    driver.free_program()
    found = driver.check()
    if numbers is not None:
        numbers.update(found)
    for line in getattr(driver, "detail_lines", lambda: [])():
        print(line, file=sys.stderr)
    limits = cell["limits"]
    for k, v in found.items():
        if k not in limits:
            print(f"not compared: {k} = {v!r}", file=sys.stderr)
    checks = {k: {"value": found[k], "limit": lim} for k, lim in limits.items()}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": int(w["items"]), "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name() if device == "cuda" else device,
                         "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if rec is not None:
        from portbench import trace
        result["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = trace.breakdown(rec["events"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    fixed_caches()
    cell = registry.load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
