#!/usr/bin/env python3
"""How often a torch.profiler window of a few short calls comes back without
their kernels on one NVIDIA GPU, with and without an idle margin at each end
of the window, and how a kernel's timestamp sits against its launch on the
host's clock.

    python3 profiler_clock_probe.py [--seconds 100] [--pad 0.02]

The profiler keeps only the device activity whose timestamps fall inside its
window.  Each round runs a load (20 float32 GEMMs of 4096), then profiles 20
warm ``torch.stft`` calls (8 x 65536 samples, n_fft 510, hop 128) in a window
without a margin and in one with ``--pad`` seconds of host idle time at each
end (``chip_smoke.device_profile``'s rule), counting the windows that hold
none of the calls' kernels ("empty") or only part of them ("partial").
Every tenth round also profiles the host's activity and reads, for each
kernel, its start minus its launch's start (the "skew": it should be a few
microseconds and never negative) and the window's margins.  Prints one JSON
line every 20 s and one at the end; exits 1 without a card.
"""
import argparse
import json
import sys
import time


def stft_window(prof_kwargs, fn, pad: float):
    import torch
    from torch.profiler import profile
    with profile(**prof_kwargs) as prof:
        time.sleep(pad)
        h0 = time.time_ns()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        h1 = time.time_ns()
        time.sleep(pad)
    return prof, h0, h1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=100.0)
    ap.add_argument("--pad", type=float, default=0.02)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_clock_probe: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity
    dev = "cuda"
    x = torch.randn(8, 65536, device=dev)
    w = torch.hann_window(510, device=dev)
    fn = lambda: torch.stft(x, 510, 128, window=w, center=True, pad_mode="reflect",
                            return_complex=True)
    big = torch.randn(4096, 4096, device=dev)
    fn()
    torch.cuda.synchronize()
    # the kernels of one window's 20 calls, from a window with the margin
    launches = 0
    while not launches:
        prof, _, _ = stft_window({"activities": [ProfilerActivity.CUDA]}, fn, args.pad)
        launches = sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0)
    stats = {m: {"windows": 0, "empty": 0, "partial": 0} for m in ("no_margin", "margin")}
    skew = []
    t0 = last = time.time()
    i = 0
    while time.time() - t0 < args.seconds:
        i += 1
        for mode, pad in (("no_margin", 0.0), ("margin", args.pad)):
            for _ in range(20):
                big @ big
            torch.cuda.synchronize()
            prof, _, _ = stft_window({"activities": [ProfilerActivity.CUDA]}, fn, pad)
            n = sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0)
            st = stats[mode]
            st["windows"] += 1
            st["empty"] += n == 0
            st["partial"] += 0 < n < launches
        if i % 10 == 0:
            prof, h0, h1 = stft_window(
                {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}, fn, 0.0)
            evs = prof.profiler.kineto_results.events()
            launch = {e.correlation_id(): e.start_ns() for e in evs
                      if e.device_type() == torch.autograd.DeviceType.CPU and "Launch" in e.name()}
            kern = [e for e in evs if e.device_type() == torch.autograd.DeviceType.CUDA]
            sk = [e.start_ns() - launch[e.correlation_id()] for e in kern
                  if e.correlation_id() in launch]
            if sk:
                skew.append({"min_skew_us": min(sk) / 1e3,
                             "first_kernel_after_window_start_us":
                                 (min(e.start_ns() for e in kern) - h0) / 1e3,
                             "window_end_after_last_kernel_us":
                                 (h1 - max(e.start_ns() + e.duration_ns() for e in kern)) / 1e3})
        if time.time() - last > 20 or time.time() - t0 >= args.seconds:
            last = time.time()
            neg = [s["min_skew_us"] for s in skew if s["min_skew_us"] < 0]
            print(json.dumps({
                "seconds": round(last - t0, 1), "kernels_a_window": launches, "pad_s": args.pad,
                **stats, "skew_samples": len(skew), "negative_skews": len(neg),
                "most_negative_skew_us": min(neg, default=None),
                "least_window_start_margin_us": min(
                    (s["first_kernel_after_window_start_us"] for s in skew), default=None),
                "least_window_end_margin_us": min(
                    (s["window_end_after_last_kernel_us"] for s in skew), default=None)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
