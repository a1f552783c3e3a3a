"""The traced window: the device's activity under ``torch.profiler`` and
what the per-layer readers take from it.

Only device activity is recorded (no host ops), so the trace of a window
of some hundred thousand launches stays cheap to read. The host idles
``PAD_S`` at each end of the window: on the H100 machines a kernel's
timestamp now and then lies milliseconds before its launch on the host's
clock, and the profiler keeps only the activity inside its window.
"""

from __future__ import annotations

import contextlib
import time

PAD_S = 0.02


@contextlib.contextmanager
def device_profile():
    """The profiler over the body, recording the device's activity (the
    host's on a machine without CUDA, which records no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        time.sleep(PAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
        time.sleep(PAD_S)


def device_events(prof) -> list:
    """[(kernel name, start us, duration us)] of every device event (kernels,
    copies, sets), in start order."""
    import torch
    out = [(e.name, e.time_range.start, e.time_range.end - e.time_range.start)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    out.sort(key=lambda r: r[1])
    return out


def busy_us(events) -> float:
    """The union of the events' intervals: us in which the device ran at
    least one of them (a sum would count overlapping kernels twice)."""
    busy, end = 0.0, float("-inf")
    for _, start, dur in events:
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def short_name(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    arguments or parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time (by short name, seconds
    summed) and the longest idle gaps, named by the kernels on either side
    (seconds summed over the gaps between the same pair)."""
    ops: dict = {}
    for name, _, dur in events:
        k = short_name(name)
        ops[k] = ops.get(k, 0.0) + dur * 1e-6
    gaps: dict = {}
    end, prev = None, None
    for name, start, dur in events:
        if end is not None and start > end:
            k = f"{short_name(prev)} -> {short_name(name)}"
            gaps[k] = gaps.get(k, 0.0) + (start - end) * 1e-6
        if end is None or start + dur > end:
            end, prev = start + dur, name
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
