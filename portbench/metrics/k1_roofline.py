"""K1 (GroupNorm + SiLU, forward and backward): its byte bound over its
device time, summed over the window's launches; None where the hooks'
count of calls and the wrappers' launch counters disagree."""

from portbench.roofline import PEAK_BYTES_PER_S
from portbench.roofline.kernels import K1, k1_bytes, named_us

UNIT = "%"


def read(rec):
    calls = rec.get("gn_calls") or {}
    fwd = sum(n for (_, _, _), n in calls.items())
    bwd = sum(n for (_, _, b), n in calls.items() if b)
    c = rec["counters"]
    if fwd == 0 or fwd != c.get("k1_fwd") or bwd != c.get("k1_bwd"):
        return None
    nbytes = sum(n * (k1_bytes(s, d, False) + (k1_bytes(s, d, True) if b else 0))
                 for (s, d, b), n in calls.items())
    us = named_us(rec["events"], K1)
    return 100.0 * (nbytes / PEAK_BYTES_PER_S) / (us * 1e-6) if us > 0 else None
