"""K11 (FIR upfirdn, forward and input vjp): its byte bound over its
device time, summed over the window's launches by geometry."""

from portbench.roofline import PEAK_BYTES_PER_S
from portbench.roofline.kernels import K11, k11_bytes, named_us

UNIT = "%"


def read(rec):
    launches = rec.get("k11") or {}
    n = sum(launches.values())
    c = rec["counters"]
    if n == 0 or n != c.get("k11_fwd", 0) + c.get("k11_bwd", 0):
        return None
    nbytes = sum(cnt * k11_bytes(key[1], key[3].out, key[4].out) for key, cnt in launches.items())
    us = named_us(rec["events"], K11)
    return 100.0 * (nbytes / PEAK_BYTES_PER_S) / (us * 1e-6) if us > 0 else None
