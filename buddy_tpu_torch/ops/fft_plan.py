"""Host-side plans of the complex FFTs that the CUDA kernels run in shared
memory (``csrc/fft.cuh``): K2's packed real FFTs (``ops/stft.py::StftPlan``)
and K3's frame-axis convolutions (``ConvFftPlan``).

A plan is a list of radices and, for each Stockham stage s of radix R
after stages of total length Ns, the twiddles exp(-2 pi i k r / (Ns R)) at
[tw_off[s] + k (R - 1) + r - 1] (k < Ns, 1 <= r < R), computed in float64
and stored as complex64; a stage whose radix is a prime above 5 (a direct
DFT) also has its R roots exp(-2 pi i q / R) at root_off[s].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from buddy_tpu_torch.device import resolve_device

MAX_STAGES = 12                       # csrc/fft.cuh kMaxStages
# radices with a butterfly of their own; any other prime up to 31 is a direct DFT
BUTTERFLIES = (8, 4, 2, 3, 5)
DIRECT_PRIMES = (7, 11, 13, 17, 19, 23, 29, 31)
# relative cost of one stage per point, for choosing a transform length:
# a pass through shared memory plus the butterfly's arithmetic (a direct
# DFT of a prime R costs ~2R operations a point)
_PASS_COST = 10.0
_POINT_COST = {8: 12.0, 4: 8.5, 2: 5.0, 3: 9.3, 5: 12.8}


def fft_radices(m: int):
    """Radices of a complex FFT of length m for the kernels: eights, a four
    or a two, threes and fives, then one prime up to 31 as a direct DFT; None where m
    has a larger prime factor, two such primes, or needs more than
    MAX_STAGES stages."""
    radices = []
    for r in BUTTERFLIES + DIRECT_PRIMES:
        while m % r == 0:
            radices.append(r)
            m //= r
    if m != 1 or not radices or len(radices) > MAX_STAGES or \
            len(set(radices) & set(DIRECT_PRIMES)) > 1:
        return None
    return radices


def pad_shift(m: int) -> int:
    """Bank-conflict padding of a frame of m points in shared memory, as the
    shift of ``padded(i) = i + (i >> shift)``: one float2 in 16 for even m,
    none (shift 30) for odd m.  At the lengths the kernels run (K2's 512, 256
    and 255 = 3 5 17, K3's 640 = 8 8 2 5) a model of the stages' bank
    conflicts (tests/test_torch_subband_plan.py) agrees: the padding halves
    the wavefronts of the even ones, and only adds conflicts at 255."""
    return 4 if m % 2 == 0 else 30


def stage_tables(radices):
    """(complex64 table, tw_off, root_off) of the Stockham stages."""
    parts, tw_off, root_off, off, Ns = [], [], [], 0, 1
    for R in radices:
        k = np.arange(Ns)[:, None]
        r = np.arange(1, R)[None, :]
        parts.append(np.exp(-2j * np.pi * k * r / (Ns * R)).ravel())
        tw_off.append(off)
        off += Ns * (R - 1)
        if R in DIRECT_PRIMES:
            parts.append(np.exp(-2j * np.pi * np.arange(R) / R))
            root_off.append(off)
            off += R
        else:
            root_off.append(0)
        Ns *= R
    return np.concatenate(parts).astype(np.complex64), tw_off, root_off


def fft_cost(n: int) -> float:
    """Relative cost of a complex FFT of n points through the kernels'
    stages; inf where n has no plan."""
    radices = fft_radices(n)
    if radices is None:
        return float("inf")
    return n * sum(_PASS_COST + _POINT_COST.get(R, 2.0 * R) for R in radices)


@lru_cache(maxsize=None)
def conv_fft_size(T: int, Nf: int) -> int:
    """K3's transform length for T frames and Nf taps: the plannable length
    of least cost from T + Nf - 1 (the linear convolution's) up to twice
    that; 640 = 8 8 2 5 at the main path's 517 frames and 100 taps."""
    lo = T + Nf - 1
    return min(range(lo, 2 * lo + 1), key=lambda n: (fft_cost(n), n))


class ConvFftPlan:
    """K3's plan: a complex FFT of n points (``conv_fft_size``), its table on
    ``device`` as interleaved float32 and the int32 ``header`` that the
    kernels' host code reads: [n, stages, pad_shift, radices, tw_off,
    root_off], each list padded to MAX_STAGES."""

    def __init__(self, n: int, device=None):
        self.n = n
        self.radices = fft_radices(n)
        if self.radices is None:
            raise ValueError(f"no FFT plan for n={n}")
        table, self.tw_off, self.root_off = stage_tables(self.radices)
        self.pad_shift = pad_shift(n)
        pad = [0] * (MAX_STAGES - len(self.radices))
        self.header = np.array([n, len(self.radices), self.pad_shift] + list(self.radices) + pad
                               + self.tw_off + pad + self.root_off + pad, np.int32)
        self.header_ptr = self.header.ctypes.data
        self.table = torch.as_tensor(table.view(np.float32), device=resolve_device(device))
