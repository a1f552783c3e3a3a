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


def stage_tables(radices, dtype=np.complex64):
    """(table, tw_off, root_off) of the Stockham stages, built in float64
    and cast to ``dtype``."""
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
    return np.concatenate(parts).astype(dtype), tw_off, root_off


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


# --- K5: the minimum-phase chain, one thread-block cluster a row ---------------
MINPHASE_CLUSTER = 16                 # csrc/minphase.cu kCluster: CTAs a row (a non-portable size)
MINPHASE_MAX_N1 = 128                 # longest column FFT (Stockham, butterflies only)
MINPHASE_MAX_N2 = 128                 # csrc/minphase.cu kMaxN2: longest direct DFT
MINPHASE_MAX_SLOTS = 32               # csrc/minphase.cu kMaxSlots: column-FFT outputs a CTA owns
MINPHASE_HEADER = 10 + 3 * MAX_STAGES + MINPHASE_MAX_N1 + MINPHASE_CLUSTER * MINPHASE_MAX_SLOTS


def minphase_factors(L: int):
    """(N1, N2) with L = N1 N2 for K5's four-step FFT of L = n/2 points: N1
    the longest length up to MINPHASE_MAX_N1 that the butterflies alone
    plan (radices 8, 4, 2, 3, 5), N2 <= MINPHASE_MAX_N2 a direct DFT of
    any length; None where no such pair exists.  128 x 101 at the main
    path's L = 128 (Nf + 1), Nf = 100."""
    for n1 in range(min(L, MINPHASE_MAX_N1), 1, -1):
        if L % n1 == 0 and L // n1 <= MINPHASE_MAX_N2:
            radices = fft_radices(n1)
            if radices is not None and set(radices) <= set(BUTTERFLIES):
                return n1, L // n1
    return None


def cluster_layout(n1: int, ctas: int):
    """Which CTA of a row's cluster owns each column-FFT output k1 (and so
    the spectrum bins f = k1 + N1 k2): k1 and N1 - k1 always together, so
    that the real split, which pairs bin f with L - f, stays inside a CTA.
    CTA c owns a contiguous block of k = 0 .. N1/2 (by weight: 1 for the
    lone 0 and N1/2, 2 for a pair) and their partners N1 - k, and holds
    them in slots in ascending k1, so that an exchange moves runs of
    consecutive k1 (and the pairs' first members, k1 <= N1/2, come first).
    Returns (slot, k1_of): the slot of each k1 in its CTA, and each CTA's
    k1 by slot."""
    k1_of = [[] for _ in range(ctas)]
    before = 0.0
    for k in range(n1 // 2 + 1):
        group = sorted({k, (n1 - k) % n1})
        k1_of[min(ctas - 1, int((before + len(group) / 2) * ctas / n1))].extend(group)
        before += len(group)
    slot = [0] * n1
    for ks in k1_of:
        ks.sort()
        for s, k in enumerate(ks):
            slot[k] = s
    return slot, k1_of


class MinPhasePlan:
    """K5's plan for rows of L samples (n = 2 L): every transform of the
    chain is a packed complex FFT of L points, split into (or formed from)
    the n/2 + 1 bins of a real sequence of n points.  The L points run as
    a four-step FFT, L = N1 N2 (``minphase_factors``): N2 column FFTs of N1
    points through the Stockham stages of csrc/fft.cuh, the twiddles
    exp(-2 pi i j2 k1 / L), then N1 direct DFTs of N2 points.

    ``table64`` (complex128, built in float64; the card reads it as
    complex64 from ``table``): the Stockham stages of N1 at 0, the four-step
    twiddles at ``tw4_off + j2 N1 + k1``, the N2 roots exp(-2 pi i q / N2)
    at ``roots_off`` and the split's exp(-2 pi i f / n), f = 0..L, at
    ``post_off``.  ``header`` (int32, what csrc/minphase.cu reads): [L, N1,
    N2, stages, pad_shift, CTAs, slots, tw4_off, roots_off, post_off,
    radices, tw_off, root_off (each MAX_STAGES), slot (MINPHASE_MAX_N1),
    k1_of (MINPHASE_MAX_SLOTS a CTA, -1 past the end)].
    Raises ValueError for an L the kernel cannot run."""

    def __init__(self, L: int, device=None):
        factors = minphase_factors(L)
        if factors is None:
            raise ValueError(f"K5 has no plan for rows of L={L} (n/2 = {L}): no factor "
                             f"N1 <= {MINPHASE_MAX_N1} of radices {BUTTERFLIES} leaves "
                             f"N2 <= {MINPHASE_MAX_N2}")
        self.L, (self.N1, self.N2) = L, factors
        self.radices = fft_radices(self.N1)
        stages, self.tw_off, self.root_off = stage_tables(self.radices)
        self.pad_shift = pad_shift(self.N1)
        self.slot, self.k1_of = cluster_layout(self.N1, MINPHASE_CLUSTER)
        self.slots = max(len(ks) for ks in self.k1_of)
        assert self.slots <= MINPHASE_MAX_SLOTS
        j2, k1 = np.meshgrid(np.arange(self.N2), np.arange(self.N1), indexing="ij")
        tw4 = np.exp(-2j * np.pi * j2 * k1 / L).ravel()
        roots = np.exp(-2j * np.pi * np.arange(self.N2) / self.N2)
        post = np.exp(-2j * np.pi * np.arange(L + 1) / (2 * L))
        post[[0, L]] = 1.0, -1.0          # exact: DC's and Nyquist's bins come out real
        stages64, _, _ = stage_tables(self.radices, np.complex128)
        self.tw4_off = len(stages64)
        self.roots_off = self.tw4_off + len(tw4)
        self.post_off = self.roots_off + len(roots)
        self.table64 = np.concatenate([stages64, tw4, roots, post])
        pad = [0] * (MAX_STAGES - len(self.radices))
        k1_of = sum((ks + [-1] * (MINPHASE_MAX_SLOTS - len(ks)) for ks in self.k1_of), [])
        self.header = np.array(
            [L, self.N1, self.N2, len(self.radices), self.pad_shift, MINPHASE_CLUSTER,
             self.slots, self.tw4_off, self.roots_off, self.post_off]
            + list(self.radices) + pad + self.tw_off + pad + self.root_off + pad
            + self.slot + [0] * (MINPHASE_MAX_N1 - self.N1) + k1_of, np.int32)
        assert len(self.header) == MINPHASE_HEADER
        self.header_ptr = self.header.ctypes.data
        self.table = torch.as_tensor(self.table64.astype(np.complex64).view(np.float32),
                                     device=resolve_device(device))
