"""STFT / ISTFT with torch.stft / torch.istft semantics, and kernel K2.

Semantics (``buddy_tpu/ops/stft.py``): center padding of n_fft//2 on both
sides (``reflect`` for the model, ``constant`` for the operators; none with
``center=False``), onesided, not normalized; the ISTFT overlap-adds,
divides by the window-squared envelope guarded at 1e-11, trims the centre
padding and crops or zero-pads to ``length``.  The window is given at full
n_fft length (the operators right-pad a hann(512) to 1024); only its
support (the nonzero prefix) is used.  ``STFT`` holds one geometry;
``stft`` and ``istft`` are the JAX package's functional forms over a cached
``STFT``.

K2 is the pair of CUDA kernels in ``csrc/stft.cu``: ``stft_analysis`` (a
windowed real FFT of every frame) and ``stft_synthesis`` (an inverse real
FFT of every frame, windowed and overlap-added).  They replace the TPU's
conv-STFT (``_stft_conv`` / ``_istft_conv``), a tap sum against a dense
window-folded DFT basis, by an FFT per frame in shared memory.  Both read a
``StftPlan`` built here once per geometry: the radices of the complex FFT
of length n_fft/2 (a real frame is packed as n_fft/2 complex values; the
packed route of every shipped geometry) or, for any other n_fft up to
8192, of a Bluestein step's convolution (the chirp route), the twiddle and
chirp tables computed in float64 and stored as float32, the window's
support and the per-bin weights.

Each kernel takes a vector of per-bin weights and is the other's adjoint:
analysis returns w_f * rfft(window * frame)_f; synthesis returns, per
frame, window * sum_f w_f Re(X_f e^{2 pi i f t / n}), overlap-added.  The
backward of the analysis is the synthesis with every weight 1, the backward
of the synthesis the analysis with the ISTFT's weights (1/n at DC and
Nyquist, 2/n elsewhere).  On a CPU tensor the wrappers run the plain
versions (``torch.fft``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.ops import _build
from buddy_tpu_torch.ops.fft_plan import (  # noqa: F401  (DIRECT_PRIMES: for the plan's tests)
    DIRECT_PRIMES, MAX_STAGES, butterfly_radices, chirp_fft_size, fft_radices, pad_shift,
    stage_tables)

_SIGNATURES = {
    name: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for name in ("stft_analysis", "stft_synthesis")
}

MAX_HALF = 4096                       # largest n_fft/2 the packed route takes
MAX_N_FFT = 8192                      # largest n_fft the kernels take (shared memory)
PACKED, CHIRP = 0, 1                  # the kernels' two routes (csrc/stft.cu)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window — torch.hann_window(n, periodic=True) — as
    float32 numpy (computed in float64)."""
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


def window_support(w: np.ndarray) -> int:
    """Length of the window's nonzero prefix."""
    nz = np.nonzero(w)[0]
    return int(nz[-1]) + 1 if len(nz) else len(w)


def pad_spec_frames(spec: torch.Tensor, multiple: int = 16) -> torch.Tensor:
    """Zero-pad the frame axis (last) to a multiple of ``multiple``."""
    rem = spec.shape[-1] % multiple
    if rem == 0:
        return spec
    return F.pad(spec, (0, multiple - rem))


# ---------------------------------------------------------------------------
# the plan the kernels read
# ---------------------------------------------------------------------------
class StftPlan:
    """One STFT geometry as the kernels read it, with its tensors on ``device``.

    Two routes.  ``PACKED`` (even n_fft whose n/2 <= MAX_HALF factors for
    ``fft_radices``: every shipped geometry): a frame is a complex FFT of
    n/2 points, split into the bins.  ``CHIRP`` (any other n_fft up to
    MAX_N_FFT): the DFT of a frame as a Bluestein step, a circular
    convolution of M = ``chirp_fft_size(support + F - 1)`` points run as
    two forward FFTs of M with the filter's spectrum between them.

    ``table`` holds, as interleaved complex float32: for each Stockham stage
    s of radix R after stages of total length Ns, the twiddles
    exp(-2 pi i k r / (Ns R)) at [tw_off[s] + k (R - 1) + r - 1] (k < Ns,
    1 <= r < R); for a direct-DFT stage its R roots exp(-2 pi i q / R) at
    root_off[s]; then, packed, the post-twiddles exp(-2 pi i f / n) of the
    real split at post_off + f (f <= n/2); chirp, the chirp
    w_k = exp(-i pi k^2 / n) at chirp_off + k (k < max(support, F)) and the
    spectra of the analysis's and the synthesis's filters conj(w_l) (lags
    l = f - s and s - f, at l mod M), divided by M, at ba_off and bs_off.
    ``header`` is the int32 vector the kernels' host code reads.
    ``radices`` (of the complex FFT the kernels run) is None where the
    geometry cannot be planned (n_fft < 2 or above MAX_N_FFT): the plain
    versions still take it, the kernels do not.
    """

    def __init__(self, n_fft: int, hop: int, window: np.ndarray, device=None):
        device = resolve_device(device)
        window = np.asarray(window, np.float32)
        self.n_fft, self.hop = n_fft, hop
        self.support = window_support(window)
        self.taps = -(-self.support // hop)
        self.n_bins = n_fft // 2 + 1
        half = n_fft // 2
        istft = np.full(self.n_bins, 2.0 / n_fft)
        # the plain synthesis's irfft carries 1/n and doubles the bins other
        # than DC and Nyquist, whose imaginary parts it must not see
        edge = np.zeros(self.n_bins, bool)
        edge[0] = True
        if n_fft % 2 == 0:
            edge[-1] = True
        istft[edge] = 1.0 / n_fft

        self.route = self.radices = self.header = None
        table = np.zeros(0, np.complex64)
        if n_fft % 2 == 0 and half <= MAX_HALF and fft_radices(half) is not None:
            self.route, self.M, self.radices = PACKED, half, fft_radices(half)
            table = self._tables(half)
            tail = []
        elif 2 <= n_fft <= MAX_N_FFT:
            self.route, self.M = CHIRP, chirp_fft_size(self.support + self.n_bins - 1)
            self.radices = butterfly_radices(self.M)
            table = self._chirp_tables()
            tail = [self.chirp_off, self.ba_off, self.bs_off]
        if self.radices is not None:
            pad = [0] * (MAX_STAGES - len(self.radices))
            self.header = np.array([n_fft, hop, self.support, self.M, len(self.radices),
                                    self.pad_shift, self.post_off] + list(self.radices) + pad
                                   + self._tw_off + pad + self._root_off + pad
                                   + [self.route] + tail, np.int32)
            self.header_ptr = self.header.ctypes.data
        # every tensor of the plan is a view of one buffer: one copy to the device
        parts = {"table": table.view(np.float32), "window": window[:self.support],
                 "ones": np.ones(self.n_bins), "istft_weights": istft,
                 "irfft_scale": np.where(edge, n_fft, n_fft / 2.0), "imag_mask": ~edge}
        buf = torch.as_tensor(np.concatenate([np.asarray(a, np.float32) for a in parts.values()]),
                              device=device)
        for name, t in zip(parts, torch.split(buf, [a.size for a in parts.values()])):
            setattr(self, name, t)

    def _tables(self, half: int) -> np.ndarray:
        """The stage twiddles, direct-DFT roots and post-twiddles (float64,
        stored as complex64); sets their offsets and the padding shift."""
        self.pad_shift = pad_shift(half)
        stages, self._tw_off, self._root_off = stage_tables(self.radices)
        self.post_off = len(stages)
        post = np.exp(-2j * np.pi * np.arange(half + 1) / self.n_fft).astype(np.complex64)
        return np.concatenate([stages, post])

    def _chirp_tables(self) -> np.ndarray:
        """The stages of M, the chirp and the two filters' spectra (float64,
        stored as complex64); sets their offsets and the padding shift."""
        n, M, S, F_ = self.n_fft, self.M, self.support, self.n_bins
        self.pad_shift = pad_shift(M)
        self.post_off = 0
        stages, self._tw_off, self._root_off = stage_tables(self.radices)
        k = np.arange(max(S, F_), dtype=np.int64)
        chirp = np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)      # k^2 reduced exactly

        def filt(lo, hi):          # conj(w_l) at l mod M for the lags -lo < l < hi
            b = np.zeros(M, np.complex128)
            lags = np.arange(-lo + 1, hi, dtype=np.int64)
            b[lags % M] = np.exp(1j * np.pi * ((lags * lags) % (2 * n)) / n)
            return np.fft.fft(b) / M

        self.chirp_off = len(stages)
        self.ba_off = self.chirp_off + len(chirp)
        self.bs_off = self.ba_off + M
        return np.concatenate([stages, chirp.astype(np.complex64),
                               filt(S, F_).astype(np.complex64), filt(F_, S).astype(np.complex64)])


# ---------------------------------------------------------------------------
# K2: plain versions, kernel launches, autograd functions
# ---------------------------------------------------------------------------
def analysis_plain(blocks: torch.Tensor, plan: StftPlan, n_frames: int,
                   bin_w: torch.Tensor) -> torch.Tensor:
    """(N, nb, hop) real blocks of the padded signal -> (N, F, n_frames)
    complex: bin_w[f] * rfft(window * frame t, n_fft)[f]."""
    sig = blocks.reshape(blocks.shape[0], -1)
    frames = sig.unfold(-1, plan.support, plan.hop)[:, :n_frames] * plan.window
    X = torch.fft.rfft(frames, n=plan.n_fft) * bin_w
    return X.transpose(1, 2)


def synthesis_plain(spec: torch.Tensor, plan: StftPlan, bin_w: torch.Tensor) -> torch.Tensor:
    """(N, F, T) complex -> (N, (T + taps - 1) * hop): frame t is
    window * sum_f bin_w[f] Re(spec[:, f, t] e^{2 pi i f s / n}) (the
    imaginary parts of DC and Nyquist do not enter), overlap-added at hop."""
    N, _, T = spec.shape
    Y = spec.transpose(1, 2)
    scale = bin_w.to(Y.real.dtype) * plan.irfft_scale.to(Y.real.dtype)
    Y = torch.complex(Y.real * scale, Y.imag * (scale * plan.imag_mask))
    frames = torch.fft.irfft(Y, n=plan.n_fft)[..., :plan.support] * plan.window
    taps, hop = plan.taps, plan.hop
    frames = F.pad(frames, (0, taps * hop - plan.support)).reshape(N, T, taps, hop)
    out = sum(F.pad(frames[:, :, j], (0, 0, j, taps - 1 - j)) for j in range(taps))
    return out.reshape(N, -1)


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _check_plan(plan: StftPlan, device) -> None:
    if plan.radices is None:
        raise ValueError(f"stft: n_fft={plan.n_fft} has no plan for the kernels "
                         f"(n_fft must be from 2 to {MAX_N_FFT})")
    if plan.table.device != device:
        raise ValueError(f"stft: the plan lies on {plan.table.device}, the input on {device}")


def _launch_analysis(blocks: torch.Tensor, plan: StftPlan, n_frames: int,
                     bin_w: torch.Tensor) -> torch.Tensor:
    """Kernel: (N, nb, hop) float blocks -> (N, F, n_frames) complex64."""
    _check(blocks, "stft_analysis blocks")
    _check(bin_w, "stft_analysis bin weights")
    _check_plan(plan, blocks.device)
    N, nb, hop = blocks.shape
    if hop != plan.hop or nb < n_frames + plan.taps - 1:
        raise ValueError(f"stft_analysis: blocks {tuple(blocks.shape)} do not hold {n_frames} "
                         f"frames of hop {plan.hop} and support {plan.support}")
    out = torch.empty((N, plan.n_bins, n_frames, 2), device=blocks.device, dtype=torch.float32)
    lib = _build.load("stft", _SIGNATURES)
    err = lib.stft_analysis(_build.ptr(blocks), _build.ptr(plan.window), _build.ptr(plan.table),
                            _build.ptr(bin_w), _build.ptr(out), plan.header_ptr,
                            N, nb, n_frames, _build.stream(blocks.device))
    _build.check(err, "stft_analysis")
    stft_analysis.launches += 1
    stft_analysis.by_n_fft[plan.n_fft] = stft_analysis.by_n_fft.get(plan.n_fft, 0) + 1
    return torch.view_as_complex(out)


def _launch_synthesis(spec: torch.Tensor, plan: StftPlan, bin_w: torch.Tensor) -> torch.Tensor:
    """Kernel: (N, F, T) complex64 -> (N, T + taps - 1, hop) float."""
    z = torch.view_as_real(spec.resolve_conj().contiguous())
    _check(z, "stft_synthesis spectrum")
    _check(bin_w, "stft_synthesis bin weights")
    _check_plan(plan, z.device)
    N, nbin, T, _ = z.shape
    if nbin != plan.n_bins:
        raise ValueError(f"stft_synthesis: {nbin} bins, the plan has {plan.n_bins}")
    nb_out = T + plan.taps - 1
    out = torch.empty((N, nb_out, plan.hop), device=z.device, dtype=torch.float32)
    lib = _build.load("stft", _SIGNATURES)
    err = lib.stft_synthesis(_build.ptr(z), _build.ptr(plan.window), _build.ptr(plan.table),
                             _build.ptr(bin_w), _build.ptr(out), plan.header_ptr,
                             N, nb_out, T, _build.stream(z.device))
    _build.check(err, "stft_synthesis")
    stft_synthesis.launches += 1
    stft_synthesis.by_n_fft[plan.n_fft] = stft_synthesis.by_n_fft.get(plan.n_fft, 0) + 1
    return out


def _analysis(blocks, plan, n_frames, bin_w):
    if blocks.device.type == "cpu":
        return analysis_plain(blocks, plan, n_frames, bin_w)
    return _launch_analysis(blocks, plan, n_frames, bin_w)


def _synthesis(spec, plan, bin_w):
    """-> (N, T + taps - 1, hop)."""
    if spec.device.type == "cpu":
        return synthesis_plain(spec, plan, bin_w).reshape(spec.shape[0], -1, plan.hop)
    return _launch_synthesis(spec, plan, bin_w)


class _AnalysisFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, plan, n_frames):
        ctx.plan, ctx.nb = plan, blocks.shape[1]
        return _analysis(blocks, plan, n_frames, plan.ones)

    @staticmethod
    def backward(ctx, grad):
        g = _synthesis(grad, ctx.plan, ctx.plan.ones)      # (N, T + taps - 1, hop)
        g = F.pad(g, (0, 0, 0, ctx.nb - g.shape[1]))
        return g, None, None


class _SynthesisFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, plan):
        ctx.plan, ctx.n_frames = plan, spec.shape[-1]
        return _synthesis(spec, plan, plan.istft_weights).reshape(spec.shape[0], -1)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        g = grad.contiguous().reshape(grad.shape[0], -1, plan.hop)
        return _analysis(g, plan, ctx.n_frames, plan.istft_weights), None


def stft_analysis(blocks: torch.Tensor, plan: StftPlan, n_frames: int) -> torch.Tensor:
    """K2 analysis: (N, nb, hop) real blocks -> (N, F, n_frames) complex,
    differentiable.  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    return _AnalysisFn.apply(blocks, plan, n_frames)


def stft_synthesis(spec: torch.Tensor, plan: StftPlan) -> torch.Tensor:
    """K2 synthesis: (N, F, T) complex -> (N, (T + taps - 1) * hop) real,
    before the envelope division, differentiable."""
    return _SynthesisFn.apply(spec, plan)


stft_analysis.launches = 0
stft_synthesis.launches = 0
stft_analysis.by_n_fft = {}        # the same launches, by geometry
stft_synthesis.by_n_fft = {}


# ---------------------------------------------------------------------------
# one STFT geometry
# ---------------------------------------------------------------------------
class STFT:
    """An STFT geometry (n_fft, hop, window, pad mode, centring) with its
    plan on ``device``; ``stft`` and ``istft`` follow torch.stft /
    torch.istft.  On any device but the CPU an n_fft outside 2..MAX_N_FFT
    raises."""

    def __init__(self, n_fft: int, hop_length: int, window: np.ndarray, *,
                 pad_mode: str = "reflect", center: bool = True, device=None):
        window = np.asarray(window, np.float32)
        if window.shape != (n_fft,):
            raise ValueError("window must be length n_fft (pre-padded)")
        self.n_fft, self.hop, self.pad_mode, self.center = n_fft, hop_length, pad_mode, center
        self.device = resolve_device(device)
        self.plan = StftPlan(n_fft, hop_length, window, self.device)
        if self.device.type != "cpu" and self.plan.radices is None:
            raise ValueError(f"STFT: no FFT plan for n_fft={n_fft} on {self.device} "
                             f"(the kernels take n_fft from 2 to {MAX_N_FFT}: the chirp "
                             f"route's convolution of 1.5 n_fft points must fit in shared "
                             f"memory)")
        self.n_bins = self.plan.n_bins
        self.taps = self.plan.taps
        self._wsq = window.astype(np.float64) ** 2
        self._env: dict = {}

    def frame_blocks(self, x: torch.Tensor):
        """(N, L) real -> the signal, centre-padded where ``center``, as
        (N, nb, hop) blocks, and the frame count.  Without centring a
        signal shorter than n_fft raises, as in torch.stft."""
        if self.center:
            p = self.n_fft // 2
            x = F.pad(x[:, None], (p, p), mode=self.pad_mode)[:, 0]
        L = x.shape[-1]
        if L < self.n_fft:
            raise ValueError(f"stft: a signal of {L} samples is shorter than "
                             f"n_fft={self.n_fft}")
        n_frames = 1 + (L - self.n_fft) // self.hop
        nb = max(-(-L // self.hop), n_frames - 1 + self.taps)
        return F.pad(x, (0, nb * self.hop - L)).reshape(-1, nb, self.hop), n_frames

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L) real -> (..., F, n_frames) complex64."""
        lead = x.shape[:-1]
        blocks, n_frames = self.frame_blocks(x.reshape(-1, x.shape[-1]))
        spec = stft_analysis(blocks, self.plan, n_frames)
        return spec.reshape(lead + spec.shape[1:])

    def _envelope(self, n_frames: int) -> torch.Tensor:
        env = self._env.get(n_frames)
        if env is None:
            ola_len = self.n_fft + self.hop * (n_frames - 1)
            e = np.zeros(ola_len, np.float64)
            for t in range(n_frames):
                e[t * self.hop: t * self.hop + self.n_fft] += self._wsq
            env = torch.as_tensor(np.where(e > 1e-11, e, 1.0).astype(np.float32),
                                  device=self.device)
            self._env[n_frames] = env
        return env

    def istft(self, spec: torch.Tensor, length: int | None = None) -> torch.Tensor:
        """(..., F, n_frames) complex -> (..., length) real: the overlap-add
        from n_fft//2 on where ``center`` (else from 0), zero-padded or
        cropped to ``length``."""
        lead, n_frames = spec.shape[:-2], spec.shape[-1]
        spec = spec.reshape((-1,) + spec.shape[-2:]).to(torch.complex64)
        y = stft_synthesis(spec, self.plan)
        ola_len = self.n_fft + self.hop * (n_frames - 1)
        y = F.pad(y, (0, ola_len - y.shape[-1])) if y.shape[-1] < ola_len else y[:, :ola_len]
        y = y / self._envelope(n_frames)
        start = self.n_fft // 2 if self.center else 0
        end = start + length if length is not None else ola_len - start
        if end > ola_len:
            y = F.pad(y, (0, end - ola_len))
        y = y[:, start:end]
        return y.reshape(lead + y.shape[-1:])


# ---------------------------------------------------------------------------
# the functional forms (``buddy_tpu/ops/stft.py:205,401``)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _cached_geometry(wbytes: bytes, n_fft: int, hop: int, pad_mode: str, center: bool,
                     device: torch.device) -> STFT:
    return STFT(n_fft, hop, np.frombuffer(wbytes, np.float32), pad_mode=pad_mode,
                center=center, device=device)


def _geometry(window, n_fft: int, hop: int, pad_mode: str, center: bool, device) -> STFT:
    """The ``STFT`` of these settings on ``device``, built once."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    wbytes = np.ascontiguousarray(window, np.float32).tobytes()
    return _cached_geometry(wbytes, n_fft, hop, pad_mode, center, device)


def stft(x: torch.Tensor, window, *, n_fft: int, hop_length: int, center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """torch.stft (onesided, not normalized, complex output): (..., L) real
    -> (..., n_fft // 2 + 1, n_frames) complex64, differentiable in ``x``.

    ``window`` is the (n_fft,) analysis window, pre-padded, as numpy or a
    tensor; either way it is read as a constant and no gradient flows to it
    (the JAX package could differentiate a traced window; no caller passes
    one).  On a CUDA tensor this launches K2's analysis; an n_fft above
    MAX_N_FFT raises there."""
    return _geometry(window, n_fft, hop_length, pad_mode, center, x.device).stft(x)


def istft(spec: torch.Tensor, window, *, n_fft: int, hop_length: int, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """torch.istft (onesided, not normalized): (..., n_fft // 2 + 1,
    n_frames) complex -> (..., length) real, differentiable in ``spec``;
    ``window`` as for ``stft``.  On a CUDA tensor this launches K2's
    synthesis."""
    geom = _geometry(window, n_fft, hop_length, "reflect", center, spec.device)
    return geom.istft(spec, length)
