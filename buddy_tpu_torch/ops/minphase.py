"""Hilbert transform and minimum-phase RIR projection
(``buddy_tpu/ops/minphase.py``), and kernel K5 (CUDA, ``csrc/minphase.cu``).

The blind operator's consistency projection runs every estimated RIR through
``minimum_phase_version`` in each inner update, forward and backward.  K5
runs the whole chain of a row, its four FFTs included, in one launch each
way: one thread-block cluster a row (``csrc/minphase.cu``), from the plan of
``ops/fft_plan.py::MinPhasePlan``.  The forward saves the half spectra of
H and of the minimum phase (n/2 + 1 bins a row each) for the
backward.

``minimum_phase_plain`` is the plain PyTorch version and
``minimum_phase_backward_plain`` its explicit backward formula (the one the
backward kernel implements).  Wrappers, each counting its launches (one a
call): ``minimum_phase_version`` and ``minimum_phase_backward``.  CPU
tensors take the plain versions (autograd differentiates the forward); CUDA
tensors launch the kernels or raise (a row length that K5 cannot plan
raises ValueError).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from buddy_tpu_torch.ops import _build, dft
from buddy_tpu_torch.ops.fft_plan import MinPhasePlan

_windows: dict = {}


def _heaviside_window(n: int) -> np.ndarray:
    """Flipped 2*heaviside(linspace(-1, 1, n)); for odd n the zero crossing
    contributes heaviside(0)=1, i.e. the value 2 at the centre."""
    x = np.linspace(-1.0, 1.0, n)
    return (2.0 * np.heaviside(x, 1.0))[::-1].copy()


def _window(n: int, dtype, device) -> torch.Tensor:
    key = (n, dtype, str(device))
    if key not in _windows:
        _windows[key] = torch.as_tensor(_heaviside_window(n), dtype=dtype, device=device)
    return _windows[key]


def hilbert(h: torch.Tensor) -> torch.Tensor:
    """FFT-window Hilbert transform along the last axis."""
    n = h.shape[-1]
    real_dtype = h.real.dtype if h.is_complex() else h.dtype
    return dft.icfft(_window(n, real_dtype, h.device) * dft.cfft(h, n), n)


# --- plain versions ---------------------------------------------------------
def minimum_phase_plain(h: torch.Tensor) -> torch.Tensor:
    t_orig = h.shape[-1]
    n = 2 * t_orig
    H = dft.cfft(h, n)
    mag = torch.abs(H)
    log_mag = torch.log(mag + 1e-8)
    min_phase = -torch.imag(hilbert(log_mag))
    rec = dft.icfft(mag * torch.exp(1j * min_phase), n).real
    return rec[..., :t_orig]


def minimum_phase_backward_plain(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dh from g = dL/d(minimum_phase_plain(h)), written out pass by pass
    (adjoint of fft: n * ifft; of ifft: fft / n)."""
    L = h.shape[-1]
    n = 2 * L
    w = _window(n, h.dtype, h.device)
    H = dft.cfft(h, n)
    mag = torch.abs(H)
    zi = dft.icfft(w * dft.cfft(torch.log(mag + 1e-8), n), n).imag
    gW = dft.cfft(g, n) / n                                  # through Re, crop and ifft
    c, s = torch.cos(zi), torch.sin(zi)
    g_mag = gW.real * c - gW.imag * s                        # W = |H| (cos zi - i sin zi)
    gz = torch.complex(torch.zeros_like(zi), -mag * (gW.real * s + gW.imag * c))
    g_log = dft.icfft(w * dft.cfft(gz, n), n).real           # through ifft, window and fft
    zero = mag == 0
    g_mag = g_mag + g_log / (mag + 1e-8)
    gH = torch.where(zero, torch.zeros_like(H),
                     g_mag * H / torch.where(zero, torch.ones_like(mag), mag))
    return (n * dft.icfft(gH, n)).real[..., :L]


# --- kernel launches ----------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "minphase_forward": [_P] * 7 + [_I, _P],
    "minphase_backward": [_P] * 7 + [_I, _P],
}
_plans: dict = {}


def _plan(L: int, device) -> MinPhasePlan:
    key = (L, str(device))
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = MinPhasePlan(L, device)
    return plan


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() < 1:
        raise ValueError(f"{what}: expected a float32 CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch_forward(h: torch.Tensor):
    """y (..., L) and the saved half spectra: H (N, L + 1) complex64 and the
    minimum phase (N, L + 1) float32."""
    _check(h, "minimum_phase_version")
    lead, L = h.shape[:-1], h.shape[-1]
    plan = _plan(L, h.device)
    h2 = h.reshape(-1, L).contiguous()
    N = h2.shape[0]
    y = torch.empty_like(h2)
    Hs = torch.empty((N, L + 1), device=h.device, dtype=torch.complex64)
    phis = torch.empty((N, L + 1), device=h.device, dtype=torch.float32)
    lib = _build.load("minphase", _SIGNATURES)
    p = _build.ptr
    scratch = torch.empty((N, 4 * (L + 1)), device=h.device, dtype=torch.float32)
    err = lib.minphase_forward(p(h2), p(y), p(Hs), p(phis), p(scratch), p(plan.table),
                               plan.header_ptr, N, _build.stream(h.device))
    _build.check(err, "minphase_forward")
    minimum_phase_version.launches += 1
    return y.reshape(lead + (L,)), Hs, phis


def minimum_phase_backward(Hs: torch.Tensor, phis: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 backward wrapper: dL/dh (N, L) from the forward's saved half
    spectra H (N, L + 1) and phase (N, L + 1) and g = dL/dout (N, L)."""
    _check(g, "minimum_phase_backward")
    N, L = Hs.shape[0], Hs.shape[-1] - 1
    if Hs.dtype != torch.complex64 or phis.dtype != torch.float32 or \
            tuple(phis.shape) != (N, L + 1) or g.numel() != N * L:
        raise ValueError(f"minimum_phase_backward: H {tuple(Hs.shape)} {Hs.dtype}, phase "
                         f"{tuple(phis.shape)}, g {tuple(g.shape)}")
    plan = _plan(L, g.device)
    g2 = g.reshape(N, L).contiguous()
    dh = torch.empty_like(g2)
    lib = _build.load("minphase", _SIGNATURES)
    p = _build.ptr
    scratch = torch.empty((N, 4 * (L + 1)), device=g.device, dtype=torch.float32)
    err = lib.minphase_backward(p(g2), p(Hs.contiguous()), p(phis.contiguous()), p(dh),
                                p(scratch), p(plan.table), plan.header_ptr, N,
                                _build.stream(g.device))
    _build.check(err, "minphase_backward")
    minimum_phase_backward.launches += 1
    return dh


class _MinPhaseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        out, Hs, phis = _launch_forward(h)
        ctx.save_for_backward(Hs, phis)
        return out

    @staticmethod
    def backward(ctx, g):
        Hs, phis = ctx.saved_tensors
        return minimum_phase_backward(Hs, phis, g).reshape(g.shape)


def minimum_phase_version(h: torch.Tensor) -> torch.Tensor:
    """Same magnitude spectrum as ``h`` with minimum phase (cepstral method
    with 2x zero padding); ``h`` is real (..., L), the result too."""
    if h.device.type == "cpu":
        return minimum_phase_plain(h)
    return _MinPhaseFn.apply(h)


minimum_phase_version.launches = 0
minimum_phase_backward.launches = 0
