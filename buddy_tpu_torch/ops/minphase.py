"""Hilbert transform and minimum-phase RIR projection
(``buddy_tpu/ops/minphase.py``), and kernel K5 (Triton, ``csrc/minphase.py``).

The blind operator's consistency projection runs every estimated RIR through
``minimum_phase_version`` in each inner update, forward and backward.  The
four FFTs of the chain are ``torch.fft`` (cuFFT on the card), as the JAX
package computes them outside any kernel; the passes between them are K5:
one launch between two transforms, forward and backward.

``minimum_phase_plain`` is the plain PyTorch version and
``minimum_phase_backward_plain`` its explicit backward formula (the one the
backward kernels implement).  Wrappers, each counting every Triton launch
it makes (four per chain): ``minimum_phase_version`` and
``minimum_phase_backward``.  CPU tensors take
the plain versions (autograd differentiates the forward); CUDA tensors launch
the kernels or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from buddy_tpu_torch.ops import dft

_BLOCK = 1024
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
def _check(h: torch.Tensor, what: str) -> None:
    if h.device.type != "cuda" or h.dtype != torch.float32 or h.dim() < 1:
        raise ValueError(f"{what}: expected a float32 CUDA tensor, got {h.dtype} "
                         f"{tuple(h.shape)} on {h.device}")


def _grid(total: int):
    return ((total + _BLOCK - 1) // _BLOCK,)


def _real_crop(K, w: torch.Tensor, L: int, wrapper) -> torch.Tensor:
    N, n = w.shape
    out = torch.empty((N, L), device=w.device, dtype=torch.float32)
    K.real_crop_kernel[_grid(N * L)](torch.view_as_real(w), out, N * L, n, L,
                                     BLOCK=_BLOCK, num_warps=4)
    wrapper.launches += 1
    return out


def _apply_window(K, U: torch.Tensor, w: torch.Tensor, wrapper) -> torch.Tensor:
    V = torch.empty_like(U)
    K.window_kernel[_grid(U.numel())](torch.view_as_real(U), w, torch.view_as_real(V),
                                      U.numel(), U.shape[-1], BLOCK=_BLOCK, num_warps=4)
    wrapper.launches += 1
    return V


def _launch_forward(h: torch.Tensor):
    from buddy_tpu_torch.csrc import minphase as K
    _check(h, "minimum_phase_version")
    lead, L = h.shape[:-1], h.shape[-1]
    n = 2 * L
    h2 = h.reshape(-1, L)
    total = h2.shape[0] * n
    w = _window(n, torch.float32, h.device)
    H = dft.cfft(h2, n).contiguous()
    log_mag = torch.empty(H.shape, device=h.device, dtype=torch.float32)
    K.logmag_kernel[_grid(total)](torch.view_as_real(H), log_mag, total,
                                  BLOCK=_BLOCK, num_warps=4)
    minimum_phase_version.launches += 1
    z = dft.icfft(_apply_window(K, dft.cfft(log_mag, n), w, minimum_phase_version), n)
    W = torch.empty_like(H)
    K.phasor_kernel[_grid(total)](torch.view_as_real(H), torch.view_as_real(z),
                                  torch.view_as_real(W), total, BLOCK=_BLOCK, num_warps=4)
    minimum_phase_version.launches += 1
    out = _real_crop(K, dft.icfft(W, n), L, minimum_phase_version)
    return out.reshape(lead + (L,)), H, z


def minimum_phase_backward(H: torch.Tensor, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 backward wrapper: dL/dh (N, L) from the saved spectrum H (N, 2L),
    the saved analytic signal z (N, 2L) and g = dL/dout (N, L)."""
    from buddy_tpu_torch.csrc import minphase as K
    _check(g, "minimum_phase_backward")
    N, n = H.shape
    L = n // 2
    total = N * n
    w = _window(n, torch.float32, H.device)
    gw = dft.cfft(g.reshape(N, L).contiguous(), n)           # the 1/n is applied in the kernel
    gz = torch.empty_like(H)
    g_mag = torch.empty(H.shape, device=H.device, dtype=torch.float32)
    K.phasor_bwd_kernel[_grid(total)](torch.view_as_real(H), torch.view_as_real(z),
                                      torch.view_as_real(gw), torch.view_as_real(gz), g_mag,
                                      total, 1.0 / n, BLOCK=_BLOCK, num_warps=4)
    minimum_phase_backward.launches += 1
    y = dft.icfft(_apply_window(K, dft.cfft(gz, n), w, minimum_phase_backward), n)
    gH = torch.empty_like(H)
    K.mag_bwd_kernel[_grid(total)](torch.view_as_real(H), g_mag, torch.view_as_real(y),
                                   torch.view_as_real(gH), total, BLOCK=_BLOCK, num_warps=4)
    minimum_phase_backward.launches += 1
    return _real_crop(K, torch.fft.ifft(gH, n=n, dim=-1, norm="forward"), L,
                      minimum_phase_backward)


class _MinPhaseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        out, H, z = _launch_forward(h)
        ctx.save_for_backward(H, z)
        return out

    @staticmethod
    def backward(ctx, g):
        H, z = ctx.saved_tensors
        return minimum_phase_backward(H, z, g).reshape(g.shape)


def minimum_phase_version(h: torch.Tensor) -> torch.Tensor:
    """Same magnitude spectrum as ``h`` with minimum phase (cepstral method
    with 2x zero padding); ``h`` is real (..., L), the result too."""
    if h.device.type == "cpu":
        return minimum_phase_plain(h)
    return _MinPhaseFn.apply(h)


minimum_phase_version.launches = 0
minimum_phase_backward.launches = 0
