"""Hilbert transform and minimum-phase RIR projection
(``buddy_tpu/ops/minphase.py``), on ``torch.fft``.

The blind operator's consistency projection runs every estimated RIR through
``minimum_phase_version`` in each inner update, so the chain is
differentiable.  On the card it runs as cuFFT plus elementwise PyTorch; a
fused kernel for the log/window/exp chain is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from buddy_tpu_torch.ops import dft


def _heaviside_window(n: int) -> np.ndarray:
    """Flipped 2*heaviside(linspace(-1, 1, n)); for odd n the zero crossing
    contributes heaviside(0)=1, i.e. the value 2 at the centre."""
    x = np.linspace(-1.0, 1.0, n)
    return (2.0 * np.heaviside(x, 1.0))[::-1].copy()


def hilbert(h: torch.Tensor) -> torch.Tensor:
    """FFT-window Hilbert transform along the last axis."""
    n = h.shape[-1]
    real_dtype = h.real.dtype if h.is_complex() else h.dtype
    window = torch.as_tensor(_heaviside_window(n), dtype=real_dtype, device=h.device)
    return dft.icfft(window * dft.cfft(h, n), n)


def minimum_phase_version(h: torch.Tensor) -> torch.Tensor:
    """Same magnitude spectrum as ``h`` with minimum phase (cepstral method
    with 2x zero padding); ``h`` is real (..., L), the result too."""
    t_orig = h.shape[-1]
    n = 2 * t_orig
    H = dft.cfft(h, n)
    mag = torch.abs(H)
    log_mag = torch.log(mag + 1e-8)
    min_phase = -torch.imag(hilbert(log_mag))
    rec = dft.icfft(mag * torch.exp(1j * min_phase), n).real
    return rec[..., :t_orig]
