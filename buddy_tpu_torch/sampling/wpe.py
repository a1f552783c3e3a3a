"""Weighted Prediction Error (WPE) dereverberation (``buddy_tpu/sampling/wpe.py``).

Single-channel iterative MCLP (statistics_mode='full') on a hann 512/128
STFT, batched over utterances and frequency bins: each iteration builds the
power-weighted (taps x taps) correlation R and vector P per bin and solves
(R + load I) G = P with kernel K7 (``ops/wpe_solve.py``), which also forms
the trace-scaled diagonal loading.  The power weighting is a division, never
a reciprocal multiply (complex64 WPE is ill-conditioned).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops.stft import STFT, hann_window
from buddy_tpu_torch.ops.wpe_solve import wpe_solve


def _build_y_tilde(Y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """Ytilde[..., k, t] = Y[..., t - delay - k], zero for t < delay + k:
    (..., T) -> (..., taps, T)."""
    T = Y.shape[-1]
    return torch.stack([F.pad(Y, (delay + k, 0))[..., :T] for k in range(taps)], dim=-2)


def wpe_bins(Y: torch.Tensor, taps: int, delay: int, iterations: int,
             eps: float = 1e-10, diag_rel: float = 1e-6) -> torch.Tensor:
    """WPE of independent bins: Y (..., T) complex -> dereverberated (..., T)."""
    Yt = _build_y_tilde(Y, taps, delay)                            # (..., taps, T)
    X = Y
    for _ in range(iterations):
        power = torch.clamp(torch.abs(X) ** 2, min=eps)            # (..., T)
        Yt_norm = Yt / power[..., None, :]
        R = Yt_norm @ Yt.conj().transpose(-1, -2)                  # (..., taps, taps)
        P = (Yt_norm @ Y.conj()[..., None])[..., 0]                # (..., taps)
        G = wpe_solve(R, P, diag_rel, eps)
        X = Y - (G.conj()[..., None, :] @ Yt)[..., 0, :]
    return X


def wpe_dereverb(y: torch.Tensor, *, taps: int = 50, delay: int = 2, iterations: int = 5,
                 size: int = 512, shift: int = 128) -> torch.Tensor:
    """Dereverberate a (..., T) waveform with single-channel WPE."""
    T = y.shape[-1]
    geom = STFT(size, shift, hann_window(size), pad_mode="constant", device=y.device)
    X = wpe_bins(geom.stft(y), taps, delay, iterations)
    return geom.istft(X, length=T)
