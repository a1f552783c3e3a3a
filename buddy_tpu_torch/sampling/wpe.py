"""Weighted Prediction Error (WPE) dereverberation (``buddy_tpu/sampling/wpe.py``).

Single-channel iterative MCLP (statistics_mode='full') on a hann 512/128
STFT, batched over utterances and frequency bins: each iteration builds the
power-weighted (taps x taps) correlation R and vector P per bin and solves
(R + load I) G = P with one batched complex ``torch.linalg.solve``.  The
diagonal loading is trace-scaled; the power weighting is a division, never a
reciprocal multiply (complex64 WPE is ill-conditioned).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops.stft import STFT, hann_window


def _build_y_tilde(Y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """Ytilde[..., k, t] = Y[..., t - delay - k], zero for t < delay + k:
    (..., T) -> (..., taps, T)."""
    T = Y.shape[-1]
    return torch.stack([F.pad(Y, (delay + k, 0))[..., :T] for k in range(taps)], dim=-2)


def wpe_bins(Y: torch.Tensor, taps: int, delay: int, iterations: int,
             eps: float = 1e-10, diag_rel: float = 1e-6) -> torch.Tensor:
    """WPE of independent bins: Y (..., T) complex -> dereverberated (..., T)."""
    Yt = _build_y_tilde(Y, taps, delay)                            # (..., taps, T)
    eye = torch.eye(taps, dtype=Y.dtype, device=Y.device)
    X = Y
    for _ in range(iterations):
        power = torch.clamp(torch.abs(X) ** 2, min=eps)            # (..., T)
        Yt_norm = Yt / power[..., None, :]
        R = Yt_norm @ Yt.conj().transpose(-1, -2)                  # (..., taps, taps)
        P = (Yt_norm @ Y.conj()[..., None])[..., 0]                # (..., taps)
        trace = torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1)
        load = diag_rel * (trace / taps) + eps
        G = torch.linalg.solve(R + load[..., None, None] * eye, P)
        X = Y - (G.conj()[..., None, :] @ Yt)[..., 0, :]
    return X


def wpe_dereverb(y: torch.Tensor, *, taps: int = 50, delay: int = 2, iterations: int = 5,
                 size: int = 512, shift: int = 128) -> torch.Tensor:
    """Dereverberate a (..., T) waveform with single-channel WPE."""
    T = y.shape[-1]
    geom = STFT(size, shift, hann_window(size), pad_mode="constant", device=y.device)
    X = wpe_bins(geom.stft(y), taps, delay, iterations)
    return geom.istft(X, length=T)
