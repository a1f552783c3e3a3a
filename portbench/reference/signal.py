"""STFT and ISTFT with torch.stft / torch.istft semantics, written out.

Centre padding of n_fft // 2 on both sides (``reflect`` or ``constant``),
onesided, not normalized; the ISTFT overlap-adds the windowed inverse real
FFTs, divides by the window-squared envelope where it exceeds 1e-11 (by 1
elsewhere), trims the centre padding and crops or zero-pads to ``length``.
The window is given at full n_fft length.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann(n: int) -> np.ndarray:
    """Periodic Hann window of n samples, float32 (computed in float64)."""
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


class Stft:
    def __init__(self, n_fft: int, hop: int, window: np.ndarray, pad_mode: str, device):
        self.n_fft, self.hop, self.pad_mode = n_fft, hop, pad_mode
        self.window = torch.as_tensor(np.asarray(window, np.float32), device=device)
        self._wsq = np.asarray(window, np.float64) ** 2
        self._env = {}

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L) real -> (..., n_fft // 2 + 1, frames) complex64."""
        lead = x.shape[:-1]
        p = self.n_fft // 2
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode=self.pad_mode)[:, 0]
        frames = x.unfold(-1, self.n_fft, self.hop) * self.window
        spec = torch.fft.rfft(frames, dim=-1).transpose(-1, -2)
        return spec.reshape(lead + spec.shape[-2:])

    def _envelope(self, n_frames: int, device) -> torch.Tensor:
        env = self._env.get(n_frames)
        if env is None:
            e = np.zeros(self.n_fft + self.hop * (n_frames - 1), np.float64)
            for t in range(n_frames):
                e[t * self.hop:t * self.hop + self.n_fft] += self._wsq
            env = torch.as_tensor(np.where(e > 1e-11, e, 1.0).astype(np.float32), device=device)
            self._env[n_frames] = env
        return env

    def istft(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        """(..., F, frames) complex -> (..., length) real."""
        lead, n_frames = spec.shape[:-2], spec.shape[-1]
        spec = spec.reshape((-1,) + spec.shape[-2:])
        frames = torch.fft.irfft(spec.transpose(-1, -2), n=self.n_fft, dim=-1) * self.window
        ola_len = self.n_fft + self.hop * (n_frames - 1)
        y = F.fold(frames.transpose(1, 2), output_size=(1, ola_len), kernel_size=(1, self.n_fft),
                   stride=(1, self.hop))[:, 0, 0]
        y = y / self._envelope(n_frames, spec.device)
        start = self.n_fft // 2
        if start + length > ola_len:
            y = F.pad(y, (0, start + length - ola_len))
        y = y[:, start:start + length]
        return y.reshape(lead + y.shape[-1:])
