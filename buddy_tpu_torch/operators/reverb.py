"""The operators' STFT convention (``OperatorSTFT`` of
``buddy_tpu/operators/reverb.py``): n_fft=NFFT with a hann(win_length)
window right-padded to n_fft, centre padding with zeros, hop=hop; the
"apply" pair adds the win_length right-pad, the window-energy normalisation
and the half-window delay crop.  ``RIROperator`` (informed, time-domain RIR)
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops.stft import STFT


class OperatorSTFT:
    def __init__(self, op_hp, sample_rate: int = 16000, device="cpu"):
        self.sample_rate = sample_rate
        self.n_fft = int(op_hp["NFFT"])
        self.win_length = int(op_hp["win_length"])
        self.hop_length = int(op_hp["hop"])
        if self.n_fft < self.win_length:
            raise ValueError("n_fft must be at least win_length")
        if op_hp.get("window", "hann") != "hann":
            raise NotImplementedError(f"window type {op_hp['window']} not implemented")
        if self.hop_length > self.win_length / 4:
            raise ValueError("hop length must be at most win_length/4 (temporal aliasing)")
        k = np.arange(self.win_length)
        w = (0.5 * (1.0 - np.cos(2.0 * np.pi * k / self.win_length))).astype(np.float32)
        self.window = w
        self.window_padded = np.pad(w, (0, self.n_fft - self.win_length))
        self.win_energy_sqrt = float(np.float32(
            np.sqrt(np.sum(self.window_padded.astype(np.float64) ** 2))))
        self.freqs = np.fft.rfftfreq(self.n_fft, d=1.0 / sample_rate).astype(np.float32)
        self.geometry = STFT(self.n_fft, self.hop_length, self.window_padded,
                             pad_mode="constant", device=device)

    def stft(self, x: torch.Tensor) -> torch.Tensor:
        return self.geometry.stft(x)

    def istft(self, X: torch.Tensor, length: int | None = None) -> torch.Tensor:
        return self.geometry.istft(X, length)

    def apply_stft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n) or (n,) waveform -> (B, F, frames): right-pad by win_length,
        STFT, divide by the window energy."""
        if x.dim() == 1:
            x = x[None, :]
        return self.stft(F.pad(x, (0, self.win_length))) / self.win_energy_sqrt

    def apply_istft(self, X: torch.Tensor, length: int) -> torch.Tensor:
        x = self.istft(X * self.win_energy_sqrt, length=length + self.win_length // 2)
        return x[..., self.win_length // 2:]
