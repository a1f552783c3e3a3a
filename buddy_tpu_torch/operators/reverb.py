"""The operators' STFT convention (``OperatorSTFT`` of
``buddy_tpu/operators/reverb.py``): n_fft=NFFT with a hann(win_length)
window right-padded to n_fft, centre padding with zeros, hop=hop; the
"apply" pair adds the win_length right-pad, the window-energy normalisation
and the half-window delay crop.  ``RIROperator`` is the informed operator:
FFT convolution with a known time-domain RIR, batch-first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.operators.shared import Operator
from buddy_tpu_torch.ops.fftconv import fast_apply_rir
from buddy_tpu_torch.ops.stft import STFT


class OperatorSTFT:
    def __init__(self, op_hp, sample_rate: int = 16000, device=None):
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


class RIROperator(Operator):
    """Time-domain convolution with a known RIR.  ``params`` is the RIR, (M,)
    or one per utterance (B, M)."""

    def __init__(self, op_hp, time_kernel_size: int = 10, sample_rate: int = 16000,
                 device=None):
        self.time_kernel_size = time_kernel_size
        self.params = None
        self.device = resolve_device(device)
        self.op_stft = OperatorSTFT(op_hp, sample_rate, self.device)
        self.sample_rate = sample_rate

    def degradation(self, x: torch.Tensor, rm_delay: bool = False,
                    filt: torch.Tensor | None = None, **_ignored) -> torch.Tensor:
        """FFT-convolve (B, n) or (n,) waveforms with the RIR; ``filt``
        overrides the stored one."""
        if filt is None:
            if self.params is None:
                raise ValueError("filter is None")
            filt = self.params
        return fast_apply_rir(x, filt, rm_delay=rm_delay)

    def update_params(self, k, **_ignored) -> None:
        self.params = torch.as_tensor(k, dtype=torch.float32, device=self.device)

    def get_time_RIR(self) -> torch.Tensor:
        return self.params

    def apply_stft(self, x):
        return self.op_stft.apply_stft(x)

    def apply_istft(self, X, length=None):
        return self.op_stft.apply_istft(X, length)
