"""BUDDy's blind subband reverberation operator (sp-uhh/buddy
``testing/operators/subband_filtering.py``) and its compressed-STFT loss,
in plain float32 PyTorch.

The filter H (B, F, Nf) is the per-EQ-band multi-exponential magnitude
decay, linearly interpolated in the log domain across the EQ breakpoints,
OLA- and direct-path-corrected, times exp(i phases); it is projected
through an ISTFT, the minimum-phase version of the RIR (real cepstrum),
the fixed direct path and an STFT. Filtering is a complex FIR along the
STFT frames of each bin, done here by FFT convolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.signal import Stft

EPS_COMPRESS = 1e-8


def compress(X: torch.Tensor, c: float) -> torch.Tensor:
    """X |X|^(c-1) with |X| + 1e-8 under the power; eps^c where X == 0."""
    zero = (X.real == 0) & (X.imag == 0)
    safe = torch.where(zero, torch.ones_like(X), X)
    mag = torch.abs(safe)
    return torch.where(zero, torch.full_like(X, EPS_COMPRESS ** c),
                       safe * ((mag + EPS_COMPRESS) ** c / mag))


class CompressedLoss:
    """l2_comp_stft_{sum,mean,summean}: weight / divisor * sum |C(A) - C(B)|^2
    per utterance, over the operator's STFT of waveforms."""

    DIVISOR = {"l2_comp_stft_sum": lambda f, t: 1.0, "l2_comp_stft_mean": lambda f, t: f * t,
               "l2_comp_stft_summean": lambda f, t: float(t)}

    def __init__(self, cfg, op):
        if cfg["name"] not in self.DIVISOR or cfg.get("frequency_weighting", "none") != "none":
            raise NotImplementedError(cfg["name"])
        self.name, self.weight = cfg["name"], float(cfg["weight"])
        self.c, self.op = float(cfg["compression_factor"]), op

    def prepare(self, x):
        return compress(self.op.apply_stft(x), self.c)

    def __call__(self, a_prepared, x_hat):
        X = self.op.apply_stft(x_hat)
        d = a_prepared - compress(X, self.c)
        scale = self.weight / self.DIVISOR[self.name](*X.shape[-2:])
        return scale * (d.real ** 2 + d.imag ** 2).reshape(X.shape[0], -1).sum(-1)


def minimum_phase(h: torch.Tensor) -> torch.Tensor:
    """The minimum-phase version of each row of h (..., L): magnitude of
    the 2L-point spectrum, phase from the Hilbert transform of its log."""
    L = h.shape[-1]
    n = 2 * L
    H = torch.fft.fft(h, n=n)
    mag = torch.abs(H)
    x = np.linspace(-1.0, 1.0, n)
    win = torch.as_tensor((2.0 * np.heaviside(x, 1.0))[::-1].copy(), dtype=h.dtype,
                          device=h.device)
    analytic = torch.fft.ifft(win * torch.fft.fft(torch.log(mag + 1e-8), n=n), n=n)
    phase = -torch.imag(analytic)
    return torch.fft.ifft(mag * torch.exp(1j * phase), n=n).real[..., :L]


class BlindSubband:
    def __init__(self, op_hp, sample_rate: int, device):
        hp = op_hp
        self.n_fft, self.win, self.hop = int(hp["NFFT"]), int(hp["win_length"]), int(hp["hop"])
        self.Nf = int(hp["Nf"])
        self.length_rir = self.hop * self.Nf
        self.pre = self.win // self.hop // 2 - 1
        self.sample_rate = sample_rate
        k = np.arange(self.win)
        w = (0.5 * (1.0 - np.cos(2.0 * np.pi * k / self.win))).astype(np.float32)
        self.window_padded = np.pad(w, (0, self.n_fft - self.win))
        self.wes = float(np.float32(np.sqrt(np.sum(self.window_padded.astype(np.float64) ** 2))))
        self.geom = Stft(self.n_fft, self.hop, self.window_padded, "constant", device)
        self.device = device
        self.hp = hp
        self.Amin, self.Amax = float(hp["Amin"]), float(hp["Amax"])
        self.fix_extremes = bool(hp["fix_EQ_extremes"])
        eq = np.asarray(hp["EQ_freqs"], np.float32)
        self.num_bands = len(eq) - (2 if self.fix_extremes else 0)
        fr = sample_rate / self.hop
        self.max_decay = 6.908 / (float(hp["T60min"]) * fr)
        self.min_decay = 6.908 / (float(hp["T60max"]) * fr)
        freqs = np.fft.rfftfreq(self.n_fft, d=1.0 / sample_rate).astype(np.float32)
        j = np.clip(np.searchsorted(eq, freqs) - 1, 0, len(eq) - 2)
        t = np.clip((freqs - eq[j]) / (eq[j + 1] - eq[j]), 0.0, 1.0).astype(np.float32)
        M = np.zeros((len(freqs), len(eq)), np.float32)
        M[np.arange(len(freqs)), j] = 1.0 - t
        M[np.arange(len(freqs)), j + 1] = t
        self.interp = torch.as_tensor(M, device=device)
        self.ola = torch.as_tensor(self._ola_factors(w), device=device)
        self.dpc = torch.as_tensor(self._direct_path(), device=device)
        if not (hp.get("minimum_phase", True) and hp.get("fix_direct_path", True)
                and hp.get("clamp_decay", True) and not hp.get("strictly_decreasing_decay", False)
                and hp.get("enforce_long_decay_in_second_exponential", True)):
            raise NotImplementedError("operator options")

    def _ola_factors(self, w):
        K = int(self.win / self.hop - 1)
        f = np.ones(self.Nf, np.float32)
        for k in range(K):
            f[k] = w[int((K - k) * self.hop):].sum() / w.sum()
        return f

    def _direct_path(self):
        h = np.zeros(self.length_rir, np.float32)
        h[0] = self.win / (self.hop * 2)
        p = self.n_fft // 2
        xp = np.pad(h, (p, p))
        n_frames = 1 + (len(xp) - self.n_fft) // self.hop
        idx = np.arange(n_frames)[:, None] * self.hop + np.arange(self.n_fft)[None, :]
        H = np.fft.rfft(xp[idx] * self.window_padded, axis=-1).T
        return np.abs(H[:, 1:]).astype(np.float32)

    # --- transforms ---------------------------------------------------
    def apply_stft(self, x):
        return self.geom.stft(F.pad(x, (0, self.win))) / self.wes

    def apply_istft(self, X, length):
        return self.geom.istft(X * self.wes, length + self.win // 2)[..., self.win // 2:]

    def filtering(self, X, H):
        """Y[b, f, t] = sum_j H[b, f, j] X[b, f, t + pre - j]."""
        T, Nf = X.shape[-1], H.shape[-1]
        n = T + Nf
        return torch.fft.ifft(torch.fft.fft(H, n=n) * torch.fft.fft(X, n=n))[..., self.pre:
                                                                           self.pre + T]

    def degradation(self, x=None, H=None, X=None, length=None):
        if X is None:
            X, length = self.apply_stft(x), x.shape[-1]
        return self.apply_istft(self.filtering(X, H), length)

    def time_rir(self, H):
        imp = torch.zeros((1, self.length_rir + 1024), device=H.device)
        imp[0, 0] = 1.0
        return self.degradation(H=H, X=self.apply_stft(imp), length=self.length_rir + 1024)

    # --- the filter ------------------------------------------------------
    def magnitude(self, decay, weights):
        n = torch.arange(self.Nf, dtype=torch.float32, device=decay.device)
        env = (weights[..., None] * torch.exp(decay)[..., None] ** (-n)).sum(-3)
        full = F.pad(env, (0, 0, 1, 1)) if self.fix_extremes else env
        A = torch.exp(self.interp @ torch.log(full + 1e-6)) + 1e-6
        return A * self.ola + self.dpc

    def cons(self, X):
        L = X.shape[-1]
        h = self.geom.istft(F.pad(X, (1, 1)), self.length_rir)
        h = minimum_phase(F.pad(h, (0, self.hop)))
        h = torch.cat([torch.full_like(h[..., :1], self.win / (self.hop * 2)), h[..., 1:]], -1)
        return self.geom.stft(h)[..., 1:-1][..., :L]

    def compute_H(self, params, phases=None):
        ph = params["phases"] if phases is None else phases
        return self.cons(self.magnitude(params["decay"], params["weights"]) * torch.exp(1j * ph))

    def reset(self, noise):
        """Fresh state for rows of phase noise (B, hop * Nf)."""
        hp = self.hp["init_params"]
        T60 = np.asarray([[t] * self.num_bands for t in hp["T60_breakpoints"]])
        wts = np.asarray([[w] * self.num_bands for w in hp["multiexp_weighting"]], np.float32)
        decay = (6.908 / (T60 * (self.sample_rate / self.hop))).astype(np.float32)
        base = {"decay": torch.as_tensor(decay, device=noise.device),
                "weights": torch.as_tensor(wts, device=noise.device)}
        phases = torch.angle((self.geom.stft(noise) / self.wes)[..., 1:])
        with torch.no_grad():
            H = self.compute_H({k: v.expand((noise.shape[0],) + v.shape) for k, v in base.items()},
                               phases=phases)
        params = {k: v.expand((noise.shape[0],) + v.shape).clone() for k, v in base.items()}
        params["phases"] = torch.angle(H)
        return params, H

    def project(self, params):
        decay, weights = params["decay"], params["weights"]
        first = torch.clamp(decay[..., :1, :], self.min_decay, self.max_decay)
        rest = torch.minimum(torch.clamp(decay[..., 1:, :], min=self.min_decay),
                             torch.clamp(first / 1.01, max=self.max_decay))
        lo, hi = 10.0 ** (self.Amin / 20.0), 10.0 ** (self.Amax / 20.0)
        w_first = torch.clamp(weights[..., :1, :], lo, hi)
        w_rest = torch.minimum(torch.clamp(weights[..., 1:, :], min=lo), w_first)
        return dict(params, decay=torch.cat([first, rest], -2),
                    weights=torch.cat([w_first, w_rest], -2))


class WaveformOperator:
    """The informed operator: FFT convolution of waveforms with their RIRs,
    cropped to the signal, and the operators' STFT convention for the
    loss."""

    def __init__(self, op_hp, device):
        self.n_fft, self.win, self.hop = int(op_hp["NFFT"]), int(op_hp["win_length"]), \
            int(op_hp["hop"])
        k = np.arange(self.win)
        w = np.pad((0.5 * (1.0 - np.cos(2.0 * np.pi * k / self.win))).astype(np.float32),
                   (0, self.n_fft - self.win))
        self.wes = float(np.float32(np.sqrt(np.sum(w.astype(np.float64) ** 2))))
        self.geom = Stft(self.n_fft, self.hop, w, "constant", device)

    def apply_stft(self, x):
        return self.geom.stft(F.pad(x, (0, self.win))) / self.wes

    @staticmethod
    def degradation(x, rir):
        n = x.shape[-1] + rir.shape[-1]
        return torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(rir, n=n), n=n)[
            ..., :x.shape[-1]]
