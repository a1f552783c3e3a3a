"""STFT-domain subband reverberation operators (``buddy_tpu/operators/subband.py``).

``SubbandFiltering`` (informed): a complex FIR along the STFT frames per
frequency bin, filter H (B, F, Nf) — kernel K3 (``ops/subband_conv.py``),
with the frame-axis spectrum of a constant X hoisted by ``frame_fft``.

``BlindSubbandFiltering``: the filter is parameterised by per-EQ-band
multi-exponential magnitude decays plus per-(bin, frame) phases
``{"decay", "weights", "phases"}``; ``compute_H`` designs the magnitude and
applies the phases (kernel K6, ``ops/filter_design.py``) and projects
through ``cons`` (ISTFT -> minimum phase, kernel K5 -> fixed direct path ->
STFT).  Tensors are batch-first: decay and weights
(B, E, bands), phases and H (B, F, Nf), one row per utterance.  Every
function also takes unbatched parameters.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.operators.reverb import OperatorSTFT
from buddy_tpu_torch.operators.shared import Operator
from buddy_tpu_torch.ops.filter_design import (FilterDesignGeometry, design_plain,
                                               filter_design)
from buddy_tpu_torch.ops.minphase import minimum_phase_version
from buddy_tpu_torch.ops.subband_conv import frame_spectrum, subband_conv


class SubbandFiltering(Operator):
    """Informed subband filter operator."""

    def __init__(self, op_hp, sample_rate: int = 16000, device=None):
        self.op_hp = op_hp
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.op_stft = OperatorSTFT(op_hp, sample_rate, self.device)
        self.n_fft = self.op_stft.n_fft
        self.win_length = self.op_stft.win_length
        self.hop_length = self.op_stft.hop_length
        self.window = self.op_stft.window
        self.window_padded = self.op_stft.window_padded
        self.freqs = self.op_stft.freqs
        self.Nf = int(op_hp["Nf"])
        self.length_rir = self.hop_length * self.Nf
        # the RIR centring offset under the hann window: 1 for 512/128
        self.pre = self.win_length // self.hop_length // 2 - 1
        self.H = None
        x = torch.zeros((1, self.length_rir + 1024), device=self.device)
        x[0, 0] = 1.0
        self._X_imp = self.apply_stft(x)          # impulse spectrum for get_time_RIR
        self._X_imp_f = None                      # its frame_fft, at first use

    def stft(self, x):
        return self.op_stft.stft(x)

    def istft(self, X, length=None):
        return self.op_stft.istft(X, length)

    def apply_stft(self, x):
        return self.op_stft.apply_stft(x)

    def apply_istft(self, X, length=None):
        return self.op_stft.apply_istft(X, length)

    def subband_filtering(self, X: torch.Tensor, H: torch.Tensor,
                          Xf: torch.Tensor | None = None) -> torch.Tensor:
        """Y[b, f, t] = sum_j H[b, f, j] X[b, f, t + pre - j] (kernel K3);
        ``Xf`` is ``frame_fft(X)`` where the caller hoisted it."""
        squeeze = X.dim() == 2 and H.dim() == 2
        X = X[None] if X.dim() == 2 else X
        H = H[None] if H.dim() == 2 else H
        Xf = Xf[None] if Xf is not None and Xf.dim() == 2 else Xf
        Y = subband_conv(X, H, self.pre, Xf)
        return Y[0] if squeeze else Y

    def frame_fft(self, X: torch.Tensor) -> torch.Tensor:
        """Frame-axis spectrum of a spectrogram at K3's transform length, so
        that callers hoist the transform of a constant X out of the blind
        inner loop (10 re-uses per diffusion step).  Not differentiable."""
        Xb = X[None] if X.dim() == 2 else X
        Xf = frame_spectrum(Xb.detach(), self.Nf)
        return Xf[0] if X.dim() == 2 else Xf

    def degradation(self, x=None, mode: str = "waveform", H=None, detach_operator=False,
                    X=None, Xf=None, length: int | None = None):
        """Apply the subband reverb model to a (B, n) or (n,) waveform, or to
        a precomputed observation STFT ``X`` with its ``length`` (and its
        ``frame_fft`` ``Xf``)."""
        if X is None:
            squeeze = x.dim() == 1
            length = x.shape[-1]
            X = self.apply_stft(x)
        else:
            squeeze = False
            if length is None:
                raise ValueError("length required with precomputed X")
        if H is None:
            if self.H is None:
                raise ValueError("filter is not initialized")
            H = self.H
        if detach_operator:
            H = H.detach()
        Y = self.subband_filtering(X, H, Xf)
        if mode == "waveform":
            y = self.apply_istft(Y, length=length)
            return y[0] if squeeze else y
        if mode == "STFT":
            return Y
        raise ValueError(mode)

    def get_time_RIR(self, H=None) -> torch.Tensor:
        """Excite the operator with an impulse: (B, F, Nf) -> (B, L) or
        (F, Nf) -> (L,), L = hop*Nf + 1024."""
        H = self.H if H is None else H
        if self._X_imp_f is None:
            self._X_imp_f = self.frame_fft(self._X_imp)
        y = self.degradation(None, H=H if H.dim() == 3 else H[None], X=self._X_imp,
                             Xf=self._X_imp_f, length=self.length_rir + 1024)
        return y if H.dim() == 3 else y[0]

    def rir_to_H(self, rir: torch.Tensor) -> torch.Tensor:
        """Known time-domain RIR -> subband filter: scale 8/(win/hop), drop
        frame 0, pad or truncate to Nf frames."""
        H = self.stft(rir) * (8.0 / (self.win_length / self.hop_length))
        H = H[..., 1:]
        if self.Nf > H.shape[-1]:
            return F.pad(H, (0, self.Nf - H.shape[-1]))
        return H[..., :self.Nf]

    def update_H(self, rir=None, H=None) -> None:
        if rir is not None:
            self.H = self.rir_to_H(torch.as_tensor(rir, device=self.device))
        elif H is not None:
            self.H = torch.as_tensor(H, device=self.device)
        else:
            raise ValueError("Either rir or H must be specified (informed scenario)")

    def update_params(self, *args, **kwargs):
        return self.update_H(*args, **kwargs)


class BlindSubbandFiltering(SubbandFiltering):
    """Blind subband operator with the exponential-decay RIR prior."""

    def __init__(self, op_hp, sample_rate: int = 16000, device=None):
        super().__init__(op_hp, sample_rate, device)
        hp = op_hp
        self.Amin = float(hp["Amin"])
        self.Amax = float(hp["Amax"])
        self.EQ_freqs = np.asarray(hp["EQ_freqs"], np.float32)
        self.fix_EQ_extremes = bool(hp["fix_EQ_extremes"])
        self.num_bands = len(hp["EQ_freqs"]) - (2 if self.fix_EQ_extremes else 0)
        self.minimum_phase = bool(hp.get("minimum_phase", True))
        self.fix_direct_path = bool(hp.get("fix_direct_path", True))
        self.clamp_decay = bool(hp.get("clamp_decay", True))
        self.strictly_decreasing_decay = bool(hp.get("strictly_decreasing_decay", False))
        self.enforce_long_decay_in_second_exponential = bool(
            hp.get("enforce_long_decay_in_second_exponential", True))
        fr = self.sample_rate / self.hop_length
        self.max_decay = 6.908 / (float(hp["T60min"]) * fr)
        self.min_decay = 6.908 / (float(hp["T60max"]) * fr)
        dpc, ola = self._compute_direct_path_mag_correction(), self._compute_ola_factors()
        # K6's constants: compute_H always corrects the OLA; the direct-path
        # correction is zero where the direct path is not fixed
        self._design_geometry = FilterDesignGeometry(
            np.asarray(self.freqs, np.float32), self.EQ_freqs, ola,
            dpc if self.fix_direct_path else np.zeros_like(dpc), self.fix_EQ_extremes,
            self.device)
        self.params = None

    # --- constants -----------------------------------------------------
    def _init_decay_weights(self):
        hp = self.op_hp
        if hp["init_single_value"]:
            T60 = np.asarray([[t] * self.num_bands for t in hp["init_params"]["T60_breakpoints"]])
            wts = np.asarray([[w] * self.num_bands
                              for w in hp["init_params"]["multiexp_weighting"]])
        else:
            T60 = np.asarray(hp["init_params"]["T60_breakpoints"])
            wts = np.asarray(hp["init_params"]["multiexp_weighting"])
        decay = 6.908 / (T60 * (self.sample_rate / self.hop_length))
        return decay.astype(np.float32), wts.astype(np.float32)

    def _compute_direct_path_mag_correction(self) -> np.ndarray:
        """|STFT| of a scaled unit impulse, frames 1.. (numpy constant)."""
        h = np.zeros((self.hop_length * self.Nf,), np.float32)
        h[0] = self.win_length / (self.hop_length * 2)
        pad = self.n_fft // 2
        xp = np.pad(h, (pad, pad))
        n_frames = 1 + (len(xp) - self.n_fft) // self.hop_length
        idx = (np.arange(n_frames)[:, None] * self.hop_length + np.arange(self.n_fft)[None, :])
        H = np.fft.rfft(xp[idx] * self.window_padded, axis=-1).T
        return np.abs(H[:, 1:]).astype(np.float32)

    def _compute_ola_factors(self) -> np.ndarray:
        """First-K-frame OLA correction factors."""
        K = int(self.win_length / self.hop_length - 1)
        w = np.asarray(self.window)
        factors = np.ones(self.Nf, dtype=np.float32)
        for k in range(K):
            factors[k] = w[int((K - k) * self.hop_length):].sum() / w.sum()
        return factors

    # --- filter design ---------------------------------------------------
    def design_filter(self, params, correct_OLA: bool = True) -> torch.Tensor:
        """The magnitude A (..., F, Nf) alone: multi-exponential decays -> log
        -> linear interpolation across the EQ breakpoints -> exp, the OLA
        correction (unless ``correct_OLA`` is False) and the direct-path
        correction (the plain version of K6 without its phasor)."""
        return design_plain(params["decay"], params["weights"], self._design_geometry, self.Nf,
                            correct_ola=correct_OLA)

    def cons(self, X: torch.Tensor, length: int) -> torch.Tensor:
        """Consistency projection: pad frames -> ISTFT -> minimum phase ->
        fix direct path -> STFT -> crop."""
        L = X.shape[-1]
        h = self.istft(F.pad(X, (1, 1)), length=length)
        h = F.pad(h, (0, self.hop_length))
        if self.minimum_phase:
            h = minimum_phase_version(h)
        if self.fix_direct_path:
            h0 = torch.full_like(h[..., :1], self.win_length / (self.hop_length * 2))
            h = torch.cat([h0, h[..., 1:]], dim=-1)
        return self.stft(h)[..., 1:-1][..., :L]

    def compute_H(self, params, phases=None) -> torch.Tensor:
        """H = design_filter * exp(i*phases) (kernel K6), then cons()."""
        ph = params["phases"] if phases is None else phases
        decay, weights = params["decay"], params["weights"]
        if ph.dim() == 2:
            H = filter_design(decay[None], weights[None], ph[None], self._design_geometry)[0]
        else:
            expand = lambda t: t.expand((ph.shape[0],) + t.shape[-2:])
            H = filter_design(expand(decay), expand(weights), ph, self._design_geometry)
        return self.cons(H, length=self.length_rir)

    def get_noise_phases(self, noise: torch.Tensor) -> torch.Tensor:
        """Phases of the STFT of white noise (..., hop*Nf): "random but
        coherent" initialisation."""
        N = self.stft(noise) / self.op_stft.win_energy_sqrt
        return torch.angle(N[..., 1:])

    def noise_coherent_init(self, noise) -> None:
        """The "random but coherent" phases for the decays and weights of
        ``self.params``: design A, take the phases of white noise's STFT,
        project A e^{i phases} through ``cons``, and keep the projected H and
        its phases on ``self.H`` and ``self.params``.  ``noise`` is the white
        noise (hop*Nf,) or a ``torch.Generator`` to draw it from."""
        if isinstance(noise, torch.Generator):
            noise = torch.randn((self.length_rir,), generator=noise, device=noise.device)
        with torch.no_grad():
            A = self.design_filter(self.params)
            H = A * torch.exp(1j * self.get_noise_phases(noise.to(self.device)))
            H = self.cons(H, length=self.length_rir)
        self.params = dict(self.params, phases=torch.angle(H))
        self.H = H

    def update_H(self, rir=None, H=None, use_noise: bool = False, noise=None,
                 phases=None) -> None:
        """A known RIR or filter (the informed operator's ``update_H``); else,
        with ``use_noise``, ``noise_coherent_init(noise)`` (a generator
        seeded 1 when no noise is given); else H from ``self.params``, its
        phases replaced by ``phases`` where given."""
        if rir is not None or H is not None:
            super().update_H(rir=rir, H=H)
            return
        if use_noise:
            self.noise_coherent_init(noise if noise is not None
                                     else torch.Generator().manual_seed(1))
            return
        if phases is not None:
            if not isinstance(phases, torch.Tensor):
                phases = torch.from_numpy(np.array(phases, np.float32))
            self.params = dict(self.params, phases=phases.to(self.device, torch.float32))
        with torch.no_grad():
            self.H = self.compute_H(self.params)

    def reset_batched(self, batch: int, generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None):
        """Fresh per-utterance state for a batch: params (decay, weights
        (B, E, bands), phases (B, F, Nf)) and H (B, F, Nf).  The phase noise
        (B, hop*Nf) is drawn from ``generator`` unless given as ``noise``."""
        if noise is None:
            noise = torch.randn((batch, self.length_rir), generator=generator,
                                device=self.device)
        decay, wts = self._init_decay_weights()
        base = {"decay": torch.as_tensor(decay, device=self.device),
                "weights": torch.as_tensor(wts, device=self.device)}
        with torch.no_grad():
            H = self.compute_H(base, phases=self.get_noise_phases(noise.to(self.device)))
        params = {k: v.expand((batch,) + v.shape).clone() for k, v in base.items()}
        params["phases"] = torch.angle(H)
        return params, H

    def reset(self, noise: torch.Tensor | None = None) -> None:
        """Fresh single-utterance state on ``self.params`` (decay, weights
        (E, bands), phases (F, Nf)) and ``self.H`` (F, Nf), from the phase
        noise (hop*Nf,) or a fresh draw."""
        params, H = self.reset_batched(1, noise=None if noise is None else noise.reshape(1, -1))
        self.params, self.H = {k: v[0] for k, v in params.items()}, H[0]

    def update_params(self, params_dict) -> None:
        """Reset decay and weights from T60 breakpoints."""
        T60 = torch.as_tensor(params_dict["T60_breakpoints"], dtype=torch.float32,
                              device=self.device)
        wts = torch.as_tensor(params_dict["multiexp_weighting"], dtype=torch.float32,
                              device=self.device)
        decay = 6.908 / (T60 * (self.sample_rate / self.hop_length))
        self.params = dict(self.params or {}, decay=decay, weights=wts)

    # --- projection ------------------------------------------------------
    def project(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clamp decays and weights to their valid ranges."""
        decay, weights = params["decay"], params["weights"]
        lo_d, hi_d = self.min_decay, self.max_decay
        if self.clamp_decay:
            if self.strictly_decreasing_decay:
                def clamp_row(row, hi_row):
                    out, carry = [], torch.full_like(row[..., 0], lo_d)
                    for i in range(row.shape[-1]):
                        carry = torch.minimum(torch.maximum(row[..., i], torch.clamp(carry, min=lo_d)),
                                              hi_row[..., i])
                        out.append(carry)
                    return torch.stack(out, -1)
                first = clamp_row(decay[..., 0, :], torch.full_like(decay[..., 0, :], hi_d))
                rows = [first]
                for i in range(1, decay.shape[-2]):
                    hi = (torch.clamp(first / 1.01, max=hi_d)
                          if self.enforce_long_decay_in_second_exponential
                          else torch.full_like(first, hi_d))
                    rows.append(clamp_row(decay[..., i, :], hi))
                decay = torch.stack(rows, -2)
            else:
                first = torch.clamp(decay[..., :1, :], lo_d, hi_d)
                rest = decay[..., 1:, :]
                if self.enforce_long_decay_in_second_exponential:
                    rest = torch.minimum(torch.clamp(rest, min=lo_d),
                                         torch.clamp(first / 1.01, max=hi_d))
                else:
                    rest = torch.clamp(rest, lo_d, hi_d)
                decay = torch.cat([first, rest], dim=-2)
        lo_w, hi_w = 10.0 ** (self.Amin / 20.0), 10.0 ** (self.Amax / 20.0)
        w_first = torch.clamp(weights[..., :1, :], lo_w, hi_w)
        w_rest = torch.minimum(torch.clamp(weights[..., 1:, :], min=lo_w), w_first)
        return dict(params, decay=decay, weights=torch.cat([w_first, w_rest], dim=-2))
