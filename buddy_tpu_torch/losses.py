"""Reconstruction losses for posterior sampling (``buddy_tpu/losses.py``).

STFT-domain L2 variants (raw, magnitude, log-magnitude, power-law
compressed, log-compressed) with optional frequency weighting, hybrid
composition, and the plain time-domain l2_sum / l2_mean.  Each STFT variant
is a sum or mean of |T(X) - T(X_hat)|^2 for a per-variant transform T;
``loss_fn.prepare`` applies T so callers can hoist T(y) out of the blind
inner loop.

Batch-first: inputs are (B, n) waveforms or (B, F, frames) spectra, one row
per utterance, and every loss returns one value per utterance (B,) — the
JAX package computes the same value once per vmapped utterance.  Summing the
per-utterance values gives each utterance's gradient unchanged.
"""

from __future__ import annotations

import torch

from buddy_tpu_torch.ops.spec_loss import comp_loss, spec_compress

# the compressed variants and the divisor of their reduction over (F, T):
# sum over both; mean over both; sum over bins, then mean over frames
_COMPRESSED = {"l2_comp_stft_sum": lambda F, T: 1.0,
               "l2_comp_stft_mean": lambda F, T: float(F * T),
               "l2_comp_stft_summean": lambda F, T: float(T)}


def get_frequency_weighting(freqs, freq_weighting=None):
    if freq_weighting is None or freq_weighting == "none":
        return torch.ones_like(freqs)
    if freq_weighting == "sqrt":
        return torch.sqrt(freqs)
    if freq_weighting == "exp":
        f = torch.exp(freqs)
        return f - f[:, 0, :][:, None, :]
    if freq_weighting == "log":
        return torch.log(1 + freqs)
    if freq_weighting == "linear":
        return freqs
    raise NotImplementedError(freq_weighting)


def _zero(X):
    return (X.real == 0) & (X.imag == 0)


def _safe_mag(X):
    """|X| with a zero gradient at X == 0 (torch's abs convention)."""
    zero = _zero(X)
    return torch.where(zero, 0.0, torch.abs(torch.where(zero, torch.ones_like(X), X)))


def _per_utterance(err, reduce):
    return reduce(err.reshape(err.shape[0], -1), -1)


def get_loss(loss_args, operator=None):
    """Build a loss closure from a config node; None for name "none"."""
    if loss_args is None or loss_args["name"] == "none":
        return None

    if "loss_1" in loss_args:
        subs = [get_loss(loss_args[k], operator=operator) for k in loss_args.keys()]
        subs = [s for s in subs if s is not None]
        return lambda x, x_hat: sum(s(x, x_hat) for s in subs)

    name = loss_args["name"]
    weight = float(loss_args.get("weight", 1.0))

    if "stft" in name:
        freq_weighting = loss_args.get("freq_weighting", None)
        factor = loss_args.get("compression_factor", None)
        if name in _COMPRESSED:
            if factor is None or not 0 < factor <= 1:
                raise ValueError(f"{name} needs 0 < compression_factor <= 1")

        def spectrum(x):
            # a complex input is an already-computed STFT
            X = x if x.is_complex() else operator.apply_stft(x)
            if freq_weighting is not None and freq_weighting != "none":
                freqs = torch.linspace(0, 1, X.shape[-2], device=X.device)[None, :, None] + 1
                X = X * get_frequency_weighting(freqs.expand(X.shape), freq_weighting)
            return X

        def transform(x):
            X = spectrum(x)
            if name == "l2_stft_sum":
                return X
            if name == "l2_stft_mag_sum":
                return _safe_mag(X)
            if name == "l2_stft_logmag_sum":
                return torch.log10(_safe_mag(X) + 1e-8)
            if name in _COMPRESSED:
                return spec_compress(X, factor)
            if name == "l2_log_stft_sum":
                zero = _zero(X)
                safe = torch.where(zero, torch.ones_like(X), X)
                mag = torch.abs(safe)
                return torch.where(zero, torch.zeros_like(X), safe * (torch.log1p(mag) / mag))
            raise NotImplementedError(f"rec_loss {name} not implemented")

        def loss_fn(x, x_hat, x_prepared: bool = False):
            A = x if x_prepared else transform(x)
            if name in _COMPRESSED:
                # K4: compression of the estimate, difference, square and the
                # per-utterance reduction in one pass
                X_hat = spectrum(x_hat)
                F_, T_ = X_hat.shape[-2:]
                scale = weight / _COMPRESSED[name](F_, T_)
                return comp_loss(A, X_hat, factor, scale)
            d = A - transform(x_hat)
            err = d.real ** 2 + d.imag ** 2 if d.is_complex() else d ** 2
            return weight * _per_utterance(err, torch.sum)

        loss_fn.prepare = transform
        return loss_fn

    if name == "l2_sum":
        return lambda x, x_hat: weight * _per_utterance((x - x_hat) ** 2, torch.sum)
    if name == "l2_mean":
        return lambda x, x_hat: weight * _per_utterance((x - x_hat) ** 2, torch.mean)
    raise NotImplementedError(f"rec_loss {name} not implemented")
