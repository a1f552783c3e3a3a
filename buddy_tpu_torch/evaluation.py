"""Objective evaluation metrics for dereverberation outputs
(``buddy_tpu/evaluation.py``; the port's own copy, plain numpy).

The metrics that are computable without external model weights; the Tester
writes them per utterance with ``tester.evaluate.use=True``:

* **SI-SDR** (scale-invariant signal-to-distortion ratio, dB) — the
  standard time-domain enhancement metric (Le Roux et al., 2019).
* **LSD** (log-spectral distance, dB) — mean per-frame L2 distance of
  log-magnitude spectra; the dereverberation literature's spectral metric.
* **RIR EDC error** — for blind mode: L2 distance between the energy decay
  curves (Schroeder integrals, dB domain) of the estimated and true RIR,
  cropped to the true RIR's length.  Measures how well the blind operator
  recovered the room acoustics.
"""

from __future__ import annotations

import numpy as np


def si_sdr(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Scale-invariant SDR in dB.  Inputs are 1-D, equal length."""
    reference = np.asarray(reference, np.float64).reshape(-1)
    estimate = np.asarray(estimate, np.float64).reshape(-1)
    n = min(reference.shape[-1], estimate.shape[-1])
    reference, estimate = reference[:n], estimate[:n]
    ref_energy = np.sum(reference ** 2) + 1e-12
    alpha = np.sum(estimate * reference) / ref_energy
    target = alpha * reference
    noise = estimate - target
    return float(10.0 * np.log10(
        (np.sum(target ** 2) + 1e-12) / (np.sum(noise ** 2) + 1e-12)))


def _mag_stft(x: np.ndarray, n_fft: int = 512, hop: int = 128) -> np.ndarray:
    x = np.asarray(x, np.float64).reshape(-1)
    window = np.hanning(n_fft + 1)[:-1]
    n_frames = max(1 + (len(x) - n_fft) // hop, 1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    idx = np.minimum(idx, len(x) - 1)
    frames = x[idx] * window
    return np.abs(np.fft.rfft(frames, axis=-1))


def log_spectral_distance(reference: np.ndarray, estimate: np.ndarray,
                          n_fft: int = 512, hop: int = 128) -> float:
    """Mean per-frame L2 distance of log10-magnitude spectra, in dB."""
    R = _mag_stft(reference, n_fft, hop)
    E = _mag_stft(estimate, n_fft, hop)
    n = min(R.shape[0], E.shape[0])
    d = 20.0 * (np.log10(R[:n] + 1e-8) - np.log10(E[:n] + 1e-8))
    return float(np.mean(np.sqrt(np.mean(d ** 2, axis=-1))))


def edc_db(rir: np.ndarray) -> np.ndarray:
    """Schroeder energy decay curve in dB (backward integral of h^2)."""
    rir = np.asarray(rir, np.float64).reshape(-1)
    e = np.cumsum((rir ** 2)[::-1])[::-1]
    return 10.0 * np.log10(e / (e[0] + 1e-30) + 1e-30)


def rir_edc_error(true_rir: np.ndarray, est_rir: np.ndarray,
                  floor_db: float = -60.0) -> float:
    """RMS distance between energy decay curves above the dB floor."""
    t = edc_db(true_rir)
    n = min(len(t), len(np.asarray(est_rir).reshape(-1)))
    e = edc_db(np.asarray(est_rir).reshape(-1)[:n])
    t = t[:n]
    mask = t > floor_db
    if not mask.any():
        return 0.0
    return float(np.sqrt(np.mean((t[mask] - e[mask]) ** 2)))


def evaluate_utterance(clean: np.ndarray, estimate: np.ndarray,
                       degraded: np.ndarray | None = None,
                       true_rir: np.ndarray | None = None,
                       est_rir: np.ndarray | None = None) -> dict:
    """All applicable metrics for one utterance, plus the degraded-input
    baselines so the improvement is visible at a glance."""
    out = {
        "si_sdr": si_sdr(clean, estimate),
        "lsd": log_spectral_distance(clean, estimate),
    }
    if degraded is not None:
        out["si_sdr_degraded"] = si_sdr(clean, degraded)
        out["lsd_degraded"] = log_spectral_distance(clean, degraded)
    if true_rir is not None and est_rir is not None:
        out["rir_edc_rmse_db"] = rir_edc_error(true_rir, est_rir)
    return out
