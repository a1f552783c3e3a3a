"""Audio files and the loss-by-sigma plot (``buddy_tpu/utils/log.py``).

matplotlib is imported inside ``plot_loss_by_sigma``: where it is not
installed the call raises ImportError, and the trainer then skips the plot.
The spectrogram plot of that module is not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from buddy_tpu_torch.data.audio_io import write_wav


def write_audio_file(x, fs: int, name: str, path: str = ".", normalize: bool = False,
                     stereo: bool = False) -> str:
    """Write a waveform to <path>/<name>.wav, scaled to a peak of 0.95 when
    ``normalize``.  ``stereo`` is accepted for the reference's signature;
    the file is mono, as the JAX package writes it."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    if normalize and np.abs(x).max() > 0:
        x = 0.95 * x / np.abs(x).max()
    os.makedirs(path, exist_ok=True)
    return write_wav(os.path.join(path, f"{name}.wav"), x, fs)


def plot_loss_by_sigma(means: Sequence[float], stds: Sequence[float],
                       sigma_bins: Sequence[float], out_path: str | None = None):
    """The mean loss against sigma (log axis) with a band of one std; the
    bins without samples (NaN means) are left out."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    means = np.asarray(means, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    bins = np.asarray(sigma_bins, dtype=np.float64)
    ok = np.isfinite(means)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(bins[ok], means[ok], color="#006450")
    ax.fill_between(bins[ok], (means - stds)[ok], (means + stds)[ok],
                    alpha=0.3, color="#006450")
    ax.set_xscale("log")
    ax.set_xlabel("sigma")
    ax.set_ylabel("loss")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
    return fig
