"""Audio files, the loss-by-sigma plot and the spectrogram plot
(``buddy_tpu/utils/log.py``).

matplotlib is imported inside the plotting functions: where it is not
installed a call raises ImportError, and the trainer then skips the plot.
The spectrogram's log magnitude comes from ``log_spectrogram``, which needs
no matplotlib.
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


def log_spectrogram(x, stft_cfg, device=None) -> np.ndarray:
    """20 log10(|STFT| + 1e-8) of a waveform, (n_fft / 2 + 1, frames):
    ``n_fft`` = ``stft_cfg.win_size`` (1024 unless given), hop
    ``stft_cfg.hop_size`` (256), a periodic Hann window and constant
    padding, through ``ops/stft.py::STFT`` (kernel K2 on a CUDA tensor, its
    plain version on the CPU).  ``device``: the tensor's where ``x`` is
    one, else the card unless the CPU is asked for."""
    import torch
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    if isinstance(x, torch.Tensor):
        device = x.device if device is None else device
        x = x.detach()
    else:
        x = torch.as_tensor(np.asarray(x, np.float32))
    win = int(stft_cfg.get("win_size", 1024))
    hop = int(stft_cfg.get("hop_size", 256))
    op = STFT(win, hop, hann_window(win), pad_mode="constant", device=device)
    S = op.stft(x.to(op.device, torch.float32).reshape(1, -1))[0]
    return (20 * torch.log10(S.abs() + 1e-8)).cpu().numpy()


def plot_spectrogram_from_raw_audio(x, stft_cfg, fs: int = 16000, out_path: str | None = None,
                                    device=None):
    """Log-magnitude spectrogram plot of a waveform (``log_spectrogram``);
    writes ``out_path`` and returns it, or returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logmag = log_spectrogram(x, stft_cfg, device=device)
    n = int(np.prod(np.shape(x)))
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(logmag, origin="lower", aspect="auto", cmap="magma",
                   extent=[0, n / fs, 0, fs / 2])
    fig.colorbar(im, ax=ax, label="dB")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [Hz]")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
    return fig
