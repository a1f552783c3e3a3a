"""Audio-file output (``buddy_tpu/utils/log.py::write_audio_file``).  The
plotting helpers of that module are not ported yet."""

from __future__ import annotations

import os

import numpy as np

from buddy_tpu_torch.data.audio_io import write_wav


def write_audio_file(x, fs: int, name: str, path: str = ".") -> str:
    """Write a waveform to <path>/<name>.wav."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    os.makedirs(path, exist_ok=True)
    return write_wav(os.path.join(path, f"{name}.wav"), x, fs)
