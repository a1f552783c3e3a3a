"""WAV reading and writing (``buddy_tpu/data/audio_io.py``), scipy path only.

The in-repo WAVs are IEEE float (format 3) and PCM files are scaled to
[-1, 1); multi-channel files are averaged to mono.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 array, sample_rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, int(sr)


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> str:
    """Write a mono IEEE-float WAV."""
    from scipy.io import wavfile
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32).reshape(-1))
    wavfile.write(path, sample_rate, data)
    return path
