"""WAV reading and writing (``buddy_tpu/data/audio_io.py``), scipy path only,
and the random training crop of ``read_segment`` in numpy.

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


def read_segment(path: str, segment_length: int, seed: int) -> np.ndarray:
    """A training segment of ``segment_length`` samples from one file: a
    random crop starting in [0, L - segment_length - 1] when the file is
    longer, else the file wrap-padded (cyclic continuation on both sides)
    at a random offset in [0, segment_length - L - 1] (0 when they are
    equal).  The JAX package does the same natively
    (``runtime/wavio.cpp::wav_read_segment``) with a C++ ``mt19937_64``; the
    offsets here come from ``np.random.default_rng(seed)``, so the rule is
    the same but the bits of a given seed are not."""
    data, _ = read_wav(path)
    rng = np.random.default_rng(seed)
    L = len(data)
    if L > segment_length:
        idx = int(rng.integers(0, L - segment_length))
        return data[idx: idx + segment_length]
    idx = int(rng.integers(0, segment_length - L)) if segment_length > L else 0
    return np.take(data, (np.arange(segment_length) - idx) % L)


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> str:
    """Write a mono IEEE-float WAV."""
    from scipy.io import wavfile
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32).reshape(-1))
    wavfile.write(path, sample_rate, data)
    return path
