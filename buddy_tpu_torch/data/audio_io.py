"""WAV reading and writing (``buddy_tpu/data/audio_io.py``) through the
port's native codec.

The codec is ``csrc/wavio.cpp``, compiled with the batch loader into the
host library at first use (``ops/_build.py::build_host``; a failed build
raises with the compiler's output).  It decodes PCM16/24/32 and IEEE-float
WAVs to mono float32 (PCM scaled to [-1, 1), channels averaged) and writes
mono IEEE-float WAVs.  A file the codec refuses (8-bit PCM, for one) is read
with scipy, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from buddy_tpu_torch.ops import _build

_F32P = ctypes.POINTER(ctypes.c_float)
SIGNATURES = {
    "wav_info": (ctypes.c_int64, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]),
    "wav_read_mono": (ctypes.c_int64, [ctypes.c_char_p, _F32P, ctypes.c_int64]),
    "wav_read_segment": (ctypes.c_int, [ctypes.c_char_p, _F32P, ctypes.c_int64,
                                        ctypes.c_uint64]),
    "wav_write_mono": (ctypes.c_int, [ctypes.c_char_p, _F32P, ctypes.c_int64, ctypes.c_int32]),
    "loader_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_uint64]),
    "loader_next": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(_F32P)]),
    "loader_release": (None, [ctypes.c_void_p, ctypes.c_int]),
    "loader_destroy": (None, [ctypes.c_void_p]),
}


def native_library() -> ctypes.CDLL:
    """The host library (the codec and the batch loader), built if missing."""
    return _build.load_host(SIGNATURES)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 array, sample_rate)."""
    lib = native_library()
    name = os.fsencode(path)
    sr = ctypes.c_int32(0)
    n = lib.wav_info(name, ctypes.byref(sr))
    if n > 0:
        out = np.empty(n, dtype=np.float32)
        got = lib.wav_read_mono(name, out.ctypes.data_as(_F32P), n)
        if got > 0:
            return out[:got], int(sr.value)
    # a file the codec refuses
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


def read_segment(path: str, segment_length: int, seed: int) -> Optional[np.ndarray]:
    """A training segment of ``segment_length`` samples from one file, drawn
    by the codec from an ``mt19937_64`` seeded with ``seed``: a random crop
    starting in [0, L - segment_length - 1] when the file is longer, else the
    file wrap-padded (cyclic continuation on both sides) at a random offset
    in [0, segment_length - L - 1] (0 when they are equal).  None if the
    codec refuses the file, as in the JAX package."""
    out = np.empty(segment_length, dtype=np.float32)
    rc = native_library().wav_read_segment(os.fsencode(path), out.ctypes.data_as(_F32P),
                                           segment_length, seed & 0xFFFFFFFFFFFFFFFF)
    return out if rc == 0 else None


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> str:
    """Write a mono IEEE-float WAV."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float32).reshape(-1))
    rc = native_library().wav_write_mono(os.fsencode(path), data.ctypes.data_as(_F32P),
                                         data.size, sample_rate)
    if rc == 0:
        return path
    from scipy.io import wavfile     # the codec could not open the file: scipy says why
    wavfile.write(path, sample_rate, data)
    return path
