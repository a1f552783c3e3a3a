"""Kernels and signal ops of the port: STFT (K2), GroupNorm (K1), subband
convolution (K3), DFTs and the minimum-phase chain.

The package exports the JAX package's signal ops (``buddy_tpu/ops/__init__.py``).
As there, the name ``stft`` is the function: the K2 module is
``importlib.import_module("buddy_tpu_torch.ops.stft")``, or its names are
imported from ``buddy_tpu_torch.ops.stft``.  Importing builds no kernel."""

from buddy_tpu_torch.ops.stft import stft, istft, hann_window, pad_spec_frames
from buddy_tpu_torch.ops.fftconv import fft_convolve, fast_apply_rir
from buddy_tpu_torch.ops.minphase import hilbert, minimum_phase_version

__all__ = [
    "stft", "istft", "hann_window", "pad_spec_frames",
    "fft_convolve", "fast_apply_rir",
    "hilbert", "minimum_phase_version",
]
