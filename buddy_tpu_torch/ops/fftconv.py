"""FFT-domain linear convolution, the reverberation forward model
(``buddy_tpu/ops/fftconv.py``), on ``torch.fft``.

Full-spectrum FFT multiply at an efficient length >= N + M - 1, cropped back
to the signal length; differentiable in the signal and in the filter.  The
filter may carry leading batch axes that broadcast against the signal's (one
RIR per utterance).
"""

from __future__ import annotations

import torch

from buddy_tpu_torch.ops.dft import good_fft_size


def fft_convolve(y: torch.Tensor, filt: torch.Tensor, *, zero_pad: bool = False) -> torch.Tensor:
    """Linear convolution of a (..., N) signal with a (..., M) filter,
    cropped to N.  ``zero_pad`` sizes the FFT for 2N + 2M - 1 points, as
    the reference does there; any length of at least N + M - 1 gives the
    same cropped output."""
    n, m = y.shape[-1], filt.shape[-1]
    fft_size = good_fft_size(2 * n + 2 * m - 1 if zero_pad else n + m - 1)
    out = torch.fft.ifft(torch.fft.fft(y, n=fft_size, dim=-1)
                         * torch.fft.fft(filt, n=fft_size, dim=-1), dim=-1)
    return out[..., :n].real


def fast_apply_rir(y: torch.Tensor, rir: torch.Tensor, *, rm_delay: bool = False) -> torch.Tensor:
    """Apply a room impulse response to a (..., N) waveform.  ``rm_delay``
    first trims a 1-D filter at its argmax (the direct path)."""
    if rm_delay:
        if rir.dim() != 1:
            raise ValueError("rm_delay needs a single 1-D RIR")
        rir = rir[int(torch.argmax(rir)):]
    return fft_convolve(y, rir)
