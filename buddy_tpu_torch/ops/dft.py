"""Discrete Fourier transforms with the semantics of ``buddy_tpu/ops/dft.py``.

The JAX package routes short transforms through constant DFT matrices on the
TPU's matrix unit; those matmul forms exist only for the TPU and are not
ported.  Here every transform is ``torch.fft`` (cuFFT on the card).
"""

from __future__ import annotations

import torch


def good_fft_size(n: int, policy: str = "smooth5") -> int:
    """Smallest efficient FFT length >= n: the smallest 5-smooth
    (2^a 3^b 5^c) length, or the next power of two (``pow2``) or n itself
    (``exact``) — ``buddy_tpu/ops/fftconv.py::good_fft_size``."""
    n = int(n)
    if policy == "exact":
        return n
    pow2 = 1 << (n - 1).bit_length()
    if policy == "pow2":
        return pow2
    if policy != "smooth5":
        raise ValueError(policy)
    best = pow2
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            f = f35
            while f < n:
                f *= 2
            best = min(best, f)
            f35 *= 3
        f5 *= 5
    return best


def rfft(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft(X: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.irfft(X, n=n, dim=-1)


def cfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """fft along the last axis, zero-padding a shorter input to n."""
    return torch.fft.fft(x, n=n, dim=-1)


def icfft(Z: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.ifft(Z, n=n, dim=-1)


def icfft_slice(Z: torch.Tensor, n: int, offset: int, length: int) -> torch.Tensor:
    """ifft(Z)[..., offset:offset+length]."""
    return torch.fft.ifft(Z, n=n, dim=-1)[..., offset:offset + length]
