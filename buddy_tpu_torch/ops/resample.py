"""Resampling of the U-Net (``buddy_tpu/ops/resample.py``): FIR up and
down sampling, and nearest-up2 folded into the following convolution (K8).

**FIR resampling** (``upfirdn2d`` and what is built on it, ``fir=True``):
upsample by zero insertion, pad, filter with a FIR kernel (a true
convolution: the kernel is flipped), downsample by striding.  The JAX
package writes it as one lhs-dilated depthwise XLA convolution, not a Pallas
kernel; the port computes it with PyTorch's depthwise convolutions, on the
CPU and on the card alike: upsampling as a transposed convolution of stride
``up`` (which is the lhs-dilated convolution with the kernel flipped back),
downsampling as a strided convolution.  The JAX form pads the lhs-dilated
input, of (H - 1) up + 1 samples, with (pad0, pad1 + up - 1), which folds
the up - 1 trailing zeros of the reference's zero-stuffing into the high
padding.  ``upfirdn2d_plain`` is that definition written out (zero-stuff,
pad, correlate with the flipped kernel, stride).  Tensors are NCHW (the
U-Net's are channels_last in memory); ``upfirdn1d`` takes (B, C, T).  The
FIR kernel is float32, and so must x be: the JAX package's FIR path fails
under a bfloat16 body (``conv_general_dilated`` meets a float32 kernel), and
the port raises where it would.

**K8**: ``conv3x3(pad 1)(nearest_up2(x))`` is one convolution of the
half-resolution input: nearest-up2 is zero-stuffing followed by a ones(2, 2)
filter, and the two correlations collapse into one 4x4 kernel over the
lhs-dilated input, K4[a, b] = sum_{u, v in {0, 1}} K[a - u, b - v], with
pads 2.  The 1x1 case is the 2x2 broadcast of its kernel with pads 1.  An
lhs-dilated convolution is a transposed convolution with the kernel flipped
and its in/out axes swapped: stride 2, padding k - 1 - pad (1 for the 4x4,
0 for the 2x2), which writes no 4x-size tensor and runs 4 taps an output
pixel where the unfused 3x3 runs 9.

Weights are OIHW (the JAX package's are HWIO).  The derived kernel is
formed in the weight's dtype (float32) and cast to the input's after the
sum, as the JAX package does: four bf16-rounded taps would sum to other
bits.  The float route is one library transposed convolution, as the JAX
package's is one XLA convolution; the int8 route is kernel K10
(``ops/qconv.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d}


# ---------------------------------------------------------------------------
# FIR resampling
# ---------------------------------------------------------------------------
def _setup_kernel(k: Sequence[float]) -> np.ndarray:
    """The normalised FIR kernel: the outer product of a 1-D kernel with
    itself, divided by its sum, in float32 (``buddy_tpu/ops/resample.py``)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= k.sum()
    return k


def _upfirdn(x: torch.Tensor, kernel: torch.Tensor, up: int, down: int, pad) -> torch.Tensor:
    """upfirdn over the last ``kernel.dim()`` axes of x (B, C, *spatial),
    one depthwise convolution; every spatial axis takes the same up, down
    and pad."""
    nd = kernel.dim()
    if x.dtype != kernel.dtype:
        raise TypeError(f"upfirdn: x is {x.dtype} and the FIR kernel {kernel.dtype}; the JAX "
                        f"package's FIR convolution refuses mixed dtypes (there is no FIR path "
                        f"under a bfloat16 body)")
    C, k = x.shape[1], kernel.shape[0]
    w = kernel.to(x.device).expand(C, 1, *kernel.shape)
    lo, hi = pad[0], pad[1] + up - 1
    if up > 1:
        # a transposed convolution correlates the lhs-dilated x, padded by
        # k - 1 - p below and k - 1 - p + op above, with the kernel flipped
        p, op = k - 1 - lo, hi - lo
        if p >= 0 and 0 <= op < up:
            y = _CONV_T[nd](x, w, stride=up, padding=p, output_padding=op, groups=C)
        else:
            y = _CONV_T[nd](x, w, stride=up, groups=C)
            y = F.pad(y, (lo - (k - 1), hi - (k - 1)) * nd)
        return y if down == 1 else y[(...,) + (slice(None, None, down),) * nd]
    if lo != hi or lo < 0:
        x, lo = F.pad(x, (lo, hi) * nd), 0
    return _CONV[nd](x, w.flip(tuple(range(2, 2 + nd))), stride=down, padding=lo, groups=C)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """Upsample by zero insertion, pad, FIR-filter (a true convolution with
    ``kernel`` (kh, kw), kh == kw), downsample; x is NCHW."""
    return _upfirdn(x, kernel, up, down, pad)


def upfirdn2d_plain(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
                    pad=(0, 0)) -> torch.Tensor:
    """``upfirdn2d`` by its definition: the zero-stuffed x (H up samples,
    up - 1 trailing zeros), padded, correlated with the flipped kernel, then
    strided."""
    B, C, H, W = x.shape
    z = x.new_zeros((B, C, H * up, W * up))
    z[:, :, ::up, ::up] = x
    z = F.pad(z, (pad[0], pad[1]) * 2)
    w = kernel.flip(0, 1).to(x.device).expand(C, 1, *kernel.shape)
    return F.conv2d(z, w, groups=C)[:, :, ::down, ::down]


def fir_kernel(k: Sequence[float], gain: float) -> torch.Tensor:
    """The 2-D FIR kernel of ``k`` times ``gain``, float32, as the JAX
    package forms it (``_setup_kernel(k) * gain`` in numpy float32)."""
    return torch.from_numpy(_setup_kernel(k) * gain)


def upsample_2d(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1), factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
    """FIR x2 upsampling (StyleGAN2's ``upsample_2d``)."""
    kern = fir_kernel(k, gain * factor ** 2)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1), factor: int = 2,
                  gain: float = 1.0) -> torch.Tensor:
    """FIR x2 downsampling (StyleGAN2's ``downsample_2d``)."""
    kern = fir_kernel(k, gain)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: Sequence[float], factor: int = 2,
                     gain: float = 1.0) -> torch.Tensor:
    """FIR upsampling, then a SAME 3x3 convolution with w (O, I, 3, 3), as
    the JAX package computes it (not the reference's transposed-convolution
    form, which differs at the edges)."""
    return F.conv2d(upsample_2d(x, k, factor=factor, gain=gain), w, padding=w.shape[-1] // 2)


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: Sequence[float], factor: int = 2,
                       gain: float = 1.0) -> torch.Tensor:
    """A SAME 3x3 convolution with w (O, I, 3, 3), then FIR downsampling."""
    return downsample_2d(F.conv2d(x, w, padding=w.shape[-1] // 2), k, factor=factor, gain=gain)


def upfirdn1d(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """The 1-D upfirdn along the last axis of x (B, C, T) with ``kernel``
    (k,)."""
    return _upfirdn(x, kernel, up, down, pad)


# ---------------------------------------------------------------------------
# K8: nearest-up2 folded into the following convolution
# ---------------------------------------------------------------------------


def up2_kernel3x3(kernel: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, 3) -> the (O, I, 4, 4) kernel of ``conv3x3 ∘ nearest_up2``
    over the lhs-dilated input."""
    o, i = kernel.shape[:2]
    k4 = kernel.new_zeros((o, i, 4, 4))
    for u in (0, 1):
        for v in (0, 1):
            k4[:, :, u:u + 3, v:v + 3] += kernel
    return k4


def up2_kernel1x1(kernel: torch.Tensor) -> torch.Tensor:
    """(O, I, 1, 1) -> the (O, I, 2, 2) kernel of ``conv1x1 ∘ nearest_up2``:
    each input pixel paints its 2x2 output block through W."""
    return kernel.expand(kernel.shape[0], kernel.shape[1], 2, 2)


def up2_derived(kernel: torch.Tensor) -> torch.Tensor:
    """The lhs-dilated kernel of a 3x3 or 1x1 kernel."""
    kh = kernel.shape[-1]
    if kh == 3:
        return up2_kernel3x3(kernel)
    if kh == 1:
        return up2_kernel1x1(kernel)
    raise ValueError(f"no fused up2 form for a {kh}x{kh} kernel")


def lhs_dilated_conv(x: torch.Tensor, k_up: torch.Tensor, bias=None) -> torch.Tensor:
    """The stride-1 convolution of the 2x lhs-dilated x with the derived
    kernel k_up (O, I, 4, 4) at pads 2 or (O, I, 2, 2) at pads 1, as a
    transposed convolution; output (B, O, 2H, 2W)."""
    k = k_up.shape[-1]
    return F.conv_transpose2d(x, k_up.flip(2, 3).transpose(0, 1), bias, stride=2,
                              padding=k // 2 - 1)


def up2_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """``conv3x3(pad 1)(nearest_up2(x))`` as one convolution."""
    b = None if bias is None else bias.to(x.dtype)
    return lhs_dilated_conv(x, up2_kernel3x3(kernel).to(x.dtype), b)


def up2_conv1x1(x: torch.Tensor, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """``conv1x1(nearest_up2(x))`` as one convolution."""
    b = None if bias is None else bias.to(x.dtype)
    return lhs_dilated_conv(x, up2_kernel1x1(kernel).to(x.dtype), b)
