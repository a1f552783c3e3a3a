"""Nearest-up2 folded into the following convolution (K8,
``buddy_tpu/ops/resample.py:114-166``).

``conv3x3(pad 1)(nearest_up2(x))`` is one convolution of the half-resolution
input: nearest-up2 is zero-stuffing followed by a ones(2, 2) filter, and
the two correlations collapse into one 4x4 kernel over the lhs-dilated
input, K4[a, b] = sum_{u, v in {0, 1}} K[a - u, b - v], with pads 2.  The
1x1 case is the 2x2 broadcast of its kernel with pads 1.  An lhs-dilated
convolution is a transposed convolution with the kernel flipped and its
in/out axes swapped: stride 2, padding k - 1 - pad (1 for the 4x4, 0 for
the 2x2), which writes no 4x-size tensor and runs 4 taps an output pixel
where the unfused 3x3 runs 9.

Weights are OIHW (the JAX package's are HWIO).  The derived kernel is
formed in the weight's dtype (float32) and cast to the input's after the
sum, as the JAX package does: four bf16-rounded taps would sum to other
bits.  The float route is one library transposed convolution, as the JAX
package's is one XLA convolution; the int8 route is kernel K10
(``ops/qconv.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
