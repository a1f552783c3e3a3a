"""Kernels by name, and the bytes of the port's own kernels by shape.

Names are the short function names of the profiler's device events
(``trace.short_name``). The port's kernels carry fixed names; cuDNN's
convolutions are named by their engines.
"""

from __future__ import annotations

import math

from portbench.trace import short_name

K1 = ("gn_stats_kernel", "gn_apply_kernel", "gn_bwd_stats_kernel", "gn_bwd_apply_kernel")
K11 = ("upfirdn_kernel",)
# the blind operator's inner loop: K3 (subband filtering), K4 (compressed
# loss), K5 (minimum phase), K6 (filter design)
OPERATOR = ("subband_fft_conv_kernel", "compress_kernel", "compress_bwd_kernel",
            "comp_loss_fwd_kernel", "comp_loss_bwd_kernel", "minphase_fwd_kernel",
            "minphase_bwd_kernel", "design_fwd_kernel", "design_bwd_kernel")

# cuDNN's convolution engines: implicit GEMMs (fprop, dgrad, wgrad), the
# direct, Winograd and FFT routes, and the layout and scale passes it runs
# around them
_CONV_MARKS = ("cudnn", "fprop", "dgrad", "wgrad", "convolve_common_engine", "winograd",
               "fft2d_r2c", "fft2d_c2r", "flip_filter", "nhwcAddPaddingKernel")


def is_conv(name: str, prev: str | None = None, nxt: str | None = None) -> bool:
    """Whether a device event is part of a convolution. A GEMM counts only
    between an ``fft2d_r2c`` and an ``fft2d_c2r`` launch, where it is the
    product of cuDNN's FFT route; every other GEMM is a matmul."""
    s = short_name(name)
    if any(m in s for m in _CONV_MARKS):
        return True
    if "gemm" in s and prev is not None and nxt is not None:
        return short_name(prev).startswith("fft2d_r2c") and short_name(nxt).startswith("fft2d_c2r")
    return False


def conv_us(events) -> float:
    """Device us of the convolutions among ``events`` (in time order)."""
    total = 0.0
    for i, (name, _, dur) in enumerate(events):
        prev = events[i - 1][0] if i > 0 else None
        nxt = events[i + 1][0] if i + 1 < len(events) else None
        if is_conv(name, prev, nxt):
            total += dur
    return total


def named_us(events, names) -> float:
    """Device us of the events whose short name is one of ``names``."""
    names = set(names)
    return sum(dur for name, _, dur in events if short_name(name) in names)


_ESIZE = {"torch.float32": 4, "torch.bfloat16": 2, "torch.float16": 2}


def k1_bytes(shape, dtype: str, backward: bool) -> int:
    """K1 (GroupNorm + SiLU) reads x once and writes y once forward; its
    backward reads x and dy once and writes dx once (the per-group and
    per-channel vectors are negligible)."""
    return (3 if backward else 2) * math.prod(shape) * _ESIZE[dtype]


def k11_bytes(x_shape, out_h: int, out_w: int) -> int:
    """K11 (upfirdn, float32) reads its input once and writes its output once."""
    B, C = x_shape[0], x_shape[1]
    return 4 * (math.prod(x_shape) + B * C * out_h * out_w)
