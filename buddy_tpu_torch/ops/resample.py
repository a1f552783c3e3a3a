"""Resampling of the U-Net (``buddy_tpu/ops/resample.py``): FIR up and
down sampling (kernel K11), and nearest-up2 folded into the following
convolution (K8).

**FIR resampling** (``upfirdn2d`` and what is built on it, ``fir=True``):
upsample by zero insertion (H up samples: the up - 1 trailing zeros of
the reference's zero-stuffing are part of it), pad by (pad0, pad1)
(negative pads crop), filter with a FIR kernel (kh, kw) (a true
convolution: the kernel is flipped), keep every ``down``-th sample.  The
JAX package writes it as one lhs-dilated depthwise XLA convolution, not a
Pallas kernel.  On the card it is kernel K11 (``csrc/upfirdn.cu``, CUDA
C++), forward and input vjp: the vjp of upfirdn(up=u, down=d, pad0) on an
axis of n samples and taps k is upfirdn(up=d, down=u) of the cotangent
with the kernel flipped and the pads (k - 1 - pad0, n u - u + k - out d -
(k - 1 - pad0)) (``adjoint_axis``), so the up pass's adjoint is a down-type
launch and the other way round.  No gradient reaches the FIR kernel (a
constant of the model); asking for one raises.  On a CPU tensor each of the
two launches takes the plain route instead: the depthwise library
convolutions (``upfirdn_conv``: a transposed convolution of stride ``up``,
which is the lhs-dilated convolution with the kernel flipped back, or a
strided convolution).  ``upfirdn2d_plain`` is the definition written out
(zero-stuff, pad, correlate with the flipped kernel, stride), the reference
the card's checks hold K11 to.  Tensors are NCHW (the U-Net's are
channels_last in memory, which K11 reads as it is; an NCHW-contiguous
tensor is read as B C images of one channel); the output keeps the input's
memory format.  ``upfirdn1d`` takes (B, C, T) and runs the same kernel with
a one-tap axis.  The FIR kernel is float32, and so must x be: the JAX
package's FIR path fails under a bfloat16 body (``conv_general_dilated``
meets a float32 kernel), and the port raises where it would.  K11 takes
factors up to ``MAX_FACTOR`` and kernels up to ``MAX_TAPS`` taps an axis;
the entry points refuse more on every device.

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

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"upfirdn": [_P, _P, _P] + [_I] * 14 + [_P]}
# csrc/upfirdn.cu's kMaxFactor and kMaxTaps
MAX_FACTOR, MAX_TAPS = 8, 16


# ---------------------------------------------------------------------------
# FIR resampling (K11)
# ---------------------------------------------------------------------------
def _setup_kernel(k: Sequence[float]) -> np.ndarray:
    """The normalised FIR kernel: the outer product of a 1-D kernel with
    itself, divided by its sum, in float32 (``buddy_tpu/ops/resample.py``)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= k.sum()
    return k


class Axis(NamedTuple):
    """One spatial axis of an upfirdn: factors, pads, taps, input and
    output lengths."""
    up: int
    down: int
    pad0: int
    pad1: int
    taps: int
    n: int
    out: int


def make_axis(n: int, taps: int, up: int, down: int, pad) -> Axis:
    """The axis of n samples under upfirdn(up, down, pad) with ``taps`` taps:
    the output has (n up + pad0 + pad1 - taps) // down + 1 samples."""
    if not (1 <= up <= MAX_FACTOR and 1 <= down <= MAX_FACTOR and 1 <= taps <= MAX_TAPS):
        raise ValueError(f"upfirdn: up {up}, down {down}, {taps} taps: K11 takes factors 1 to "
                         f"MAX_FACTOR = {MAX_FACTOR} and 1 to MAX_TAPS = {MAX_TAPS} taps an axis")
    out = (n * up + pad[0] + pad[1] - taps) // down + 1
    if n < 1 or out < 1:
        raise ValueError(f"upfirdn: {n} samples with up {up}, down {down}, pad {tuple(pad)} and "
                         f"{taps} taps leave no output")
    return Axis(up, down, pad[0], pad[1], taps, n, out)


def adjoint_axis(a: Axis) -> Axis:
    """The axis of the input vjp: upfirdn(up=down, down=up) of the
    cotangent (a.out samples) with the kernel flipped, back to a.n samples."""
    q0 = a.taps - 1 - a.pad0
    return Axis(a.down, a.up, q0, a.n * a.up - a.up + a.taps - a.out * a.down - q0, a.taps,
                a.out, a.n)


def _check_dtypes(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dtype != torch.float32 or kernel.dtype != torch.float32:
        raise TypeError(f"upfirdn: x is {x.dtype} and the FIR kernel {kernel.dtype}; FIR "
                        f"resampling runs in float32 only, as the JAX package's FIR convolution "
                        f"refuses mixed dtypes (there is no FIR path under a bfloat16 body)")


def upfirdn_conv(x: torch.Tensor, kernel: torch.Tensor, ay: Axis, ax: Axis) -> torch.Tensor:
    """The plain route (the CPU's): upfirdn of x (B, C, H, W) with kernel
    (kh, kw) as one depthwise library convolution where its padding can
    express the pads, else a transposed convolution cropped or padded
    after."""
    C = x.shape[1]
    w = kernel.to(x.device).expand(C, 1, *kernel.shape)
    axes = (ay, ax)
    lo, hi = [a.pad0 for a in axes], [a.pad1 + a.up - 1 for a in axes]
    up, down = tuple(a.up for a in axes), tuple(a.down for a in axes)
    if max(up) > 1:
        # a transposed convolution correlates the lhs-dilated x, padded by
        # k - 1 - p below and k - 1 - p + op above, with the kernel flipped
        p = [a.taps - 1 - l for a, l in zip(axes, lo)]
        op = [h - l for h, l in zip(hi, lo)]
        if min(p) >= 0 and all(0 <= o < u for o, u in zip(op, up)):
            y = F.conv_transpose2d(x, w, stride=up, padding=p, output_padding=op, groups=C)
        else:
            y = F.conv_transpose2d(x, w, stride=up, groups=C)
            y = F.pad(y, (lo[1] - (ax.taps - 1), hi[1] - (ax.taps - 1),
                          lo[0] - (ay.taps - 1), hi[0] - (ay.taps - 1)))
        return y if max(down) == 1 else y[:, :, ::down[0], ::down[1]]
    if lo != hi or min(lo) < 0:
        x, lo = F.pad(x, (lo[1], hi[1], lo[0], hi[0])), [0, 0]
    return F.conv2d(x, w.flip(2, 3), stride=down, padding=lo, groups=C)


def _launch(x: torch.Tensor, kernel: torch.Tensor, ay: Axis, ax: Axis, counter) -> torch.Tensor:
    """One K11 launch on the CUDA tensor x (B, C, H, W), float32: read in
    channels_last as it is, else as B C one-channel images of the
    NCHW-contiguous tensor; the output in the same memory format."""
    B, C, H, W = x.shape
    if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
        fmt, images, channels = torch.channels_last, B, C
    else:
        x, fmt, images, channels = x.contiguous(), torch.contiguous_format, B * C, 1
    y = torch.empty((B, C, ay.out, ax.out), device=x.device, dtype=torch.float32,
                    memory_format=fmt)
    if x.numel() == 0:
        return y
    taps = kernel.detach().to("cpu").contiguous()
    lib = _build.load("upfirdn", _SIGNATURES)
    err = lib.upfirdn(_build.ptr(x), _build.ptr(y), _build.ptr(taps), ay.taps, ax.taps, images,
                      H, W, channels, ay.out, ax.out, ay.up, ax.up, ay.down, ax.down, ay.pad0,
                      ax.pad0, _build.stream(x.device))
    _build.check(err, "upfirdn")
    counter.launches += 1
    if upfirdn2d.record is not None:
        key = (counter.__name__, tuple(x.shape), fmt == torch.channels_last, ay, ax,
               tuple(taps.flatten().tolist()))
        upfirdn2d.record[key] = upfirdn2d.record.get(key, 0) + 1
    return y


def _run(x, kernel, ay: Axis, ax: Axis, counter) -> torch.Tensor:
    """K11 on a CUDA tensor, the plain route on a CPU one."""
    if x.device.type == "cpu":
        return upfirdn_conv(x, kernel.detach().to("cpu"), ay, ax)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn: K11 runs on CUDA tensors, got one on {x.device}")
    return _launch(x, kernel, ay, ax, counter)


def upfirdn2d_backward(g: torch.Tensor, kernel: torch.Tensor, ay: Axis, ax: Axis):
    """The input vjp of upfirdn over (ay, ax) for the cotangent g (B, C,
    ay.out, ax.out): upfirdn over the adjoint axes with the kernel flipped
    (one K11 launch on the card)."""
    return _run(g, kernel.detach().flip(0, 1), adjoint_axis(ay), adjoint_axis(ax),
                upfirdn2d_backward)


class _UpFirDnFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, ay, ax):
        ctx.kernel, ctx.axes = kernel.detach(), (ay, ax)
        return _run(x, kernel, ay, ax, upfirdn2d)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[1]:
            raise RuntimeError("upfirdn: no gradient reaches the FIR kernel (a constant of the "
                               "model); detach it")
        return upfirdn2d_backward(g, ctx.kernel, *ctx.axes), None, None, None


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """Upsample by zero insertion, pad, FIR-filter (a true convolution with
    ``kernel`` (kh, kw)), downsample; x is NCHW float32, the output keeps
    its memory format.  K11 on a CUDA tensor, the plain route on a CPU
    one."""
    _check_dtypes(x, kernel)
    kh, kw = kernel.shape
    ay = make_axis(x.shape[2], kh, up, down, pad)
    ax = make_axis(x.shape[3], kw, up, down, pad)
    return _UpFirDnFn.apply(x, kernel, ay, ax)


def upfirdn1d(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """The 1-D upfirdn along the last axis of x (B, C, T) with ``kernel``
    (k,): ``upfirdn2d``'s kernel with a one-tap axis of one sample."""
    _check_dtypes(x, kernel)
    ay = make_axis(1, 1, 1, 1, (0, 0))
    ax = make_axis(x.shape[2], kernel.shape[0], up, down, pad)
    return _UpFirDnFn.apply(x.unsqueeze(2), kernel.view(1, -1), ay, ax).squeeze(2)


# the launches of K11 (upfirdn2d and upfirdn1d alike): forward, input vjp;
# ``record``, where a dict, counts each launch by (direction, x's shape,
# channels_last, the two axes, the taps)
upfirdn2d.launches = 0
upfirdn2d_backward.launches = 0
upfirdn2d.record = None


def upfirdn_plain(x: torch.Tensor, kernel: torch.Tensor, ay: Axis, ax: Axis) -> torch.Tensor:
    """upfirdn of x (B, C, H, W) over (ay, ax) by its definition: the
    zero-stuffed x (n up samples an axis, the up - 1 trailing zeros
    included), padded, correlated with the flipped kernel, then strided."""
    B, C, H, W = x.shape
    z = x.new_zeros((B, C, H * ay.up, W * ax.up))
    z[:, :, ::ay.up, ::ax.up] = x
    z = F.pad(z, (ax.pad0, ax.pad1, ay.pad0, ay.pad1))
    w = kernel.flip(0, 1).to(x.device).expand(C, 1, *kernel.shape)
    return F.conv2d(z, w, groups=C)[:, :, ::ay.down, ::ax.down]


def upfirdn2d_plain(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
                    pad=(0, 0)) -> torch.Tensor:
    """``upfirdn2d`` by its definition (``upfirdn_plain``)."""
    kh, kw = kernel.shape
    return upfirdn_plain(x, kernel, Axis(up, down, pad[0], pad[1], kh, 0, 0),
                         Axis(up, down, pad[0], pad[1], kw, 0, 0))


def upfirdn1d_plain(x: torch.Tensor, kernel: torch.Tensor, *, up: int = 1, down: int = 1,
                    pad=(0, 0)) -> torch.Tensor:
    """``upfirdn1d`` by its definition."""
    return upfirdn_plain(x.unsqueeze(2), kernel.view(1, -1), Axis(1, 1, 0, 0, 1, 0, 0),
                         Axis(up, down, pad[0], pad[1], kernel.shape[0], 0, 0)).squeeze(2)


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
