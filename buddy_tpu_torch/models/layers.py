"""NCSN++ layers as ``nn.Module``s (``buddy_tpu/models/layers.py``).

Tensors are NCHW; the U-Net keeps them in channels_last memory format, so
they lie in memory as the JAX package's NHWC arrays do.  Submodule and
parameter names follow the JAX package's (``GroupNorm_0``, ``Conv_0``,
``Dense_0``, ``NIN_0``, ``Conv2d_0_weight`` ...), so ``models/convert.py``
maps the two parameter trees one to one.  Convolutions and dense layers
run in the dtype of their input (their float32 weights are cast per call),
which is how the JAX package's ``dtype=compute_dtype`` layers behave on the
body's activations.  A conv built with ``dtype`` casts its input to it
first: the body's compute dtype, where a float32 tensor can reach a JAX
conv of ``dtype=compute_dtype`` (after a residual pyramid's sum), and
float32 for the JAX package's convs built without a dtype (flax promotes a
bfloat16 input with their float32 weights to float32, and what follows is
promoted with it).

Tensor parallelism (``set_tensor_parallel``, the trainer's ``exp.mesh.tp``):
a conv whose output channels divide over tp (``parallel.mesh.tp_sharded``,
the JAX package's ``param_shardings`` rule) holds its rank's rows of the
weight and computes only those channels: its input, whole on every rank,
passes ``copy_to_tp`` (backward: the input gradient summed over the tp
group), its bias is sliced, and ``gather_from_tp`` brings the channels of
every rank back before whatever reads them all (the next conv, the skip
add, attention's NINs, Combine, the pyramids, the output layer and the
ISTFT).  Inside a ResBlock the channels stay sharded from Conv_0 through
its bias, this rank's rows of ``Dense_0(act(temb))`` and GroupNorm_1, which
runs K1 on the local channels with num_groups / tp groups (whole groups:
their statistics need no collective); they are gathered for Conv_1.  Under
``remat`` the recomputation repeats the forward's all-gathers in the same
order on every rank.  The biases, Dense_0 and GroupNorm_1's affine stay
replicated (1-D and 2-D leaves), so each rank's gradient holds only its
slice of them: ``set_tensor_parallel`` returns them, and the trainer sums
their gradients over the tp group.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from buddy_tpu_torch.ops import qconv as Q
from buddy_tpu_torch.ops import resample as R
from buddy_tpu_torch.ops.groupnorm import group_norm_act
from buddy_tpu_torch.parallel import mesh as pmesh

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def default_init_(weight: torch.Tensor, scale: float, fan_in: int, fan_out: int,
                  generator: torch.Generator) -> None:
    """DDPM initializer: variance_scaling(scale, fan_avg, uniform), with
    scale 0 clamped to 1e-10."""
    scale = 1e-10 if scale == 0 else scale
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    w = (torch.rand(weight.shape, generator=generator) * 2.0 - 1.0) * limit
    with torch.no_grad():
        weight.copy_(w)


def get_act(name: str):
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


class GroupNormAct(nn.Module):
    """GroupNorm (float32 statistics, eps 1e-6) with an optional activation;
    SiLU is fused into kernel K1, any other activation runs after it."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6, act=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def init_(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, tp=None):
        """``tp``: x holds this rank's channels, normalised in num_groups / tp
        whole groups with this rank's slice of the affine."""
        fused = self.act is F.silu
        w, b, g = self.weight, self.bias, self.num_groups
        if tp is not None:
            blk = tp.block(w.shape[0])
            w, b, g = w[blk], b[blk], g // tp.size
        y = group_norm_act(x, w, b, g, self.eps, silu=fused)
        if self.act is not None and not fused:
            y = self.act(y)
        return y


def group_norm(ch: int, act=None) -> GroupNormAct:
    """GroupNorm(min(ch//4, 32), eps=1e-6) — the reference's uniform choice."""
    return GroupNormAct(ch, min(ch // 4, 32), 1e-6, act)


class Conv(nn.Conv2d):
    """nn.Conv2d in ``dtype`` when given (the input is cast to it), else in
    the input's dtype, with the DDPM initializer.  ``tp`` (set by
    ``set_tensor_parallel``): the weight holds this rank's output channels;
    ``forward`` gathers every rank's, ``local`` returns this rank's."""

    tp = None

    def __init__(self, in_ch, out_ch, kernel_size, *, padding=0, stride=1, bias=True,
                 init_scale=1.0, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=bias)
        self.init_scale, self.compute_dtype = init_scale, dtype

    def init_(self, generator):
        o, i, kh, kw = self.weight.shape
        default_init_(self.weight, self.init_scale, i * kh * kw, o * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _bias(self):
        """The bias of the channels this rank computes."""
        if self.tp is None or self.bias is None:
            return self.bias
        return self.bias[self.tp.block(self.bias.shape[0])]

    def _local(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        b = self._bias()
        return self._conv_forward(x, self.weight.to(x.dtype), None if b is None else b.to(x.dtype))

    def local(self, x):
        """This rank's output channels of the whole input ``x``."""
        return self._local(x if self.tp is None else pmesh.copy_to_tp(x, self.tp))

    def forward(self, x):
        if self.tp is None:
            return self._local(x)
        return pmesh.gather_from_tp(self.local(x), self.tp)


def quant_config(quant) -> tuple:
    """``quant`` is True (int8 defaults) or (accum, bwd_quant, static_scale),
    as the JAX package's ``qconv`` setting."""
    accum, bwd, static = ("int32", False, False) if quant is True else quant
    if accum not in Q.ACCUM:
        raise ValueError(f"quantize_accum must be one of {sorted(Q.ACCUM)}, got {accum!r}")
    return accum, bool(bwd), bool(static)


class _Int8:
    """The int8 path of a conv (kernel K10, ``ops/qconv.py``): its settings,
    the ``a_scale`` buffer (C_in,) of calibrated |x| maxima when static
    (zeros until ``NetworkBundle.calibrate_quant``), and the forward, which
    keeps the quantized weights in ``weight_cache`` per version.  While
    ``observing`` (calibration) a static conv maxes |x| into ``a_scale``
    and quantizes dynamically, as the JAX package's does with its "quant"
    collection mutable."""

    observing = False

    def _set_quant(self, quant, in_ch: int) -> None:
        self.accum, self.bwd_quant, static = quant_config(quant)
        if static:
            self.register_buffer("a_scale", torch.zeros(in_ch))

    def _int8(self, x):
        a_scale = getattr(self, "a_scale", None)
        if a_scale is not None and self.observing:
            Q.observe_(a_scale, x)
            a_scale = None
        return Q.quantized_conv(x, self.weight, self._bias(), self.kind, self.accum,
                                self.bwd_quant, a_scale, cache=self.weight_cache)


class QConv(_Int8, Conv):
    """A stride-1 3x3 (pad 1) or 1x1 conv running int8, with straight-through
    gradients; its parameters are Conv's, so checkpoints and the converter
    see no difference (``buddy_tpu/ops/qconv.py::QConv``)."""

    def __init__(self, in_ch, out_ch, kernel_size, *, bias=True, init_scale=1.0, quant=True):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2, bias=bias,
                         init_scale=init_scale)
        self.kind = {3: "3x3", 1: "1x1"}[kernel_size]
        self.weight_cache = {}
        self._set_quant(quant, in_ch)

    def _local(self, x):
        return self._int8(x)


class FusedUpConv(_Int8, Conv):
    """Nearest-up2, then a 3x3 (pad 1) or 1x1 conv, as one convolution of the
    half-resolution input (K8, ``ops/resample.py``): the float route is one
    transposed convolution with the derived 4x4 or 2x2 kernel; with
    ``quant`` the derived kernel runs int8 through K10
    (``buddy_tpu/models/layers.py::_FusedUpConv``).  Parameter names and
    shapes are the plain conv's; ``float_calls`` counts the float route."""

    float_calls = 0

    def __init__(self, in_ch, out_ch, kernel_size, *, quant=False):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2)
        self.kind = {3: "up3x3", 1: "up1x1"}[kernel_size]
        self.weight_cache = {}
        self.quant = bool(quant)
        if quant:
            self._set_quant(quant, in_ch)

    def _local(self, x):
        if self.quant:
            return self._int8(x)
        FusedUpConv.float_calls += 1
        return R.lhs_dilated_conv(x, Q.float_weight(self.weight, self.kind, x.dtype,
                                                  self.weight_cache), self._bias().to(x.dtype))


def conv3x3(in_ch, out_ch, *, init_scale=1.0, stride=1, bias=True, quant=False,
            dtype=None) -> Conv:
    """A 3x3 (pad 1) conv; ``quant``: int8 (K10), which runs in its input's
    dtype as the JAX package's QConv does, whatever ``dtype``."""
    if quant:
        if stride != 1:
            raise NotImplementedError("int8 convolutions run at stride 1")
        return QConv(in_ch, out_ch, 3, bias=bias, init_scale=init_scale, quant=quant)
    return Conv(in_ch, out_ch, 3, padding=1, stride=stride, bias=bias, init_scale=init_scale,
                dtype=dtype)


def conv1x1(in_ch, out_ch, *, init_scale=1.0, bias=True, quant=False, dtype=None) -> Conv:
    if quant:
        return QConv(in_ch, out_ch, 1, bias=bias, init_scale=init_scale, quant=quant)
    return Conv(in_ch, out_ch, 1, bias=bias, init_scale=init_scale, dtype=dtype)


class Dense(nn.Linear):
    """nn.Linear in the input's dtype, with the DDPM initializer; with
    ``tp``, this rank's slice of the outputs."""

    def init_(self, generator):
        o, i = self.weight.shape
        default_init_(self.weight, 1.0, i, o, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, tp=None):
        w, b = self.weight, self.bias
        if tp is not None:
            blk = tp.block(w.shape[0])
            w, b = w[blk], b[blk]
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def naive_upsample_2d(x, factor: int = 2):
    """Nearest-neighbour x2 (F.interpolate mode='nearest'), written as the
    JAX package writes it: a broadcast of the NHWC storage and a reshape.
    On the card this beats PyTorch's channels_last upsample kernels, which
    the main-path profile found far from the memory bound (PERF.md)."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return y.reshape(b, h * factor, w * factor, c).permute(0, 3, 1, 2)


def naive_downsample_2d(x, factor: int = 2):
    """Average-pool x2, as a mean over the NHWC storage's 2x2 windows."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h // factor, factor, w // factor, factor, c)
    return y.mean(dim=(2, 4)).permute(0, 3, 1, 2)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the noise level; W ~ N(0, scale^2),
    frozen."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.zeros(embedding_size), requires_grad=False)

    def init_(self, generator):
        with torch.no_grad():
            self.W.copy_(torch.randn(self.W.shape, generator=generator) * self.scale)

    def forward(self, x):
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def get_timestep_embedding(timesteps, embedding_dim: int, max_positions: int = 10000):
    """Sinusoidal positional time embedding."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class NIN(nn.Module):
    """Per-position dense C_in -> C_out; W is (in, out) as in the JAX tree."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.init_scale = init_scale
        self.W = nn.Parameter(torch.zeros(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))

    def init_(self, generator):
        i, o = self.W.shape
        default_init_(self.W, self.init_scale, i, o, generator)
        with torch.no_grad():
            self.b.zero_()

    def forward(self, x):
        h = x.permute(0, 2, 3, 1) @ self.W.to(x.dtype) + self.b.to(x.dtype)
        return h.permute(0, 3, 1, 2)


class Combine(nn.Module):
    """Combine a skip-pyramid input with the trunk."""

    def __init__(self, in_ch: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(in_ch, dim2)

    def forward(self, x, y):
        h = self.Conv_0(x)
        return torch.cat([h, y], dim=1) if self.method == "cat" else h + y


class AttnBlockpp(nn.Module):
    """Full (H*W)^2 self-attention block; einsum + softmax as in the JAX
    package (the softmax is taken in float32)."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.GroupNorm_0(x)
        q, k, v = (m(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
                   for m in (self.NIN_0, self.NIN_1, self.NIN_2))
        w = torch.softmax((q @ k.transpose(1, 2)).float() * (C ** -0.5), dim=-1).to(x.dtype)
        h = (w @ v).reshape(B, H, W, C).permute(0, 3, 1, 2)
        h = self.NIN_3(h)
        return x + h if not self.skip_rescale else (x + h) * _INV_SQRT2


class _Resample(nn.Module):
    """x2 resampling between levels, optionally with a 3x3 conv: ``Conv_0``
    without FIR (float32, as the JAX package's, built without a dtype);
    with FIR the raw ``Conv2d_0_weight`` (O, I, 3, 3; the JAX package's is
    HWIO) and ``Conv2d_0_bias`` of a SAME conv on the FIR side; with ``tp``
    that raw weight holds this rank's output channels, as a sharded
    ``Conv``'s."""

    tp = None

    def __init__(self, in_ch: int, out_ch: int | None = None, *, with_conv=False, fir=False,
                 fir_kernel=(1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0_weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
            self.Conv2d_0_bias = nn.Parameter(torch.zeros(out_ch))
        elif with_conv:
            self.Conv_0 = self._conv(in_ch, out_ch)

    def init_(self, generator):
        if self.with_conv and self.fir:
            o, i = self.Conv2d_0_weight.shape[:2]
            default_init_(self.Conv2d_0_weight, 1.0, i * 9, o * 9, generator)
            with torch.no_grad():
                self.Conv2d_0_bias.zero_()

    def _fir_conv(self, x, op):
        """op(x, weight) + bias, the FIR side's raw conv; with ``tp``, on
        this rank's output channels, then gathered."""
        w, b = self.Conv2d_0_weight, self.Conv2d_0_bias
        if self.tp is None:
            return op(x, w) + b[:, None, None]
        h = op(pmesh.copy_to_tp(x, self.tp), w) + b[self.tp.block(b.shape[0])][:, None, None]
        return pmesh.gather_from_tp(h, self.tp)


class Upsample(_Resample):
    """x2 upsampling (``buddy_tpu/models/layers.py::Upsample``): nearest,
    then ``Conv_0``; or FIR, then the raw conv (``upsample_conv_2d``)."""

    @staticmethod
    def _conv(in_ch, out_ch):
        return conv3x3(in_ch, out_ch, dtype=torch.float32)

    def forward(self, x):
        if not self.fir:
            h = naive_upsample_2d(x)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return R.upsample_2d(x, self.fir_kernel, factor=2)
        return self._fir_conv(
            x, lambda v, w: R.upsample_conv_2d(v, w, self.fir_kernel, factor=2))


class Downsample(_Resample):
    """x2 downsampling (``buddy_tpu/models/layers.py::Downsample``): a 2x2
    average, or the input padded by one row and column at the end and a
    VALID stride-2 ``Conv_0``; or the raw conv, then FIR
    (``conv_downsample_2d``), or FIR alone."""

    @staticmethod
    def _conv(in_ch, out_ch):
        return Conv(in_ch, out_ch, 3, stride=2, dtype=torch.float32)

    def forward(self, x):
        if not self.fir:
            return self.Conv_0(F.pad(x, (0, 1, 0, 1))) if self.with_conv \
                else naive_downsample_2d(x)
        if not self.with_conv:
            return R.downsample_2d(x, self.fir_kernel, factor=2)
        return self._fir_conv(
            x, lambda v, w: R.conv_downsample_2d(v, w, self.fir_kernel, factor=2))


class _ResBlock(nn.Module):
    """A residual block; with ``remat`` (set by ``NCSNpp``) its forward is
    recomputed in the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, as the JAX package's ``nn.remat``): the
    values and gradients do not change.  With ``tp`` (``set_tensor_parallel``)
    Conv_0's output stays on this rank's channels through its bias, this
    rank's rows of Dense_0 and GroupNorm_1, and is gathered for Conv_1; its
    ``temb`` must then be the network's ``copy_to_tp`` of it, since each rank's
    Dense_0 rows see only part of its gradient."""

    remat = False
    tp = None

    def forward(self, x, temb=None):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, temb, use_reentrant=False)
        return self._forward(x, temb)

    def _skip(self, x, h):
        return x + h if not self.skip_rescale else (x + h) * _INV_SQRT2

    def _middle(self, h, temb):
        """Conv_0, the time embedding's add and GroupNorm_1, on this rank's
        channels under ``tp`` and gathered after, then Conv_1."""
        tp = self.tp
        h = self.Conv_0.local(h) if tp is not None else self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb), tp)[:, :, None, None]
        h = self.GroupNorm_1(h, tp)
        if tp is not None:
            h = pmesh.gather_from_tp(h, tp)
        return self.Conv_1(h)


class ResnetBlockDDPMpp(_ResBlock):
    """DDPM residual block (``buddy_tpu/models/layers.py::ResnetBlockDDPMpp``):
    GroupNorm and the activation, Conv_0, plus Dense_0 of act(temb),
    GroupNorm and the activation, Conv_1; the shortcut is Conv_2
    (``conv_shortcut``) or NIN_0 where the channels change.  Its convs stay
    float under ``quantize_int8``, as in the JAX package; ``dropout`` is
    the identity, as there."""

    def __init__(self, act, in_ch: int, out_ch: int | None = None, *, conv_shortcut=False,
                 dropout=0.0, skip_rescale=False, init_scale=0.0, temb_dim=None, dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act, self.skip_rescale = act, skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def _forward(self, x, temb=None):
        h = self._middle(self.GroupNorm_0(x), temb)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        return self._skip(x, h)


class ResnetBlockBigGANpp(_ResBlock):
    """BigGAN residual block with optional up / down resampling of h and x:
    nearest-up and 2x2 average, or FIR with ``fir`` (``fir_kernel``).

    ``qconv``: falsy, True or (accum, bwd_quant, static_scale): Conv_0,
    Conv_1 and Conv_2 run int8 (K10).  ``fuse_up``: an up-block without FIR
    folds the nearest-up2 into Conv_0 and Conv_2 (K8, ``FusedUpConv``) and
    upsamples nothing; under FIR it does nothing, as in the JAX package
    (``fused_up = up and not fir and fuse_up``).  ``dtype``: the float
    convs'.  ``dropout`` is the identity, as in the JAX
    package: its ResBlock applies ``nn.Dropout`` with ``deterministic=True``
    by default (``buddy_tpu/models/layers.py:417,458``) and no caller passes
    False, so neither package drops anything, in training or in sampling."""

    def __init__(self, act, in_ch: int, out_ch: int | None = None, *, up=False, down=False,
                 dropout=0.0, fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True,
                 init_scale=0.0, temb_dim=None, qconv=False, fuse_up=False, dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act, self.up, self.down, self.skip_rescale = act, up, down, skip_rescale
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        self.fused_up = up and not fir and fuse_up
        self.GroupNorm_0 = group_norm(in_ch, act)
        self.Conv_0 = FusedUpConv(in_ch, out_ch, 3, quant=qconv) if self.fused_up \
            else conv3x3(in_ch, out_ch, quant=qconv, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale, quant=qconv, dtype=dtype)
        if in_ch != out_ch or up or down:
            self.Conv_2 = FusedUpConv(in_ch, out_ch, 1, quant=qconv) if self.fused_up \
                else conv1x1(in_ch, out_ch, quant=qconv, dtype=dtype)

    def _forward(self, x, temb=None):
        h = self.GroupNorm_0(x)
        if self.up and self.fir:
            h, x = R.upsample_2d(h, self.fir_kernel), R.upsample_2d(x, self.fir_kernel)
        elif self.up and not self.fused_up:
            h, x = naive_upsample_2d(h), naive_upsample_2d(x)
        elif self.down and self.fir:
            h, x = R.downsample_2d(h, self.fir_kernel), R.downsample_2d(x, self.fir_kernel)
        elif self.down:
            h, x = naive_downsample_2d(h), naive_downsample_2d(x)
        h = self._middle(h, temb)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return self._skip(x, h)


def set_tensor_parallel(module: nn.Module, tp) -> list:
    """Put ``module``'s layers in tensor-parallel mode over ``tp`` (a
    ``parallel.mesh.TensorParallel``) while its weights are still whole:
    every conv whose output channels divide (``pmesh.tp_sharded``, the rule
    ``shard_params`` cuts the weights by) computes its rank's channels, and
    every ResBlock keeps Conv_0's output sharded through GroupNorm_1.
    Returns the replicated parameters that each rank uses on its slice
    alone (biases of the sharded convs, the ResBlocks' Dense_0 and
    GroupNorm_1 affine), whose gradients the tp group must sum.  Raises
    ValueError, naming the layer, for a ResBlock whose channels or
    GroupNorm_1 groups do not divide over tp (its statistics would not be
    local) and for int8 convolutions with ``quantize_bwd`` (the backward's
    per-tensor scales would read one rank's slice)."""
    partial = []
    for name, m in module.named_modules():
        if isinstance(m, _Int8) and getattr(m, "bwd_quant", False):
            raise ValueError(f"tensor parallelism with quantize_bwd: {name}'s backward "
                             f"would quantize each rank's slice with its own scales")
        if isinstance(m, Conv) and pmesh.tp_sharded(tuple(m.weight.shape), tp.size):
            m.tp = tp
            if hasattr(m, "weight_cache"):
                m.weight_cache.clear()
            partial += [] if m.bias is None else [m.bias]
        elif isinstance(m, _Resample) and m.with_conv and m.fir and \
                pmesh.tp_sharded(tuple(m.Conv2d_0_weight.shape), tp.size):
            m.tp = tp
            partial.append(m.Conv2d_0_bias)
        elif isinstance(m, _ResBlock):
            c, g = m.GroupNorm_1.weight.shape[0], m.GroupNorm_1.num_groups
            if not (pmesh.tp_sharded(tuple(m.Conv_0.weight.shape), tp.size)
                    and g % tp.size == 0):
                raise ValueError(f"tp={tp.size}: ResBlock {name} has {c} channels in {g} "
                                 f"GroupNorm groups; both must divide by tp")
            m.tp = tp
            partial += [m.GroupNorm_1.weight, m.GroupNorm_1.bias]
            if hasattr(m, "Dense_0"):
                partial += [m.Dense_0.weight, m.Dense_0.bias]
    return partial
