"""NCSN++ layers as ``nn.Module``s (``buddy_tpu/models/layers.py``).

Tensors are NCHW; the U-Net keeps them in channels_last memory format, so
they lie in memory as the JAX package's NHWC arrays do.  Submodule and
parameter names follow the JAX package's (``GroupNorm_0``, ``Conv_0``,
``Dense_0``, ``NIN_0`` ...), so ``models/convert.py`` maps the two parameter
trees one to one.  Convolutions and dense layers run in the dtype of their
input (their float32 weights are cast per call), which is how the JAX
package's ``dtype=compute_dtype`` layers behave.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from buddy_tpu_torch.ops.groupnorm import group_norm_act

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

    def forward(self, x):
        fused = self.act is F.silu
        y = group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps, silu=fused)
        if self.act is not None and not fused:
            y = self.act(y)
        return y


def group_norm(ch: int, act=None) -> GroupNormAct:
    """GroupNorm(min(ch//4, 32), eps=1e-6) — the reference's uniform choice."""
    return GroupNormAct(ch, min(ch // 4, 32), 1e-6, act)


class Conv(nn.Conv2d):
    """nn.Conv2d in the input's dtype, with the DDPM initializer."""

    def __init__(self, in_ch, out_ch, kernel_size, *, padding=0, stride=1, bias=True,
                 init_scale=1.0):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding, bias=bias)
        self.init_scale = init_scale

    def init_(self, generator):
        o, i, kh, kw = self.weight.shape
        default_init_(self.weight, self.init_scale, i * kh * kw, o * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


def conv3x3(in_ch, out_ch, *, init_scale=1.0, stride=1, bias=True) -> Conv:
    return Conv(in_ch, out_ch, 3, padding=1, stride=stride, bias=bias, init_scale=init_scale)


def conv1x1(in_ch, out_ch, *, init_scale=1.0, bias=True) -> Conv:
    return Conv(in_ch, out_ch, 1, bias=bias, init_scale=init_scale)


class Dense(nn.Linear):
    """nn.Linear in the input's dtype, with the DDPM initializer."""

    def init_(self, generator):
        o, i = self.weight.shape
        default_init_(self.weight, 1.0, i, o, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


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


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with optional nearest-up / avg-pool-down
    resampling (the FIR resampling path is not ported)."""

    def __init__(self, act, in_ch: int, out_ch: int | None = None, *, up=False, down=False,
                 dropout=0.0, fir=False, skip_rescale=True, init_scale=0.0, temb_dim=None):
        super().__init__()
        if fir:
            raise NotImplementedError("FIR resampling is not ported")
        if dropout:
            raise NotImplementedError("dropout is not ported (inference only)")
        out_ch = out_ch or in_ch
        self.act, self.up, self.down, self.skip_rescale = act, up, down, skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNorm_1 = group_norm(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def forward(self, x, temb=None):
        h = self.GroupNorm_0(x)
        if self.up:
            h, x = naive_upsample_2d(h), naive_upsample_2d(x)
        elif self.down:
            h, x = naive_downsample_2d(h), naive_downsample_2d(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.GroupNorm_1(h)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h if not self.skip_rescale else (x + h) * _INV_SQRT2
