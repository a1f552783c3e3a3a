"""NCSN++ (Song et al., arXiv 2011.13456; yang-song/score_sde
``models/ncsnpp.py``) over complex STFT spectrograms, as BUDDy wraps it,
in plain float32 PyTorch.

The configurations the benchmark runs: BigGAN ResBlocks, Fourier time
embedding, the middle attention block, ``progressive`` output_skip or
residual, ``progressive_input`` input_skip or residual (``combine`` sum),
nearest or FIR (``fir_kernel``) resampling. Module and parameter names are
the port's (``all_modules.<i>.Conv_0.weight`` ...), so a state dict made
for one loads into the other. ``TimeNet`` wraps the U-Net with the 510/128
reflect STFT, frames padded to a multiple of 16, and the ISTFT cropped to
the input length.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.signal import Stft, hann

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class GroupNorm(nn.Module):
    def __init__(self, ch: int, act: bool):
        super().__init__()
        self.groups, self.act = min(ch // 4, 32), act
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        y = F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-6)
        return F.silu(y) if self.act else y


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


def conv3x3(cin, cout):
    return Conv(cin, cout, 3, padding=1)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class NIN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return torch.einsum("bchw,cd->bdhw", x, self.W) + self.b[:, None, None]


class Fourier(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.W = nn.Parameter(torch.zeros(size), requires_grad=False)

    def forward(self, t):
        p = t[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(p), torch.cos(p)], dim=-1)


def fir_taps(k, gain: float) -> torch.Tensor:
    """The separable FIR kernel of ``k``: outer product over its sum, times gain."""
    k = np.asarray(k, np.float32)
    k2 = np.outer(k, k)
    return torch.from_numpy(k2 / k2.sum() * np.float32(gain))


def upfirdn(x, taps: torch.Tensor, up: int, down: int, pad0: int, pad1: int):
    """Zero-stuff by ``up``, pad, convolve with ``taps``, keep every ``down``-th
    sample, on both spatial axes of x (B, C, H, W)."""
    B, C, H, W = x.shape
    z = x.new_zeros((B, C, H * up, W * up))
    z[:, :, ::up, ::up] = x
    z = F.pad(z, (pad0, pad1, pad0, pad1))
    w = taps.flip(0, 1).to(x).expand(C, 1, *taps.shape)
    return F.conv2d(z, w, groups=C)[:, :, ::down, ::down]


def fir_up(x, k):
    taps = fir_taps(k, 4.0)
    p = taps.shape[0] - 2
    return upfirdn(x, taps, 2, 1, (p + 1) // 2 + 1, p // 2)


def fir_down(x, k):
    taps = fir_taps(k, 1.0)
    p = taps.shape[0] - 2
    return upfirdn(x, taps, 1, 2, (p + 1) // 2, p // 2)


def nearest_up(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def mean_down(x):
    return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """BigGAN ResBlock with optional up / down resampling of h and x."""

    def __init__(self, cin, cout=None, up=False, down=False, fir=False, fir_kernel=(1, 3, 3, 1),
                 temb_dim=None):
        super().__init__()
        cout = cout or cin
        self.up, self.down, self.fir, self.fir_kernel = up, down, fir, tuple(fir_kernel)
        self.GroupNorm_0 = GroupNorm(cin, True)
        self.Conv_0 = conv3x3(cin, cout)
        self.Dense_0 = Dense(temb_dim, cout)
        self.GroupNorm_1 = GroupNorm(cout, True)
        self.Conv_1 = conv3x3(cout, cout)
        if cin != cout or up or down:
            self.Conv_2 = Conv(cin, cout, 1)

    def _resample(self, t):
        if self.up:
            return fir_up(t, self.fir_kernel) if self.fir else nearest_up(t)
        if self.down:
            return fir_down(t, self.fir_kernel) if self.fir else mean_down(t)
        return t

    def forward(self, x, temb):
        h = self._resample(self.GroupNorm_0(x))
        x = self._resample(x)
        h = self.Conv_0(h) + self.Dense_0(F.silu(temb))[:, :, None, None]
        h = self.Conv_1(self.GroupNorm_1(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return (x + h) * _INV_SQRT2


class Attn(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(ch, False)
        self.NIN_0, self.NIN_1, self.NIN_2, self.NIN_3 = (NIN(ch, ch) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.GroupNorm_0(x)
        q, k, v = (m(h).reshape(B, C, H * W) for m in (self.NIN_0, self.NIN_1, self.NIN_2))
        w = torch.softmax(torch.einsum("bci,bcj->bij", q, k) * C ** -0.5, dim=-1)
        h = torch.einsum("bij,bcj->bci", w, v).reshape(B, C, H, W)
        return (x + self.NIN_3(h)) * _INV_SQRT2


class FirResample(nn.Module):
    """A residual pyramid's FIR resampling with its 3x3 conv
    (``Conv2d_0_weight``, ``Conv2d_0_bias``): conv then FIR down, or FIR up
    then conv."""

    def __init__(self, cin, cout, up: bool, fir_kernel):
        super().__init__()
        self.up, self.fir_kernel = up, tuple(fir_kernel)
        self.Conv2d_0_weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.Conv2d_0_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        conv = lambda t: F.conv2d(t, self.Conv2d_0_weight, padding=1)
        h = conv(fir_up(x, self.fir_kernel)) if self.up else fir_down(conv(x), self.fir_kernel)
        return h + self.Conv2d_0_bias[:, None, None]


class Combine(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 1)

    def forward(self, x, y):
        return self.Conv_0(x) + y


class UNet(nn.Module):
    """NCSN++ over (B, 1, F, T) complex spectrograms."""

    def __init__(self, nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=1, fir=False,
                 fir_kernel=(1, 3, 3, 1), progressive="output_skip",
                 progressive_input="input_skip", **_ignored):
        super().__init__()
        if (progressive, progressive_input) not in (("output_skip", "input_skip"),
                                                    ("residual", "residual")):
            raise NotImplementedError((progressive, progressive_input))
        if progressive == "residual" and not fir:
            raise NotImplementedError("residual pyramids without FIR")
        self.ch_mult, self.num_res_blocks, self.progressive = tuple(ch_mult), num_res_blocks, \
            progressive
        temb = nf * 4
        rb = lambda cin, cout=None, **kw: ResBlock(cin, cout, fir=fir, fir_kernel=fir_kernel,
                                                    temb_dim=temb, **kw)
        m = [Fourier(nf), Dense(2 * nf, temb), Dense(temb, temb), conv3x3(2, nf)]
        hs_c, in_ch, pyr_ch = [nf], nf, 2
        n_res = len(self.ch_mult)
        for i in range(n_res):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i]
                m.append(rb(in_ch, out_ch))
                in_ch = out_ch
                hs_c.append(in_ch)
            if i != n_res - 1:
                m.append(rb(in_ch, down=True))
                if progressive_input == "input_skip":
                    m.append(Combine(pyr_ch, in_ch))
                else:
                    m.append(FirResample(pyr_ch, in_ch, False, fir_kernel))
                    pyr_ch = in_ch
                hs_c.append(in_ch)
        in_ch = hs_c[-1]
        m += [rb(in_ch), Attn(in_ch), rb(in_ch)]
        pyr_ch = 0
        for i in reversed(range(n_res)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i]
                m.append(rb(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if progressive == "output_skip":
                m += [GroupNorm(in_ch, False), conv3x3(in_ch, 2)]
            elif i == n_res - 1:
                m += [GroupNorm(in_ch, False), conv3x3(in_ch, in_ch)]
            else:
                m.append(FirResample(pyr_ch, in_ch, True, fir_kernel))
            pyr_ch = in_ch
            if i != 0:
                m.append(rb(in_ch, up=True))
        if progressive != "output_skip":
            m += [GroupNorm(in_ch, False), conv3x3(in_ch, 2)]
        self.all_modules = nn.ModuleList(m)
        self.output_layer = Conv(2, 2, 1)

    def forward(self, x, t):
        mods = iter(self.all_modules)
        h0 = torch.stack([x[:, 0].real, x[:, 0].imag], dim=1)
        temb = next(mods)(t)
        temb = next(mods)(temb)
        temb = next(mods)(F.silu(temb))
        n_res = len(self.ch_mult)
        pyramid_in = h0
        hs = [next(mods)(h0)]
        for i in range(n_res):
            for _ in range(self.num_res_blocks):
                hs.append(next(mods)(hs[-1], temb))
            if i != n_res - 1:
                h = next(mods)(hs[-1], temb)
                if self.progressive == "output_skip":
                    pyramid_in = mean_down(pyramid_in)
                    h = next(mods)(pyramid_in, h)
                else:
                    pyramid_in = (next(mods)(pyramid_in) + h) * _INV_SQRT2
                    h = pyramid_in
                hs.append(h)
        h = next(mods)(hs[-1], temb)
        h = next(mods)(h)
        h = next(mods)(h, temb)
        pyramid = None
        for i in reversed(range(n_res)):
            for _ in range(self.num_res_blocks + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb)
            if self.progressive == "output_skip":
                norm, conv = next(mods), next(mods)
                p = conv(F.silu(norm(h)))
                pyramid = p if pyramid is None else nearest_up(pyramid) + p
            elif i == n_res - 1:
                norm, conv = next(mods), next(mods)
                pyramid = conv(F.silu(norm(h)))
            else:
                pyramid = (next(mods)(pyramid) + h) * _INV_SQRT2
                h = pyramid
            if i != 0:
                h = next(mods)(h, temb)
        if self.progressive != "output_skip":
            norm, conv = next(mods), next(mods)
            pyramid = conv(F.silu(norm(h)))
        h = self.output_layer(pyramid)
        return torch.complex(h[:, 0:1], h[:, 1:2])


class TimeNet(nn.Module):
    """The U-Net between a 510/128 reflect STFT and its ISTFT:
    (B, 1, T) waveform, noise conditioning (B,) -> (B, 1, T)."""

    def __init__(self, n_fft=510, hop_length=128, device=None, **net):
        super().__init__()
        self.unet = UNet(**net)
        self.spec = Stft(n_fft, hop_length, hann(n_fft), "reflect", device)

    def forward(self, x, cnoise):
        T = x.shape[-1]
        spec = self.spec.stft(x)
        spec = F.pad(spec, (0, (-spec.shape[-1]) % 16))
        return self.spec.istft(self.unet(spec, cnoise), T)


class EDM:
    """D(x, sigma) = cskip x + cout net(cin x, cnoise) (Karras et al. 2022)."""

    def __init__(self, sigma_data: float = 0.05, sigma_min: float = 1e-5, sigma_max: float = 10.0,
                 rho: float = 10.0, **_ignored):
        self.sd, self.smin, self.smax, self.rho = float(sigma_data), float(sigma_min), \
            float(sigma_max), float(rho)

    def coefficients(self, sigma):
        sd = self.sd
        return (sd ** 2 / (sigma ** 2 + sd ** 2), sigma * sd * (sd ** 2 + sigma ** 2) ** -0.5,
                (sd ** 2 + sigma ** 2) ** -0.5)

    def denoise(self, net, x, sigma: float):
        """x (B, n) at the noise level ``sigma`` -> the denoised (B, n)."""
        s = torch.tensor(sigma, dtype=x.dtype, device=x.device)
        cskip, cout, cin = self.coefficients(s)
        cnoise = (0.25 * torch.log(s)).expand(x.shape[0])
        return cskip * x + cout * net(cin * x[:, None], cnoise)[:, 0]
