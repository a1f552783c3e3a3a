"""NCSN++ score U-Net over complex STFT spectrograms (``buddy_tpu/models/ncsnpp.py``).

The module-construction loop mirrors the JAX package's ``all_modules``
ordering exactly (``all_modules.{i}`` here is ``all_modules_{i}`` there), so
``models/convert.py`` maps the parameter trees one to one.  With
``compute_dtype="bfloat16"`` the body runs in bfloat16 in channels_last
memory format; the STFT, the GroupNorm statistics and the output layer stay
float32, and so do the convs the JAX package builds without a dtype (the
residual pyramids', the ddpm Upsample / Downsample and the last conv),
which promote what follows them to float32 as flax does.

The whole configuration space of the JAX package's NCSN++ is ported:
``resblock_type`` biggan or ddpm (with the Upsample / Downsample between
levels that ``resamp_with_conv`` configures), FIR resampling (``fir``,
``fir_kernel``; float32 only: with ``compute_dtype="bfloat16"`` it raises,
as the JAX package fails there), ``progressive`` none, output_skip or
residual, ``progressive_input`` none, input_skip or residual, fourier or
positional embedding, ``dropout`` (the identity, as in the JAX package),
``remat`` (each ResBlock recomputed in the backward pass), the int8 BigGAN
ResBlock convolutions (``quantize_int8`` with ``quantize_accum``,
``quantize_bwd`` and ``quantize_static``: kernel K10) and the fused
up-convolutions (``fuse_resample``: K8; nothing under FIR).

``set_tensor_parallel(tp)`` shards the network's convolutions over a tp
line of ranks (``models/layers.py``); the time embedding then reaches the
ResBlocks through ``copy_to_tp``, which sums over the group the parts of
its gradient that each rank's Dense_0 rows give.  Without it (tp=1) the
module is the one-process network, with no extra op.

``NCSNppTimeModule`` wraps the U-Net with the 510/128 reflect STFT, the
pad-frames-to-16 rule and the ISTFT cropped to the input length.
"""

from __future__ import annotations

import inspect
import math

import torch
import torch.nn as nn

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.models import layers as L
from buddy_tpu_torch.ops.stft import STFT, hann_window, pad_spec_frames
from buddy_tpu_torch.parallel import mesh as pmesh

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_DTYPES = {None: None, "none": None, "float32": None, "bfloat16": torch.bfloat16}


class NCSNpp(nn.Module):
    """NCSN++ over (B, spatial_channels, F, T) complex spectrograms."""

    def __init__(self, nonlinearity="swish", nf=128, ch_mult=(1, 2, 2, 2), num_res_blocks=1,
                 attn_resolutions=(0,), resamp_with_conv=True, time_conditional=True,
                 fir=False, fir_kernel=(1, 3, 3, 1), skip_rescale=True, resblock_type="biggan",
                 progressive="output_skip", progressive_input="input_skip",
                 progressive_combine="sum", init_scale=0.0, fourier_scale=16.0,
                 image_size=256, embedding_type="fourier", input_channels=2,
                 spatial_channels=1, dropout=0.0, centered=True, discriminative=False,
                 compute_dtype=None, quantize_int8=False, quantize_accum="int32",
                 quantize_bwd=False, quantize_static=False, fuse_resample=False, remat=False):
        super().__init__()
        if resblock_type not in ("ddpm", "biggan"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {progressive!r}")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {progressive_input!r}")
        if fir and _DTYPES[compute_dtype] is not None:
            raise ValueError(
                "fir=True with compute_dtype='bfloat16': the JAX package has no FIR path under a "
                "bfloat16 body (its FIR convolution meets bfloat16 activations with a float32 "
                "kernel and raises TypeError in lax.conv_general_dilated); run FIR in float32")
        # the int8 convolutions are the BigGAN ResBlocks' Conv_0, Conv_1 and
        # Conv_2; the attention NINs, Combine, the pyramid, input and output
        # convs, Dense_0 and the ddpm ResBlocks stay float
        # (buddy_tpu/models/ncsnpp.py:128-136)
        qcfg = (quantize_accum, quantize_bwd, quantize_static) if quantize_int8 else False
        if qcfg:
            L.quant_config(qcfg)
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(embedding_type)
        self.act = act = L.get_act(nonlinearity)
        self.nf, self.ch_mult = nf, tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.progressive, self.progressive_input = progressive, progressive_input
        self.embedding_type, self.centered = embedding_type, centered
        self.skip_rescale, self.resblock_type = skip_rescale, resblock_type
        self.spatial_channels = spatial_channels
        self.compute_dtype = _DTYPES[compute_dtype]
        if discriminative:
            time_conditional, input_channels = False, 2
        self.time_conditional = time_conditional
        self.input_channels = input_channels
        total_channels = input_channels * spatial_channels
        num_resolutions = len(self.ch_mult)
        all_resolutions = [image_size // (2 ** i) for i in range(num_resolutions)]
        combine = progressive_combine.lower()
        temb_dim = nf * 4 if time_conditional else None

        f32 = torch.float32     # the JAX package's convs built without a dtype

        def resblock(in_ch, out_ch=None, up=False, down=False):
            # a float32 tensor reaches a ResBlock after a residual pyramid's
            # sum; its convs run in the body's dtype all the same
            common = dict(dropout=dropout, skip_rescale=skip_rescale, init_scale=init_scale,
                          temb_dim=temb_dim, dtype=self.compute_dtype)
            if resblock_type == "ddpm":
                m = L.ResnetBlockDDPMpp(act, in_ch, out_ch, **common)
            else:
                m = L.ResnetBlockBigGANpp(act, in_ch, out_ch, up=up, down=down, fir=fir,
                                          fir_kernel=fir_kernel, qconv=qcfg,
                                          fuse_up=fuse_resample, **common)
            m.remat = remat
            return m

        def resample(cls, in_ch, out_ch=None, with_conv=resamp_with_conv):
            return cls(in_ch, out_ch, with_conv=with_conv, fir=fir, fir_kernel=fir_kernel)

        def attn(ch):
            return L.AttnBlockpp(ch, skip_rescale=skip_rescale, init_scale=init_scale)

        modules = []
        if time_conditional:
            if embedding_type == "fourier":
                modules.append(L.GaussianFourierProjection(nf, fourier_scale))
                embed_dim = 2 * nf
            else:
                embed_dim = nf
            modules.append(L.Dense(embed_dim, nf * 4))
            modules.append(L.Dense(nf * 4, nf * 4))

        modules.append(L.conv3x3(total_channels, nf))
        hs_c = [nf]
        in_ch = nf
        input_pyramid_ch = total_channels
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resblock(in_ch, out_ch))
                in_ch = out_ch
                if all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(attn(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                modules.append(resample(L.Downsample, in_ch) if resblock_type == "ddpm"
                               else resblock(in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(L.Combine(input_pyramid_ch, in_ch, method=combine))
                    if combine == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(resample(L.Downsample, input_pyramid_ch, in_ch, True))
                    input_pyramid_ch = in_ch
                hs_c.append(in_ch)

        in_ch = hs_c[-1]
        modules += [resblock(in_ch), attn(in_ch), resblock(in_ch)]
        pyramid_ch = 0

        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * self.ch_mult[i_level]
                modules.append(resblock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if all_resolutions[i_level] in self.attn_resolutions:
                modules.append(attn(in_ch))
            if progressive == "output_skip":
                modules.append(L.group_norm(in_ch))
                modules.append(L.conv3x3(in_ch, total_channels, init_scale=init_scale))
            elif progressive == "residual" and i_level == num_resolutions - 1:
                modules.append(L.group_norm(in_ch))
                modules.append(L.conv3x3(in_ch, in_ch, dtype=f32))
            elif progressive == "residual":
                modules.append(resample(L.Upsample, pyramid_ch, in_ch, True))
            pyramid_ch = in_ch
            if i_level != 0:
                modules.append(resample(L.Upsample, in_ch) if resblock_type == "ddpm"
                               else resblock(in_ch, up=True))
        assert not hs_c
        if progressive != "output_skip":
            modules.append(L.group_norm(in_ch))
            modules.append(L.conv3x3(in_ch, total_channels, init_scale=init_scale, dtype=f32))

        self.all_modules = nn.ModuleList(modules)
        self.output_layer = L.Conv(total_channels, 2 * spatial_channels, 1)
        self.tp = None

    def init_(self, generator: torch.Generator) -> None:
        """Random init: DDPM variance scaling for convs and dense layers (as
        the JAX package's ``default_init``), lecun-normal output layer."""
        for m in self.all_modules.modules():
            if hasattr(m, "init_"):
                m.init_(generator)
        w = self.output_layer.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w[0].numel()))
            self.output_layer.bias.zero_()

    def set_tensor_parallel(self, tp) -> list:
        """Shard the convolutions over ``tp`` (``layers.set_tensor_parallel``;
        call it while the weights are whole, then ``parallel.shard_params``
        cuts them).  Returns the replicated parameters each rank uses on its
        slice alone."""
        partial = L.set_tensor_parallel(self, tp)
        self.tp = tp
        return partial

    def forward(self, x, time_cond=None):
        """x: (B, spatial_channels, F, T) complex -> same-shape complex."""
        act, modules = self.act, self.all_modules
        cdtype = self.compute_dtype or torch.float32
        m_idx = 0
        num_resolutions = len(self.ch_mult)
        chans = []
        for chan in range(self.spatial_channels):
            for in_chan in range(self.input_channels // 2):
                xc = x[:, chan + in_chan]
                chans.extend([xc.real, xc.imag])
        h0 = torch.stack(chans, dim=1).to(cdtype).contiguous(memory_format=torch.channels_last)

        temb = None
        if self.time_conditional and time_cond is not None:
            if self.embedding_type == "fourier":
                temb = modules[m_idx](time_cond)
                m_idx += 1
            else:
                temb = L.get_timestep_embedding(time_cond, self.nf)
            temb = modules[m_idx](temb.to(cdtype))
            m_idx += 1
            temb = modules[m_idx](act(temb))
            m_idx += 1
            if self.tp is not None:     # every ResBlock reads its Dense_0 rows alone
                temb = pmesh.copy_to_tp(temb, self.tp)

        if not self.centered:
            h0 = 2 * h0 - 1.0
        input_pyramid = h0 if self.progressive_input != "none" else None

        hs = [modules[m_idx](h0)]
        m_idx += 1
        for i_level in range(num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb)
                m_idx += 1
                if h.shape[2] in self.attn_resolutions:
                    h = modules[m_idx](h)
                    m_idx += 1
                hs.append(h)
            if i_level != num_resolutions - 1:
                h = modules[m_idx](hs[-1]) if self.resblock_type == "ddpm" \
                    else modules[m_idx](hs[-1], temb)
                m_idx += 1
                if self.progressive_input == "input_skip":
                    input_pyramid = L.naive_downsample_2d(input_pyramid)
                    h = modules[m_idx](input_pyramid, h)
                    m_idx += 1
                elif self.progressive_input == "residual":
                    input_pyramid = self._skip(modules[m_idx](input_pyramid), h)
                    h = input_pyramid
                    m_idx += 1
                hs.append(h)

        h = hs[-1]
        h = modules[m_idx](h, temb)
        h = modules[m_idx + 1](h)
        h = modules[m_idx + 2](h, temb)
        m_idx += 3

        pyramid = None
        for i_level in reversed(range(num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb)
                m_idx += 1
            if h.shape[2] in self.attn_resolutions:
                h = modules[m_idx](h)
                m_idx += 1
            if self.progressive == "output_skip":
                pyramid_h = modules[m_idx + 1](act(modules[m_idx](h)))
                m_idx += 2
                pyramid = pyramid_h if pyramid is None else \
                    L.naive_upsample_2d(pyramid) + pyramid_h
            elif self.progressive == "residual" and i_level == num_resolutions - 1:
                pyramid = modules[m_idx + 1](act(modules[m_idx](h)))
                m_idx += 2
            elif self.progressive == "residual":
                pyramid = self._skip(modules[m_idx](pyramid), h)
                h = pyramid
                m_idx += 1
            if i_level != 0:
                h = modules[m_idx](h) if self.resblock_type == "ddpm" \
                    else modules[m_idx](h, temb)
                m_idx += 1
        assert not hs

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = modules[m_idx + 1](act(modules[m_idx](h)))
            m_idx += 2
        assert m_idx == len(modules)

        h = self.output_layer(h.float())                      # (B, 2*spatial, F, T)
        s = self.spatial_channels
        return torch.complex(h[:, 0:s], h[:, s:2 * s]).contiguous()

    def _skip(self, a, b):
        """A residual pyramid's sum, rescaled by 1/sqrt(2) under skip_rescale."""
        return (a + b) * _INV_SQRT2 if self.skip_rescale else a + b


class NCSNppTimeModule(nn.Module):
    """NCSN++ wrapped with STFT/ISTFT: (B, C, T) waveform -> hann STFT ->
    pad frames to 16 -> NCSNpp -> ISTFT cropped to the input length."""

    def __init__(self, n_fft: int = 510, hop_length: int = 128, device=None, **net_kwargs):
        super().__init__()
        device = resolve_device(device)
        self.n_fft, self.hop_length = n_fft, hop_length
        self.unet = NCSNpp(**net_kwargs)
        self.spec = STFT(n_fft, hop_length, hann_window(n_fft), pad_mode="reflect",
                         device=device)
        self.to(device)

    def set_tensor_parallel(self, tp) -> list:
        return self.unet.set_tensor_parallel(tp)

    def forward(self, x, time_cond=None):
        T = x.shape[-1]
        spec = pad_spec_frames(self.spec.stft(x), 16)       # (B, C, F, frames)
        spec = self.unet(spec, time_cond)
        return self.spec.istft(spec, T)


_NET_KEYS = set(inspect.signature(NCSNpp).parameters)


def NCSNppTime(stft=None, device=None, seed: int = 0, **kwargs) -> NCSNppTimeModule:
    """Config entry point (conf/network/ncsnpp.yaml ``_target_``): the
    network on ``device`` (the card unless ``device="cpu"``), randomly
    initialized from ``seed``.  ``quantize_int8`` runs the ResBlock convs
    int8 (K10) with its tuning keys ``quantize_accum``, ``quantize_bwd`` and
    ``quantize_static`` (calibrated scales: ``NetworkBundle.calibrate_quant``
    first), which change nothing while it is off; ``fuse_resample`` folds
    nearest-up2 into the up-ResBlocks' convs (K8); ``remat`` recomputes each
    ResBlock in the backward pass.  None of them changes the weights."""
    if stft is None:
        raise ValueError("stft must be provided")
    net_kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in kwargs.items() if k in _NET_KEYS}
    module = NCSNppTimeModule(int(stft["n_fft"]), int(stft["hop_length"]),
                              device=resolve_device(device), **net_kwargs)
    module.unet.init_(torch.Generator().manual_seed(seed))
    return module
