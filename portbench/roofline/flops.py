"""The model's operations a step, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products of the reference U-Net, run on the meta device at the
cell's shapes: so the count is the model's, whatever algorithm the port
picks. A serving step is one forward, plus the input vjp under full
guidance; a train step is one forward and the backward to the weights and
the inputs. The FIR resampling is counted as the reference writes it (a
depthwise convolution of the zero-stuffed grid), under 1% of the total.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.ncsnpp import UNet


def flops_of(fn) -> int:
    """Operations of the matrix products and convolutions ``fn()`` runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def unet_flops(net_cfg: dict, batch: int, n_samples: int, n_fft: int, hop: int, mode: str) -> int:
    """Operations of one step of ``mode`` ("forward", "input_vjp" or "train")."""
    frames = n_samples // hop + 1
    frames += (-frames) % 16
    with torch.device("meta"):
        net = UNet(**net_cfg)
        x = torch.zeros((batch, 1, n_fft // 2 + 1, frames), dtype=torch.complex64)
        t = torch.zeros((batch,))
    if mode == "forward":
        net.requires_grad_(False)
    elif mode == "input_vjp":
        net.requires_grad_(False)
        x.requires_grad_(True)
    elif mode != "train":
        raise ValueError(mode)

    def step():
        y = net(x, t)
        if mode != "forward":
            (y.real.sum() + y.imag.sum()).backward()
    return flops_of(step)
