"""(d) The operation and byte counters against hand counts: one 3x3
convolution, one K1 call each way, one K11 launch, and the U-Net's
forward."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench.roofline import PEAK_BYTES_PER_S, bound_s
from portbench.roofline.flops import flops_of, unet_flops
from portbench.roofline.kernels import k1_bytes, k11_bytes


def test_conv_flops_by_hand():
    with torch.device("meta"):
        x = torch.zeros(8, 128, 256, 528)
        w = torch.zeros(128, 128, 3, 3)
    # 2 operations a multiply-add, 128 x 9 of them an output, 8 x 128 x 256 x 528 outputs
    assert flops_of(lambda: F.conv2d(x, w, padding=1)) == 2 * 128 * 9 * 8 * 128 * 256 * 528


def test_k1_bytes_by_hand():
    n = 8 * 128 * 256 * 528
    assert k1_bytes((8, 128, 256, 528), "torch.bfloat16", False) == 2 * n * 2
    assert k1_bytes((8, 128, 256, 528), "torch.bfloat16", True) == 3 * n * 2
    assert k1_bytes((16, 128, 256, 528), "torch.float32", False) == 2 * 2 * n * 4
    # PERF.md's bound of K1 forward at the main path: 0.165 ms
    assert bound_s(k1_bytes((8, 128, 256, 528), "torch.bfloat16", False)) * 1e3 == \
        pytest.approx(0.165, abs=1e-3)


def test_k11_bytes_by_hand():
    # the top up-block: (8, 256, 128, 264) -> (8, 256, 256, 528), float32;
    # PERF.md's bound 0.413 ms
    b = k11_bytes((8, 256, 128, 264), 256, 528)
    assert b == 4 * 8 * 256 * (128 * 264 + 256 * 528)
    assert b / PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.413, abs=1e-3)


def test_unet_forward_and_vjp():
    cfg = dict(nf=8, ch_mult=[1, 2], num_res_blocks=1)
    fwd = unet_flops(cfg, 2, 4096, 510, 128, "forward")
    vjp = unet_flops(cfg, 2, 4096, 510, 128, "input_vjp")
    train = unet_flops(cfg, 2, 4096, 510, 128, "train")
    assert fwd > 0 and fwd < vjp < train
    assert unet_flops(cfg, 4, 4096, 510, 128, "forward") == 2 * fwd
