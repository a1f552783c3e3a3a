"""The tiling of K10's Hopper convolution (``buddy_tpu_torch/csrc/qconv_sm90.cu``,
``qc_conv_sm90_kernel``) mirrored in plain PyTorch on the CPU.

The kernel needs the card; what surrounds it is Python that runs here: the
halo plan ``int8_conv`` hands it (``ops/qconv.py::halo_plan``) and the route
rule.  The mirror does what the kernel does with the plan: it cuts the input
into tiles of 8 x 16 pixels, loads each tile's box as TMA does (zero outside
the tensor), reads every tap's A rows from that one box at the tap's pixel
offset, sums the products of each 128-channel chunk in int64, and writes
each phase's tile, cut at the ragged edge, to its output positions.  Grids
whose H and W are not multiples of the tile reach the edge tiles.  The
result must equal the port's plain version and the JAX package's
``_int8_conv`` bit for bit, for every kind and an adjoint with C_in and
C_out swapped.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import torch_compose

from buddy_tpu.ops import qconv as J
from buddy_tpu_torch.ops import qconv as Q

# kind -> (JAX kernel size, padding, lhs_dilation), as tests/test_torch_int8.py
JAX_KINDS = {"3x3": (3, ((1, 1), (1, 1)), (1, 1)), "1x1": (1, ((0, 0), (0, 0)), (1, 1)),
             "up3x3": (4, ((2, 2), (2, 2)), (2, 2)), "up1x1": (2, ((1, 1), (1, 1)), (2, 2))}
CHUNK = 128


def tiled_conv(x_q: torch.Tensor, w_q: torch.Tensor, kind: str) -> torch.Tensor:
    """The int32 sums (B, Ho, Wo, O) as ``qc_conv_sm90_kernel`` forms them
    from ``halo_plan(kind)``."""
    plan = Q.halo_plan(kind)
    rows, cols = plan.rows, plan.cols
    phases, ntaps, replicate, _ = Q.tap_table(kind)
    B, H, W, C = x_q.shape
    O = w_q.shape[1]
    ty, tx = -(-H // rows), -(-W // cols)
    # the input as the tensor map reads it: zero outside the tensor
    xp = torch.zeros((B, ty * rows + plan.box_h - rows, tx * cols + plan.box_w - cols, C),
                     dtype=torch.int64)
    xp[:, -plan.lo_y:-plan.lo_y + H, -plan.lo_x:-plan.lo_x + W] = x_q.long()
    # each tile's box, row-major pixels: (B, ty, tx, box_h * box_w, C)
    boxes = xp.unfold(1, plan.box_h, rows).unfold(2, plan.box_w, cols)
    boxes = boxes.permute(0, 1, 2, 4, 5, 3).reshape(B, ty, tx, plan.box_h * plan.box_w, C)
    # a tile's pixel m = r * cols + c at box pixel r * box_w + c (tap offset 0)
    pix = (torch.arange(rows)[:, None] * plan.box_w + torch.arange(cols)).reshape(-1)
    up = kind.startswith("up")
    Ho, Wo = (2 * H, 2 * W) if up else (H, W)
    y = torch.zeros((B, Ho, Wo, O), dtype=torch.int64)
    for ph in range(phases):
        acc = torch.zeros((B, ty, tx, rows * cols, O), dtype=torch.int64)
        for c0 in range(0, C, CHUNK):
            for off, t in plan.taps[ph * ntaps:(ph + 1) * ntaps]:
                acc += boxes[..., pix + off, c0:c0 + CHUNK] @ w_q[t, :, c0:c0 + CHUNK].long().T
        grid = acc.reshape(B, ty, tx, rows, cols, O).permute(0, 1, 3, 2, 4, 5)
        grid = grid.reshape(B, ty * rows, tx * cols, O)[:, :H, :W]
        if not up:
            y = grid
        elif replicate:
            for r in (0, 1):
                for s in (0, 1):
                    y[:, r::2, s::2] = grid
        else:
            y[:, ph >> 1::2, ph & 1::2] = grid
    return y.to(torch.int32)


def _int8(rng, shape):
    """int8 values over [-127, 127], a tenth of them at the ends."""
    v = rng.integers(-127, 128, size=shape)
    ends = rng.random(shape) < 0.1
    return np.where(ends, np.sign(v + 0.5) * 127, v).astype(np.int8)


def _jax_sums(xq, wq, kind):
    k, pads, ld = JAX_KINDS[kind]
    w = wq.reshape(k, k, wq.shape[1], wq.shape[2]).transpose(0, 1, 3, 2)
    one = jnp.ones((), jnp.int32)
    return np.asarray(jax.jit(lambda a, b: J._int8_conv(a, b, (1, 1), pads, "int32", jnp.int32,
                                                        one, ld))(jnp.asarray(xq), jnp.asarray(w)))


# kind, B, H, W, C_in, C_out: H and W off the 8 x 16 tile; C_in two chunks
CASES = {
    "3x3": ("3x3", 2, 11, 21, 256, 128),
    "1x1": ("1x1", 2, 13, 37, 256, 128),
    "up3x3": ("up3x3", 1, 9, 19, 128, 128),
    "up1x1": ("up1x1", 1, 9, 19, 128, 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_sums_equal_plain_and_jax(case):
    """The mirror of the kernel's tiling gives the plain version's and the
    JAX package's int32 sums bit for bit, edge tiles included."""
    kind, B, H, W, cin, cout = CASES[case]
    rng = np.random.default_rng(11)
    k = Q._KSIZE[kind]
    xq = _int8(rng, (B, H, W, cin))
    wq = _int8(rng, (k * k, cout, cin))
    if kind == "up1x1":
        # the derived 2x2 of a 1x1 (ops/resample.py::up2_derived): four equal taps
        wq = np.repeat(wq[:1], 4, axis=0)
    got = tiled_conv(torch.from_numpy(xq), torch.from_numpy(wq), kind)
    want = Q.int8_conv_plain(torch.from_numpy(xq), torch.from_numpy(wq), kind)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _jax_sums(xq, wq, kind))


def test_tiled_adjoint_with_channels_swapped():
    """The ``quantize_bwd`` input adjoint: a 3x3 of C_out = 128 -> C_in = 256
    channels with the flipped, transposed kernel, through the mirror, equal
    to the plain version and to JAX's conv of the cotangent."""
    rng = np.random.default_rng(12)
    weight = torch.from_numpy(rng.standard_normal((128, 256, 3, 3)).astype(np.float32))
    w_q, _ = Q.quantized_weight(weight, "3x3", adjoint=True)
    assert tuple(w_q.shape) == (9, 256, 128)
    g_q = _int8(rng, (2, 10, 19, 128))
    got = tiled_conv(torch.from_numpy(g_q), w_q, "3x3")
    assert torch.equal(got, Q.int8_conv_plain(torch.from_numpy(g_q), w_q, "3x3"))
    assert np.array_equal(got.numpy(), _jax_sums(g_q, w_q.numpy(), "3x3"))


@pytest.mark.parametrize("kind", Q.KINDS)
def test_halo_plan_boxes(kind):
    """The box spans the taps of every phase and no more: 3x3 kinds a halo
    of one pixel, 1x1 kinds none; every tap's shifted tile stays inside the
    box, in the rows it shifts to (what ``qc_conv_sm90`` checks)."""
    plan = Q.halo_plan(kind)
    phases, ntaps, _, taps = Q.tap_table(kind)
    halo = 2 if kind.endswith("3x3") else 0
    assert (plan.rows, plan.cols) == (8, 16)
    assert (plan.box_h, plan.box_w) == (plan.rows + halo, plan.cols + halo)
    assert len(plan.taps) == phases * ntaps
    for (off, t), (dy, dx, t0) in zip(plan.taps, taps):
        assert t == t0
        ry, rx = divmod(off, plan.box_w)
        assert (ry, rx) == (dy - plan.lo_y, dx - plan.lo_x)
        assert rx + plan.cols <= plan.box_w and ry + plan.rows <= plan.box_h
    table = plan.table()
    assert table[:5] == [8, plan.lo_y, plan.lo_x, plan.box_h, plan.box_w]
    assert len(table) == 5 + 2 * phases * ntaps


def test_route_rule_takes_the_shipped_int8_unet():
    """Every convolution of the full-width int8 U-Net (the shipped network
    config with ``fuse_resample`` and ``quantize_int8``), and the adjoint of
    each unfused one, goes to the sm90 kernel; C_in 8 and 24 go to mma."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import layers as L
    args = torch_compose(["network.compute_dtype=bfloat16", "network.fuse_resample=true",
                          "network.quantize_int8=true"])
    net = instantiate(args["network"], device="meta", seed=0)
    shapes = {(m.kind, m.weight.shape[1], m.weight.shape[0]) for m in net.modules()
              if isinstance(m, (L.QConv, L.FusedUpConv))}
    assert {k for k, _, _ in shapes} == set(Q.KINDS)
    pairs = {(ci, co) for _, ci, co in shapes} | {(co, ci) for k, ci, co in shapes
                                                   if not k.startswith("up")}
    assert {c for pair in pairs for c in pair} == {128, 256, 384, 512}
    for ci, co in pairs:
        assert Q.conv_route(ci, co) == "sm90"
        assert Q.conv_route(ci, co, "mma") == "mma"
    for ci in (8, 24):
        assert Q.conv_route(ci, 128) == "mma"
        with pytest.raises(ValueError, match="multiples of 128"):
            Q.conv_route(ci, 128, "sm90")
    with pytest.raises(ValueError, match="route"):
        Q.conv_route(128, 128, "wgmma")


def test_route_names_need_a_cuda_tensor():
    """A CPU tensor takes the plain version; naming a CUDA route for it
    raises, and no launch counter moves."""
    x_q = torch.zeros((1, 4, 4, 128), dtype=torch.int8)
    w_q, s_w = Q.quantize_weight(torch.randn(128, 128, 3, 3))
    before = (Q.int8_conv_sm90.launches, Q.int8_conv_mma.launches)
    assert Q.int8_conv(x_q, w_q, s_w, "3x3", raw=True).shape == (1, 4, 4, 128)
    for route in Q.ROUTES:
        with pytest.raises(ValueError, match="CUDA"):
            Q.int8_conv(x_q, w_q, s_w, "3x3", route=route)
    with pytest.raises(ValueError, match="route"):
        Q.int8_conv(x_q, w_q, s_w, "3x3", route="tensor_cores")
    assert (Q.int8_conv_sm90.launches, Q.int8_conv_mma.launches) == before
