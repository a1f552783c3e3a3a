"""K1's algebra (CPU): the partial sums of the CUDA kernels
(``buddy_tpu_torch/csrc/groupnorm.cu``) taken to the group statistics, the
affine coefficients, dx's coefficients and the weight gradients through the
plain functions of ``ops/groupnorm.py``, against the JAX ``GroupNormAct``
forward and vjp; and the host-side slab schedule.

The kernels sum per slab of rows and combine the partials in their second
pass; the tests run that decomposition at uneven splits (a last slab
shorter than the others, C not a multiple of the 16-byte vector).
Tolerance 1e-5 relative: float32 moments over a few hundred elements a
group, summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import rel_err

GN_SHAPES = [(8, 128, 256, 528), (8, 256, 128, 264), (8, 256, 64, 132), (8, 256, 32, 66)]
H100_SMS = 132

CASES = {
    # (B, H, W, C, G, rows a slab)
    "uneven slabs, C=16": (2, 6, 8, 16, 4, 10),
    "uneven slabs, C=32": (2, 5, 7, 32, 8, 9),
    "C=20 not a multiple of 8": (3, 4, 5, 20, 10, 6),
    "one slab, C=12": (1, 3, 4, 12, 3, 12),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("silu", [False, True])
def test_partials_algebra_against_jax(name, silu):
    """y, dx, d scale and d bias from the kernels' partial sums against the
    JAX GroupNormAct forward and vjp."""
    from buddy_tpu.models.layers import GroupNormAct as JGN
    from buddy_tpu_torch.ops import groupnorm as K1
    B, H, W, C, G, RS = CASES[name]
    HW = H * W
    S = -(-HW // RS)
    assert HW % RS != 0 or S == 1          # the last slab is shorter, or there is one
    rng = np.random.default_rng(B * C + RS + silu)
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mod = JGN(num_groups=G, epsilon=1e-6, act=jax.nn.silu if silu else None)
    f = lambda x_, s_, b_: mod.apply({"params": {"scale": s_, "bias": b_}}, x_)
    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    gx, gs_, gb = vjp(jnp.asarray(dy))

    xv, dyv = torch.from_numpy(x).view(B, HW, C), torch.from_numpy(dy).view(B, HW, C)
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    count = HW * (C // G)
    part = K1.group_partials_plain(K1.slab_sums_plain(xv, S, RS), G)
    mean, rstd, a, sh = K1.forward_coefficients_plain(part, w, b, count, 1e-6)
    u = xv * a[:, None] + sh[:, None]
    y = torch.nn.functional.silu(u) if silu else u
    assert rel_err(y.view(B, H, W, C).numpy(), np.asarray(y_ref)) < 1e-5

    pc = K1.backward_slab_sums_plain(xv, dyv, a, sh, silu, S, RS)
    pg = K1.group_partials_plain(pc, G, w)
    gsz = C // G
    c2, c3 = K1.backward_coefficients_plain(pg, mean, rstd, count)
    rep = lambda t: t.repeat_interleave(gsz, 1)[:, None]
    du = K1._du(xv, dyv, a[:, None], sh[:, None], silu)
    dx = a[:, None] * du + rep(c2) * xv + rep(c3)
    dw, db = K1.weight_grads_plain(pc, mean, rstd)
    assert rel_err(dx.view(B, H, W, C).numpy(), np.asarray(gx)) < 1e-5
    assert rel_err(dw.numpy(), np.asarray(gs_)) < 1e-5
    assert rel_err(db.numpy(), np.asarray(gb)) < 1e-5


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_slab_schedule_covers_every_row_once(shape):
    """At the U-Net's four GroupNorm shapes on an H100 (132 SMs): the slabs
    cover every row of an utterance once, none is empty, each but the last
    has RS rows, and there are about SLABS_PER_SM statistics CTAs an SM."""
    from buddy_tpu_torch.ops import groupnorm as K1
    B, C, H, W = shape
    HW = H * W
    S, RS = K1.slab_schedule(B, HW, H100_SMS)
    assert (S - 1) * RS < HW <= S * RS and RS >= min(HW, K1.MIN_SLAB_ROWS)
    seen = np.zeros(HW, int)
    for s in range(S):
        seen[s * RS:min(HW, (s + 1) * RS)] += 1
    assert (seen == 1).all()
    assert B * S <= K1.SLABS_PER_SM * H100_SMS + B
