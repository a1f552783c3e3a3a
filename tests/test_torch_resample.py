"""Parity of the port's FIR resampling (``ops/resample.py``) and of the
modules built on it with the JAX package's, on the CPU: ``upfirdn2d`` (and
its zero-stuffing definition) at the cases of ``tests/test_kernels.py``
with an asymmetric kernel, the FIR entry points with their input
gradients, ``Upsample`` / ``Downsample`` in all four forms, the BigGAN
ResBlock's FIR up and down paths (``fuse_up`` doing nothing under FIR), and
the ddpm ResBlock with either shortcut.
The kernels are asymmetric so that a missing flip shows: the shipped
[1, 3, 3, 1] is a palindrome.  Tolerances: 1e-6 of the peak in float32
(sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import rel_err

from buddy_tpu.models import layers as JL
from buddy_tpu.ops import resample as JR
from buddy_tpu_torch.models import layers as L
from buddy_tpu_torch.models.convert import from_jax_params
from buddy_tpu_torch.ops import resample as R

FIR = (1, 2, 4, 1)          # not a palindrome, so its flip matters


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (2, 1, (5, -1)), (3, 2, (0, 2))])
def test_upfirdn2d_matches_jax(up, down, pad):
    """upfirdn2d against the JAX package's lhs-dilated convolution, values
    and the input vjp; the zero-stuffing definition (upfirdn2d_plain)
    agrees.  The kernel differs along its two axes and under a flip; the
    last two cases take the transposed convolution's general form
    (padding it cannot express, and a stride after the upsampling)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    k = np.outer([1, 2, 5, 1], [3, 1, 2, 2]).astype(np.float32)
    k /= k.sum()
    f = lambda v: JR.upfirdn2d(v, jnp.asarray(k), up=up, down=down, pad=pad)
    yj, vjp = jax.vjp(f, jnp.asarray(x))
    g = rng.standard_normal(yj.shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    yt = R.upfirdn2d(xt, torch.from_numpy(k), up=up, down=down, pad=pad)
    yt.backward(_nchw(g))
    assert _nhwc(yt).shape == yj.shape
    assert rel_err(_nhwc(yt), yj) < 1e-6
    assert rel_err(_nhwc(xt.grad), gj) < 1e-6
    yp = R.upfirdn2d_plain(_nchw(x), torch.from_numpy(k), up=up, down=down, pad=pad)
    assert rel_err(_nhwc(yp), yj) < 1e-6


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d", "upsample_conv_2d",
                                "conv_downsample_2d", "upfirdn1d"])
def test_fir_entry_points_match_jax(fn):
    """The FIR entry points against the JAX package's, values and input
    gradients (the conv forms: the weight's gradient too), float32.  The
    port's weights are OIHW, its 1-D tensors (B, C, T)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 5)) / 6).astype(np.float32)
    if fn == "upfirdn1d":
        x1 = x[:, 0]                                            # (B, T, C)
        k1 = np.asarray([1, 3, 2, 1], np.float32) / 7
        jf = lambda v: JR.upfirdn1d(v, jnp.asarray(k1), up=2, pad=(2, 1))
        yj, vjp = jax.vjp(jf, jnp.asarray(x1))
        g = rng.standard_normal(yj.shape).astype(np.float32)
        xt = torch.from_numpy(x1.transpose(0, 2, 1).copy()).requires_grad_(True)
        yt = R.upfirdn1d(xt, torch.from_numpy(k1), up=2, pad=(2, 1))
        yt.backward(torch.from_numpy(g.transpose(0, 2, 1).copy()))
        assert rel_err(yt.detach().numpy().transpose(0, 2, 1), yj) < 1e-6
        assert rel_err(xt.grad.numpy().transpose(0, 2, 1), vjp(jnp.asarray(g))[0]) < 1e-6
        return
    conv = fn in ("upsample_conv_2d", "conv_downsample_2d")
    jfn, tfn = getattr(JR, fn), getattr(R, fn)
    if conv:
        jf = lambda v, ww: jfn(v, ww, FIR, factor=2)
        yj, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    else:
        jf = lambda v: jfn(v, FIR, factor=2)
        yj, vjp = jax.vjp(jf, jnp.asarray(x))
    g = rng.standard_normal(yj.shape).astype(np.float32)
    grads_j = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    yt = tfn(xt, wt, FIR, factor=2) if conv else tfn(xt, FIR, factor=2)
    yt.backward(_nchw(g))
    assert _nhwc(yt).shape == yj.shape
    assert rel_err(_nhwc(yt), yj) < 1e-6
    assert rel_err(_nhwc(xt.grad), grads_j[0]) < 1e-6
    if conv:
        assert rel_err(wt.grad.permute(2, 3, 1, 0).numpy(), grads_j[1]) < 1e-6


def test_fir_refuses_bfloat16_as_the_jax_package_does():
    """A bfloat16 input meets the float32 FIR kernel: the JAX package's
    convolution raises TypeError, and so does the port (no FIR path under a
    bfloat16 body in either)."""
    x = np.ones((1, 8, 8, 2), np.float32)
    with pytest.raises(TypeError):
        JR.upsample_2d(jnp.asarray(x, jnp.bfloat16))
    for fn in (R.upsample_2d, R.downsample_2d):
        with pytest.raises(TypeError, match="bfloat16"):
            fn(_nchw(x).bfloat16())


def _module_pair(jmod, tmod, x, *args):
    """Initialise the flax module on x (NHWC), load its parameters into the
    port's module through from_jax_params, and return both outputs on x
    and the port's input gradient against the JAX vjp's, for a seeded
    cotangent."""
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), *args)
    variables = jax.tree.map(np.array, variables)
    tmod.load_state_dict(from_jax_params(variables), strict=True)
    f = lambda v: jmod.apply(variables, v, *args)
    yj, vjp = jax.vjp(f, jnp.asarray(x))
    g = np.random.default_rng(4).standard_normal(yj.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_(True)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    yt = tmod(xt, *targs)
    yt.backward(_nchw(g))
    return yt, yj, xt.grad, vjp(jnp.asarray(g))[0], variables


@pytest.mark.parametrize("kind", ["Upsample", "Downsample"])
@pytest.mark.parametrize("fir,with_conv", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_resample_modules_match_jax(kind, fir, with_conv):
    """Upsample / Downsample in their four forms (nearest or 2x2 average;
    with Conv_0; FIR; FIR with the raw Conv2d_0_weight / Conv2d_0_bias),
    parameters carried over by from_jax_params: values and the input vjp,
    and the parameter names one to one."""
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 4)).astype(np.float32)
    jmod = getattr(JL, kind)(out_ch=6 if with_conv else None, with_conv=with_conv, fir=fir,
                             fir_kernel=FIR)
    tmod = getattr(L, kind)(4, 6 if with_conv else None, with_conv=with_conv, fir=fir,
                            fir_kernel=FIR)
    tmod.init_(torch.Generator().manual_seed(0))
    yt, yj, gt, gj, variables = _module_pair(jmod, tmod, x)
    names = sorted(n for n, _ in tmod.named_parameters())
    expect = {(False, False): [], (False, True): ["Conv_0.bias", "Conv_0.weight"],
              (True, False): [], (True, True): ["Conv2d_0_bias", "Conv2d_0_weight"]}
    assert names == expect[(fir, with_conv)]
    assert len(jax.tree.leaves(variables)) == len(names)
    assert _nhwc(yt).shape == yj.shape
    assert rel_err(_nhwc(yt), yj) < 1e-6
    assert rel_err(_nhwc(gt), gj) < 1e-6


@pytest.mark.parametrize("direction", ["up", "down"])
def test_biggan_fir_block_matches_jax(direction):
    """The BigGAN ResBlock's FIR path (h and x both FIR-resampled) against
    the JAX package's, with its time embedding; ``fuse_up`` under FIR is
    FIR alone in both packages (the same output, bit for bit in the
    port)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    up, down = direction == "up", direction == "down"
    kw = dict(up=up, down=down, fir=True, fir_kernel=FIR, init_scale=0.5)
    jmod = JL.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=8, **kw)
    tmod = L.ResnetBlockBigGANpp(torch.nn.functional.silu, 8, 8, temb_dim=16, **kw)
    yt, yj, gt, gj, variables = _module_pair(jmod, tmod, x, temb)
    assert rel_err(_nhwc(yt), yj) < 1e-6
    assert rel_err(_nhwc(gt), gj) < 1e-6
    fused = L.ResnetBlockBigGANpp(torch.nn.functional.silu, 8, 8, temb_dim=16, fuse_up=True,
                                  **kw)
    fused.load_state_dict(tmod.state_dict(), strict=True)
    assert not fused.fused_up and isinstance(fused.Conv_0, L.Conv)
    with torch.no_grad():
        assert torch.equal(fused(_nchw(x), torch.from_numpy(temb)),
                           tmod(_nchw(x), torch.from_numpy(temb)))
    jfused = JL.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=8, fuse_up=True, **kw)
    assert np.array_equal(np.asarray(jfused.apply(variables, jnp.asarray(x), jnp.asarray(temb))),
                          np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(temb))))


@pytest.mark.parametrize("conv_shortcut", [False, True], ids=["NIN_0", "Conv_2"])
def test_ddpm_block_matches_jax(conv_shortcut):
    """The ddpm ResBlock against the JAX package's, with its time embedding
    and a change of channels, so that the shortcut runs: NIN_0, or Conv_2
    with ``conv_shortcut``; values and the input vjp."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    kw = dict(conv_shortcut=conv_shortcut, skip_rescale=True, init_scale=0.5)
    jmod = JL.ResnetBlockDDPMpp(act=jax.nn.silu, out_ch=12, **kw)
    tmod = L.ResnetBlockDDPMpp(torch.nn.functional.silu, 8, 12, temb_dim=16, **kw)
    yt, yj, gt, gj, _ = _module_pair(jmod, tmod, x, temb)
    assert hasattr(tmod, "Conv_2") == conv_shortcut and hasattr(tmod, "NIN_0") != conv_shortcut
    assert rel_err(_nhwc(yt), yj) < 1e-6
    assert rel_err(_nhwc(gt), gj) < 1e-6
