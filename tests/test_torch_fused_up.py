"""Parity of the port's fused nearest-up2 convolutions (``ops/resample.py``,
K8) and of the serving profile's network with the JAX package's, on the
CPU: the derived kernels, ``up2_conv3x3`` / ``up2_conv1x1`` against JAX
and against upsample-then-conv, an up-ResBlock fused, int8, and both, the
TINY_NET forward under ``fuse_resample``, and the small blind program with
``fuse_resample`` and calibrated static int8, JAX's draws replayed.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (BLIND_SMALL, REPO, ReplayNoise, TINY_NET, jax_compose,
                               jax_program_draws, op_hp, randomize_tree, rel_err, to_torch,
                               torch_compose)

from buddy_tpu.ops import resample as JR
from buddy_tpu_torch.models import layers as L
from buddy_tpu_torch.ops import resample as R


@pytest.mark.parametrize("k", [3, 1])
def test_derived_kernels_match_jax(k):
    """up2_kernel3x3 / up2_kernel1x1 bit for bit (the 4x4's taps summed in
    float32 in the JAX package's order)."""
    w = np.random.default_rng(1).standard_normal((k, k, 6, 5)).astype(np.float32)
    jfn, tfn = (JR.up2_kernel3x3, R.up2_kernel3x3) if k == 3 else (JR.up2_kernel1x1,
                                                                   R.up2_kernel1x1)
    kj = np.asarray(jax.jit(jfn)(jnp.asarray(w)))
    kt = tfn(torch.from_numpy(w).permute(3, 2, 0, 1)).permute(2, 3, 1, 0).numpy()
    assert np.array_equal(kt, kj)


@pytest.mark.parametrize("k", [3, 1])
def test_up2_conv_matches_jax_and_naive(k):
    """up2_conv3x3 / up2_conv1x1 (one transposed convolution with the
    derived kernel) against the JAX package's (one lhs-dilated convolution)
    and against conv(nearest_up2(x)), float32: 1e-6 of the peak (float32
    sums in other orders; the identities are exact in float64)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 4)) / np.sqrt(6 * k * k)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    jfn, tfn = (JR.up2_conv3x3, R.up2_conv3x3) if k == 3 else (JR.up2_conv1x1, R.up2_conv1x1)
    yj = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xt, wt, bt = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
                  torch.from_numpy(b))
    yt = tfn(xt, wt, bt)
    assert yt.shape == (2, 4, 10, 14)
    assert rel_err(yt.permute(0, 2, 3, 1).numpy(), yj) < 1e-6
    naive = torch.nn.functional.conv2d(L.naive_upsample_2d(xt), wt, bt, padding=k // 2)
    assert rel_err(yt.numpy(), naive.numpy()) < 1e-6
    x64 = xt.double()
    assert torch.allclose(tfn(x64, wt.double(), bt.double()),
                          torch.nn.functional.conv2d(L.naive_upsample_2d(x64), wt.double(),
                                                     bt.double(), padding=k // 2),
                          rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ["fused", "int8", "int8-fused", "int8-static-fused"])
def test_up_resblock_matches_jax(variant):
    """An up-ResBlock (16 -> 12 channels, temb) of the JAX package and the
    port's, from the same variables (random scales in "quant" for the
    static block), float32: 1e-6 of the peak (measured: bit for bit but for
    one GroupNorm rounding).  The fused and unfused blocks share their
    parameter names and shapes."""
    from buddy_tpu.models.layers import ResnetBlockBigGANpp as JBlock, get_act
    from buddy_tpu_torch.models.convert import from_jax_params
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 6, 8, 16)) * 0.5).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    fuse = "fused" in variant
    qconv = ("int32", False, "static" in variant) if "int8" in variant else False
    kw = dict(act=get_act("swish"), out_ch=12, up=True, dropout=0.0, skip_rescale=True,
              init_scale=0.0, temb=True, qconv=qconv)
    block = JBlock(**kw, fuse_up=fuse)
    struct = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(temb))
    plain = jax.eval_shape(JBlock(**kw).init, jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(temb))
    assert jax.tree.map(lambda s: s.shape, plain) == jax.tree.map(lambda s: s.shape, struct)
    vars_ = {"params": randomize_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                   struct["params"]), 4)}
    if "quant" in struct:
        vars_["quant"] = jax.tree.map(
            lambda s: (np.abs(rng.standard_normal(s.shape)) * 2).astype(np.float32),
            struct["quant"])
    yj = np.asarray(jax.jit(block.apply)(vars_, jnp.asarray(x), jnp.asarray(temb)))
    tblock = L.ResnetBlockBigGANpp(L.get_act("swish"), 16, 12, up=True, temb_dim=32,
                                   qconv=qconv, fuse_up=fuse)
    tblock.load_state_dict(from_jax_params(vars_), strict=True)
    with torch.no_grad():
        yt = tblock(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(temb))
    assert yt.shape == (2, 12, 12, 16)
    assert rel_err(yt.permute(0, 2, 3, 1).numpy(), yj) < 1e-6


def test_tiny_net_fuse_resample_matches_jax():
    """TINY_NET with ``fuse_resample`` on both sides, float32: 1e-5 of the
    peak (measured 5e-7); the fused network's weights are the unfused one's,
    and it launches the fused route (``FusedUpConv.float_calls``)."""
    from test_torch_common import jax_tiny_bundle, torch_tiny_bundle
    import buddy_tpu.config as jc
    _, tree = jax_tiny_bundle(2048, seed=11)
    jmod = jc.instantiate(jax_compose(TINY_NET + ["network.fuse_resample=true"])["network"])
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import NetworkBundle
    tnet = NetworkBundle(instantiate(torch_compose(TINY_NET + ["network.fuse_resample=true"])[
        "network"], device="cpu"))
    tnet.load_jax_params(tree)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 1, 2048)) * 0.5).astype(np.float32)
    c = np.asarray([-1.0, 0.3], np.float32)
    yj = np.asarray(jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                        jnp.asarray(c)))
    calls = L.FusedUpConv.float_calls
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert L.FusedUpConv.float_calls - calls == 2       # TINY_NET: one up-ResBlock
    assert rel_err(yt, yj) < 1e-5
    with torch.no_grad():
        y_unfused = torch_tiny_bundle(tree)(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert rel_err(yt, y_unfused) < 1e-5


N = 16384
SERVING_INT8 = ["network.fuse_resample=true", "network.quantize_int8=true",
                "network.quantize_static=true"]


def test_blind_program_fused_static_int8_matches_jax(monkeypatch):
    """The whole slice: the small blind program (B=2 x 16384, T=2, 2 operator
    updates a step, WPE taps 10; tests/test_torch_sampler.py's) with
    ``fuse_resample`` and static int8, the JAX network calibrated by
    ``calibrate_quant`` (bench.py's recipe at test size) and its variables,
    scales included, carried to the port; JAX's draws replayed and its WPE
    output handed to the port (the complex64 WPE solves differ by ~0.5% of
    the peak between the frameworks, test_torch_sampler).  Tolerance 2e-2
    of the peak: the static int8 network alone spreads by 7.5e-3
    (test_torch_int8), and the program's guidance runs it forward and
    backward at every step."""
    import buddy_tpu.config as jc
    import buddy_tpu_torch.config as tc
    import buddy_tpu_torch.sampling.wpe as twpe
    from buddy_tpu.models import NetworkBundle as JBundle
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu.sampling.wpe import wpe_dereverb as jwpe
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    jargs, targs = jax_compose(BLIND_SMALL + SERVING_INT8), torch_compose(BLIND_SMALL + SERVING_INT8)
    module = jc.instantiate(jargs["network"])
    struct = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 1, N)), jnp.zeros((1,))))
    jnet = JBundle(module, jax.tree.map(jnp.asarray, {"params": randomize_tree(
        struct["params"], 21), "quant": struct["quant"]}))
    jedm = jc.instantiate(jargs["diff_params"])
    rng = np.random.default_rng(8)
    clean = jnp.asarray(rng.standard_normal((1, 1, N)).astype(np.float32) * 0.05)
    xs, cs = [], []
    hp = jargs["diff_params"]["sde_hp"]
    for s in np.geomspace(float(hp["sigma_max"]), float(hp["sigma_min"]), 4):
        sig = jnp.full((1,), s, jnp.float32)
        xn = clean + s * jnp.asarray(rng.standard_normal((1, 1, N)).astype(np.float32))
        xs.append(jedm.cin(sig)[:, None, None] * xn)
        cs.append(jedm.cnoise(sig))
    jnet.calibrate_quant(xs, cs)
    tnet = NetworkBundle(tc.instantiate(targs["network"], device="cpu"))
    tnet.load_jax_params(jax.tree.map(np.asarray, jnet.params))
    assert all((b > 0).any() for n, b in tnet.module.named_buffers() if n.endswith("a_scale"))

    jsampler = jc.instantiate(jargs["tester"]["sampler"], jnet, jedm, jargs)
    tsampler = tc.instantiate(targs["tester"]["sampler"], tnet, tc.instantiate(targs["diff_params"]),
                              targs, device="cpu")
    jop = JBlind(op_hp(jargs), sample_rate=16000)
    top = BlindSubbandFiltering(op_hp(targs), sample_rate=16000, device="cpu")
    params, H = jop.reset_batched(jax.random.PRNGKey(1), 2)
    params = {k: np.asarray(v) for k, v in params.items()}
    ys = np.stack([read_wav(os.path.join(REPO, "quality_out_heldout",
                                         f"degraded_utt{i}.wav"))[0][:N] for i in range(2)])
    ys = ys[:, None].astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(jsampler.predict_conditional_batched(
        jnp.asarray(ys), jop, blind=True, rng=key,
        op_params_batch={k: jnp.asarray(v) for k, v in params.items()},
        H_batch=jnp.asarray(np.asarray(H))))
    wpe_ref = np.asarray(jax.vmap(lambda y: jwpe(y, taps=10, delay=2, iterations=5))(
        jnp.asarray(ys)))[:, 0]
    monkeypatch.setattr(twpe, "wpe_dereverb", lambda y, **kw: torch.from_numpy(wpe_ref))
    draws = jax_program_draws(key, 2, N, tsampler.T, 2, top.length_rir + 1024, reg=True)
    out = tsampler.predict_conditional_batched(
        torch.from_numpy(ys), top, blind=True, noise=ReplayNoise(draws),
        op_params_batch=to_torch(params), H_batch=torch.tensor(np.asarray(H)))
    assert out.shape == ref.shape == (2, 1, N)
    assert torch.isfinite(out).all()
    assert rel_err(out.numpy(), ref) < 2e-2
