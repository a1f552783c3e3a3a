"""Parity of the port's NCSN++ with the JAX package's across the rest of its
configuration space, on the CPU (TINY_NET, 2048-sample utterances): FIR
resampling, the ddpm ResBlock, the residual skip pyramids, their bfloat16
bodies, FIR with int8 and with ``fuse_resample``, the refusal of FIR under a
bfloat16 body, ``remat``, and the parameters and ``.ckpt`` files of these
networks between the two packages.  The JAX parameter tree, randomized from
a seed, is carried over by ``from_jax_params``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import TINY_NET, jax_compose, randomize_tree, rel_err, torch_compose

N = 2048
RESIDUAL = ["network.progressive=residual", "network.progressive_input=residual"]
NO_PYRAMIDS = ["network.progressive=none", "network.progressive_input=none"]
CONFIGS = {
    "fir-residual-residual": ["network.fir=true", *RESIDUAL],
    "fir-none-residual": ["network.fir=true", "network.progressive=none",
                          "network.progressive_input=residual"],
    "ddpm-none-none": ["network.resblock_type=ddpm", *NO_PYRAMIDS],
    "ddpm-fir-residual": ["network.resblock_type=ddpm", "network.fir=true", *RESIDUAL],
}


def _nets(over, seed=12):
    """The JAX package's TINY_NET with ``over`` (its variables from a seed;
    a "quant" collection as its init gives) and the port's, loaded from
    them; returns (JAX module, variables, port NetworkBundle)."""
    import buddy_tpu_torch.config as tc
    from buddy_tpu_torch.models import NetworkBundle
    module = jax_module(over)
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, N)),
                            jnp.zeros((1,)))
    struct = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), struct)
    tree = {"params": randomize_tree(struct["params"], seed)}
    if "quant" in struct:
        tree["quant"] = struct["quant"]
    tnet = NetworkBundle(tc.instantiate(torch_compose(TINY_NET + over)["network"], device="cpu"))
    tnet.load_jax_params(tree)
    return module, tree, tnet


def jax_module(over):
    import buddy_tpu.config as jc
    return jc.instantiate(jax_compose(TINY_NET + over)["network"])


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 1, N)) * 0.5).astype(np.float32)
    return x, np.asarray([-1.0, 0.3], np.float32), rng.standard_normal(x.shape).astype(np.float32)


def _forward(module, tree, tnet, x, cnoise):
    yj = np.asarray(jax.jit(module.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                          jnp.asarray(cnoise)))
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x), torch.from_numpy(cnoise)).numpy()
    return yt, yj


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tiny_net_matches_jax(name):
    """NCSNppTimeModule forward and the vjp w.r.t. the waveform in float32,
    against the JAX package's: 1e-4 of the largest value (a float32 U-Net
    whose sums run in other orders, as tests/test_torch_model.py)."""
    module, tree, tnet = _nets(CONFIGS[name])
    x, cnoise, ct = _inputs(1)
    params = jax.tree.map(jnp.asarray, tree)
    f = lambda v: module.apply(params, v, jnp.asarray(cnoise))
    yj, gj = jax.jit(lambda v, c: (f(v), jax.vjp(f, v)[1](c)[0]))(jnp.asarray(x),
                                                                  jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tnet(xt, torch.from_numpy(cnoise))
    y.backward(torch.from_numpy(ct))
    assert y.shape == yj.shape
    assert rel_err(y.detach().numpy(), np.asarray(yj)) < 1e-4
    assert rel_err(xt.grad.numpy(), np.asarray(gj)) < 1e-4


@pytest.mark.parametrize("over", [["network.resblock_type=ddpm", *NO_PYRAMIDS], RESIDUAL],
                         ids=["ddpm-none-none", "residual-residual"])
def test_tiny_net_bfloat16_body_matches_jax(over):
    """compute_dtype=bfloat16 on both sides, without FIR: 5e-2 of the
    largest value, as tests/test_torch_model.py (bf16 rounds at other
    places in the two frameworks).  The convs the JAX package builds
    without a dtype (the ddpm Downsample / Upsample, the pyramids', the
    last) run in float32 and promote what follows, in both."""
    module, tree, tnet = _nets(over + ["network.compute_dtype=bfloat16"])
    x, cnoise, _ = _inputs(3)
    yt, yj = _forward(module, tree, tnet, x, cnoise)
    assert np.isfinite(yt).all()
    assert rel_err(yt, yj) < 5e-2


def test_fir_with_dynamic_int8_matches_jax():
    """fir with quantize_int8 (dynamic, int32 accum) in float32: every
    BigGAN ResBlock's Conv_0, Conv_1 and Conv_2 run int8 (K10's plain
    versions here), unfused, around the FIR resampling; the residual
    pyramids' convs stay float.  Each int8 conv is bit for bit the JAX
    package's on equal inputs (tests/test_torch_int8.py); across the network
    the float parts differ in their last bits, and a quantization rounding
    that flips by one step on one element changes what every later layer
    quantizes.  How far that carries is measured on the JAX network itself:
    its input moved by 1e-6 of itself (the float networks of the two
    packages agree to ~4e-7) moves its int8 output by ~2e-2 of the peak,
    against ~1.5e-6 for the float network.  So the port must be no further
    from the JAX int8 output than twice that, and nearer to it than the
    float network is (the int8 error itself)."""
    from buddy_tpu_torch.models import layers as TL
    over = ["network.fir=true", *RESIDUAL]
    module, tree, tnet = _nets(over + ["network.quantize_int8=true"])
    blocks = [m for m in tnet.module.modules() if isinstance(m, TL.ResnetBlockBigGANpp)]
    assert blocks and all(isinstance(getattr(m, c), TL.QConv) for m in blocks
                          for c in ("Conv_0", "Conv_1", "Conv_2") if hasattr(m, c))
    assert not any(isinstance(m, TL.FusedUpConv) for m in tnet.module.modules())
    assert any(hasattr(m, "Conv2d_0_weight") for m in tnet.module.modules())
    x, cnoise, _ = _inputs(4)
    params = jax.tree.map(jnp.asarray, tree)
    apply = jax.jit(module.apply)
    yj = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(cnoise)))
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x), torch.from_numpy(cnoise)).numpy()
    assert np.isfinite(yt).all()
    moved = x * (1 + 1e-6 * np.random.default_rng(7).standard_normal(x.shape)).astype(np.float32)
    y_moved = np.asarray(apply(params, jnp.asarray(moved), jnp.asarray(cnoise)))
    flt = jax.jit(jax_module(over).apply)(params, jnp.asarray(x), jnp.asarray(cnoise))
    assert rel_err(yt, yj) < 2 * rel_err(y_moved, yj)
    assert rel_err(yt, yj) < rel_err(np.asarray(flt), yj)


def test_fuse_resample_under_fir_is_fir_alone():
    """``fuse_resample`` does nothing under FIR (the JAX package's fused_up
    is ``up and not fir and fuse_up``): the port's network with both gives
    the output of FIR alone, bit for bit, and builds no fused conv."""
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.models.layers import FusedUpConv
    import buddy_tpu_torch.config as tc
    _, tree, tnet = _nets(CONFIGS["fir-residual-residual"])
    over = TINY_NET + CONFIGS["fir-residual-residual"] + ["network.fuse_resample=true"]
    fused = NetworkBundle(tc.instantiate(torch_compose(over)["network"], device="cpu"))
    fused.load_jax_params(tree)
    assert not any(isinstance(m, FusedUpConv) for m in fused.module.modules())
    x, cnoise, _ = _inputs(5)
    with torch.no_grad():
        assert torch.equal(fused(torch.from_numpy(x), torch.from_numpy(cnoise)),
                           tnet(torch.from_numpy(x), torch.from_numpy(cnoise)))


def test_fir_with_a_bfloat16_body_is_refused_by_both():
    """The JAX package's FIR convolution raises TypeError under a bfloat16
    body; the port refuses the configuration when it builds the network,
    with a ValueError that says why."""
    import buddy_tpu_torch.config as tc
    over = ["network.fir=true", *RESIDUAL, "network.compute_dtype=bfloat16"]
    module = jax_module(over)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, N)), jnp.zeros((1,)))
    with pytest.raises(ValueError, match="no FIR path under a bfloat16 body"):
        tc.instantiate(torch_compose(TINY_NET + over)["network"], device="cpu")


@pytest.mark.parametrize("over", [CONFIGS["ddpm-fir-residual"], []], ids=["ddpm-fir", "shipped"])
def test_remat_gradients_bit_for_bit(over):
    """``network.remat=true`` (read since this slice; the JAX config's key)
    recomputes each ResBlock in the backward pass: every ResBlock's forward
    runs twice in a forward-backward, and the output, the input gradient
    and every parameter's gradient are bit for bit those without."""
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.models.layers import _ResBlock
    import buddy_tpu_torch.config as tc
    _, tree, tnet = _nets(over)
    rnet = NetworkBundle(tc.instantiate(torch_compose(TINY_NET + over + ["network.remat=true"])
                                        ["network"], device="cpu"))
    rnet.load_jax_params(tree)
    blocks = [m for m in rnet.module.modules() if isinstance(m, _ResBlock)]
    assert blocks and all(m.remat for m in blocks)
    assert not any(m.remat for m in tnet.module.modules() if isinstance(m, _ResBlock))
    calls = []
    for m in blocks:
        m.GroupNorm_0.register_forward_hook(lambda *a: calls.append(1))
    x, cnoise, ct = _inputs(6)
    out = []
    for net in (tnet, rnet):
        net.module.zero_grad()
        xt = torch.from_numpy(x).requires_grad_(True)
        y = net(xt, torch.from_numpy(cnoise))
        y.backward(torch.from_numpy(ct))
        out.append([y.detach(), xt.grad] + [p.grad for p in net.module.parameters()
                                            if p.requires_grad])
    assert len(calls) == 2 * len(blocks)
    assert len(out[0]) == len(out[1])
    assert all(torch.equal(a, b) for a, b in zip(out[0], out[1]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parameters_and_ckpt_files_map_one_to_one(name, tmp_path):
    """The JAX variables of each configuration land on the port's parameters
    one to one (strict load, equal counts; the FIR convs' Conv2d_0_weight
    HWIO <-> OIHW), come back equal through to_jax_params, and a ``.ckpt``
    file of either package loads in the other with every leaf equal."""
    import buddy_tpu.training.checkpoint as jck
    import buddy_tpu_torch.training.checkpoint as tck
    from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
    _, tree, tnet = _nets(CONFIGS[name])
    assert tnet.num_params == sum(int(np.prod(np.shape(v))) for v in jax.tree.leaves(tree))
    state = tnet.module.state_dict()
    fir = [k for k in state if k.endswith("Conv2d_0_weight")]
    assert bool(fir) == ("fir" in name)
    back = to_jax_params(state)
    flat = lambda t: tck._flatten(t)
    assert list(flat(back)) == list(flat(tree))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    for k in fir:                           # the port's OIHW of the JAX package's HWIO
        hwio = flat(tree)[f"params/unet/all_modules_{k.split('.')[2]}/Conv2d_0_weight"]
        assert torch.equal(state[k], torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()))
    path = jck.save_checkpoint(str(tmp_path / "jax"), params=tree, ema_params=tree, it=5)
    loaded, it = tck.load_any_checkpoint(path)
    assert it == 5
    got = from_jax_params(loaded)
    assert all(torch.equal(got[k], v) for k, v in state.items())
    path = tck.save_checkpoint(str(tmp_path / "torch"), params=back, ema_params=back, it=6)
    loaded, it = jck.load_any_checkpoint(path, prefer_ema=False)
    assert it == 6
    assert list(flat(loaded)) == list(flat(tree))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(loaded),
                                                    jax.tree.leaves(tree)))
