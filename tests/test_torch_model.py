"""Parity of the port's NCSN++ (TINY_NET) with the JAX package's, on the
CPU: the JAX parameter tree, randomized from a seed, is carried over by
``from_jax_params``; forward and input-vjp are compared in float32, and a
loose check covers the bfloat16 body.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import jax_tiny_bundle, rel_err, torch_tiny_bundle

N = 2048


@pytest.fixture(scope="module")
def nets():
    jnet, tree = jax_tiny_bundle(N, seed=11)
    return jnet, tree, torch_tiny_bundle(tree)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 1, N)) * 0.5).astype(np.float32)
    cnoise = np.asarray([-1.0, 0.3], np.float32)
    return x, cnoise


def test_state_dict_maps_one_to_one(nets):
    """Every JAX leaf lands on a port parameter of the same size (strict
    load) and the counts agree."""
    jnet, tree, tnet = nets
    n_jax = sum(int(np.prod(np.shape(l))) for l in jax.tree.leaves(tree))
    assert tnet.num_params == n_jax


def test_forward_and_input_vjp_f32(nets):
    """NCSNppTimeModule forward and the vjp w.r.t. the waveform, float32.
    Tolerance 1e-4 of the largest value: a float32 U-Net of ~20 convs whose
    sums run in other orders (cuDNN-free CPU convs against XLA's)."""
    jnet, tree, tnet = nets
    x, cnoise = _inputs(1)
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    f = lambda v: jnet.module.apply(jnet.params, v, jnp.asarray(cnoise))
    y_ref, g_ref = jax.jit(lambda v, c: (f(v), jax.vjp(f, v)[1](c)[0]))(
        jnp.asarray(x), jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_(True)
    y = tnet(xt, torch.from_numpy(cnoise))
    y.backward(torch.from_numpy(ct))
    assert y.shape == y_ref.shape
    assert rel_err(y.detach().numpy(), np.asarray(y_ref)) < 1e-4
    assert rel_err(xt.grad.numpy(), np.asarray(g_ref)) < 1e-4


def test_forward_bf16_body(nets):
    """compute_dtype=bfloat16 on both sides.  bf16 rounds at different
    places in the two frameworks (the port normalises in float32 and rounds
    once), so the check is loose: 5e-2 of the largest value."""
    _, tree, _ = nets
    jnet, _ = jax_tiny_bundle(N, seed=11, dtype="bfloat16")
    tnet = torch_tiny_bundle(tree, dtype="bfloat16")
    x, cnoise = _inputs(3)
    y_ref = np.asarray(jax.jit(jnet.module.apply)(jnet.params, jnp.asarray(x),
                                                   jnp.asarray(cnoise)))
    with torch.no_grad():
        y = tnet(torch.from_numpy(x), torch.from_numpy(cnoise)).numpy()
    assert np.isfinite(y).all()
    assert rel_err(y, y_ref) < 5e-2


def test_forward_positional_no_pyramids():
    """The other ported configuration paths — positional time embedding,
    no skip pyramids, uncentred input — in float32 (1e-4 of the largest
    value, as above)."""
    import buddy_tpu.config as jc
    import buddy_tpu_torch.config as tc
    from buddy_tpu_torch.models import NetworkBundle
    from test_torch_common import TINY_NET, randomize_tree
    over = TINY_NET + ["network.embedding_type=positional", "network.progressive=none",
                       "network.progressive_input=none", "network.centered=false"]
    module = jc.instantiate(jc.compose("conf_VCTK.yaml", over)["network"])
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, N)),
                            jnp.zeros((1,)))
    tree = randomize_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), struct), 12)
    tnet = NetworkBundle(tc.instantiate(tc.compose("conf_VCTK.yaml", over)["network"],
                                        device="cpu"))
    tnet.load_jax_params(tree)
    x, cnoise = _inputs(4)
    y_ref = np.asarray(jax.jit(module.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                             jnp.asarray(cnoise)))
    with torch.no_grad():
        y = tnet(torch.from_numpy(x), torch.from_numpy(cnoise)).numpy()
    assert rel_err(y, y_ref) < 1e-4
