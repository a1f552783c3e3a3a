"""Checkpoints between the two packages on the CPU: a ``.ckpt`` the port
writes restores in the JAX package (parameters, EMA and optimizer state
against ``opt.init``) and in its Trainer; a ``.ckpt`` the JAX Trainer wrote
resumes in the port, whose next step equals JAX's next step; the port's
resume is bit-faithful; a reference-layout ``.pt`` file loads to the same
tree through both packages' converters.  Test size: TINY_NET, batch 2 of
4096 samples.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (FixedLoader, ReplayNoise, TINY_NET, TRAIN_SMALL, assert_after_adam,
                               clean_wav, gradient_tolerances, jax_compose, jax_tiny_bundle,
                               jax_train_draws, jax_trainer, torch_trainer)

from buddy_tpu_torch.models.convert import to_jax_params
from buddy_tpu_torch.training.checkpoint import tree_leaves

N = 4096
EXP = "VCTK_16k_4s_time"


@pytest.fixture(scope="module")
def weights():
    _, tree = jax_tiny_bundle(N, seed=8)
    batch = np.stack([clean_wav(2)[2000:2000 + N], clean_wav(3)[7000:7000 + N]])
    return tree, batch


def _assert_trees_equal(a, b):
    from buddy_tpu_torch.training.checkpoint import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_to_jax_params_inverts_from_jax_params(weights):
    from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
    tree, _ = weights
    state = from_jax_params(tree)
    _assert_trees_equal(to_jax_params(state), tree)
    for k, v in from_jax_params(to_jax_params(state)).items():
        assert torch.equal(v, state[k])


def test_port_checkpoint_restores_in_the_jax_package(tmp_path, weights):
    """The port's .ckpt after two steps: the JAX package's load_any_checkpoint
    gives the port's parameters and EMA bit for bit, load_opt_state against
    ``opt.init(params)`` the port's count and moments, load_extras no PRNG
    key (the port's generator state has a key of its own); and the JAX
    Trainer resumes from it."""
    from buddy_tpu.config import instantiate
    from buddy_tpu.models import NetworkBundle
    from buddy_tpu.training import checkpoint as jckpt
    tree, batch = weights
    tt = torch_trainer(tree, batch, str(tmp_path), ["exp.ema_rampup=10"])
    for it in (0, 1):
        tt.it = it
        tt.train_step()
    tt.it = 2
    tt.save_checkpoint()
    path = tt.latest_checkpoint
    assert path == str(tmp_path / f"{EXP}-2.ckpt")

    params, it = jckpt.load_any_checkpoint(path, prefer_ema=False)
    ema, _ = jckpt.load_any_checkpoint(path, prefer_ema=True)
    assert it == 2
    _assert_trees_equal(params, to_jax_params(tt.params))
    _assert_trees_equal(ema, to_jax_params(tt.ema))
    jt = jax_trainer(tree, batch, str(tmp_path / "unused"))
    restored = jckpt.load_opt_state(path, jt.opt.init(jax.tree.map(jnp.asarray, params)))
    leaves = jax.tree.leaves(restored)
    assert len(leaves) == len(tt.opt_leaves())
    for a, b in zip(leaves, tt.opt_leaves()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(leaves[0]) == 2
    extras = jckpt.load_extras(path)
    assert "rng" not in extras and extras["args"]["exp"]["batch_size"] == 2

    args = jax_compose(TINY_NET + TRAIN_SMALL + [f"model_dir={tmp_path}", "exp.resume=True"])
    args["exp"]["model_dir"] = args["model_dir"]
    net = NetworkBundle(instantiate(args["network"]), jax.tree.map(jnp.asarray, tree))
    jr = instantiate(args["exp"]["trainer"], args, FixedLoader(batch), net,
                     instantiate(args["diff_params"]), None)
    assert jr.it == 2
    _assert_trees_equal(jax.device_get(jr.params), to_jax_params(tt.params))
    for a, b in zip(jax.tree.leaves(jax.device_get(jr.opt_state)), tt.opt_leaves()):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, weights):
    """The JAX Trainer steps at it=0 and saves at it=1; the port resumes from
    that .ckpt (exactly its parameters, EMA and optimizer state) and takes
    the step at it=1 with the draws of JAX's saved key: the loss and norm
    (1e-5 relative), the moments, the parameters and the EMA agree with
    JAX's own step at it=1."""
    from buddy_tpu.training import checkpoint as jckpt
    from buddy_tpu_torch.training.checkpoint import load_extras
    tree, batch = weights
    jdir = tmp_path / "jax"
    os.makedirs(jdir)
    jt = jax_trainer(tree, batch, str(jdir), ["exp.ema_rampup=10", "logging.save_model=True"])
    jt.train_step()
    jt.it = 1
    jt.save_checkpoint()
    _, draws = jax_train_draws(jnp.asarray(load_extras(jt.latest_checkpoint)["rng"]),
                               batch.shape)
    j_opt_saved = [np.asarray(v) for v in jax.tree.leaves(jax.device_get(jt.opt_state))]
    j_params_saved = jax.device_get(jt.params)
    jt._metrics_acc = None
    jt.train_step()
    jm = jax.device_get(jt._metrics_acc)

    tt = torch_trainer(tree, batch, str(jdir), ["exp.ema_rampup=10", "exp.resume=True"],
                       noise=ReplayNoise(draws))
    assert tt.it == 1 and tt.latest_checkpoint == jt.latest_checkpoint
    _assert_trees_equal(to_jax_params(tt.params), j_params_saved)
    for a, b in zip(tt.opt_leaves(), j_opt_saved):
        np.testing.assert_array_equal(a, b)
    tt.train_step()
    tm = {k: v.numpy() for k, v in tt._metrics_acc.items()}
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)

    # the second step's gradients: g = (mu_2 - 0.9 mu_1) / 0.1 from JAX's moments
    j_opt = [np.asarray(v) for v in jax.tree.leaves(jax.device_get(jt.opt_state))]
    n = (len(j_opt) - 1) // 2
    g_jax = [(m2 - np.float32(0.9) * m1) / np.float32(0.1)
             for m1, m2 in zip(j_opt_saved[1:1 + n], j_opt[1:1 + n])]
    g_tol = gradient_tolerances(g_jax)
    t_opt = tt.opt_leaves()
    assert int(t_opt[0]) == int(j_opt[0]) == 2
    for a, b, tol in zip(t_opt[1:1 + n], j_opt[1:1 + n], g_tol):
        np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * tol + 1e-7 * np.abs(b).max())
    # a second step: a margin of 1000 keeps lr |dg| / |g| (at most 1.5 lr / margin
    # here, the moments mixing two gradients) within the 1e-6
    assert_after_adam(tree_leaves(to_jax_params(tt.params)), tree_leaves(jax.device_get(jt.params)),
                      g_jax, g_tol, margin=1000.0)
    assert_after_adam(tree_leaves(to_jax_params(tt.ema)),
                      tree_leaves(jax.device_get(jt.ema_params)),
                      g_jax, g_tol, margin=1000.0)


def test_port_resume_is_bit_faithful(tmp_path, weights):
    """Three steps, a save at it=3, three more, against a new Trainer resumed
    from that save taking the same three: parameters, EMA, moments and the
    generator's draws are equal bit for bit."""
    from buddy_tpu_torch.training import checkpoint as ckpt
    tree, batch = weights
    extra = ["exp.ema_rampup=20"]
    ta = torch_trainer(tree, batch, str(tmp_path), extra)
    for it in range(3):
        ta.it = it
        ta.train_step()
    ta.it = 3
    ta.save_checkpoint()
    for it in range(3, 6):
        ta.it = it
        ta.train_step()

    tb = torch_trainer(tree, batch, str(tmp_path), extra + ["exp.resume=True"])
    assert tb.it == 3 and tb.count == 3
    for it in range(3, 6):
        tb.it = it
        tb.train_step()
    for a, b in ((ta.params, tb.params), (ta.ema, tb.ema), (ta.mu, tb.mu), (ta.nu, tb.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(ta.noise.generator.get_state(), tb.noise.generator.get_state())
    extras = ckpt.load_extras(ta.latest_checkpoint)
    assert extras["args"]["exp"]["batch_size"] == 2 and "generator_state" in extras


def _reference_state_dict(tree):
    """The reference's torch layout of a JAX tree: the inverse of
    ``buddy_tpu/models/convert.py::_convert_leaf`` (Conv kernel HWIO -> OIHW,
    Dense kernel (in, out) -> (out, in), scale -> weight), keys
    ``all_modules.{i}.<sub>.<name>`` and ``output_layer.<name>``."""
    from buddy_tpu_torch.training.checkpoint import _flatten
    sd = {}
    for key, v in _flatten(tree["params"]["unet"]).items():
        *path, name = key.split("/")
        if name == "kernel":
            name, v = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
        elif name == "scale":
            name = "weight"
        path = [p.replace("all_modules_", "all_modules.") for p in path]
        sd[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(v))
    return sd


def test_reference_pt_loads_the_same_tree_in_both_packages(tmp_path, weights):
    """A reference ``.pt`` ({it, network, ema}, and the legacy {model,
    ema_weights}) loads through both packages' converters to the same tree,
    that of the weights it was made from; the port's Trainer and tester read
    it too."""
    from buddy_tpu.training import checkpoint as jckpt
    from buddy_tpu_torch.training import checkpoint as ckpt
    tree, batch = weights
    ema_tree = jax.tree.map(lambda a: (0.5 * a).astype(np.float32), tree)
    path = str(tmp_path / f"{EXP}-7.pt")
    torch.save({"it": 7, "network": _reference_state_dict(tree),
                "ema": _reference_state_dict(ema_tree), "optimizer": {}}, path)
    for prefer_ema, want in ((False, tree), (True, ema_tree)):
        got_t, it_t = ckpt.load_any_checkpoint(path, prefer_ema=prefer_ema)
        got_j, it_j = jckpt.load_any_checkpoint(path, prefer_ema=prefer_ema)
        assert it_t == it_j == 7
        _assert_trees_equal(got_t, got_j)
        _assert_trees_equal(got_t, want)

    legacy = str(tmp_path / "legacy.pt")
    sd = _reference_state_dict(tree)
    torch.save({"model": sd, "ema_weights": list(_reference_state_dict(ema_tree).values())}, legacy)
    got_t, _ = ckpt.load_any_checkpoint(legacy)
    got_j, _ = jckpt.load_any_checkpoint(legacy)
    _assert_trees_equal(got_t, got_j)
    _assert_trees_equal(got_t, ema_tree)

    tt = torch_trainer(tree, batch, str(tmp_path), ["exp.resume=True"])
    assert tt.it == 7 and tt.count == 0         # a .pt holds no optimizer state here
    _assert_trees_equal(to_jax_params(tt.params), tree)
    _assert_trees_equal(to_jax_params(tt.ema), ema_tree)


def test_checkpoint_files_and_formats(tmp_path, weights):
    """Resume by glob picks the largest iteration, rotation removes the
    previous save, an Orbax directory is refused with NotImplementedError,
    a mismatched optimizer is refused by load_opt_state."""
    from buddy_tpu_torch.training import checkpoint as ckpt
    tree, batch = weights
    tt = torch_trainer(tree, batch, str(tmp_path), ["logging.remove_old_checkpoints=True"])
    tt.train_step()
    for it in (2, 10, 4):
        tt.it = it
        tt.save_checkpoint()
    assert sorted(os.listdir(tmp_path)) == [f"{EXP}-4.ckpt"]
    (tmp_path / f"{EXP}-3.pt").write_bytes(b"")
    assert ckpt.find_latest_checkpoint(str(tmp_path), EXP) == str(tmp_path / f"{EXP}-4.ckpt")
    assert ckpt.find_latest_checkpoint(str(tmp_path), "other") is None
    os.makedirs(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="Orbax"):
        ckpt.load_any_checkpoint(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        ckpt.load_opt_state(str(tmp_path / f"{EXP}-4.ckpt"), tt.opt_leaves()[:3])
    ckpt.remove_checkpoint(str(tmp_path / "orbax"))
    assert not os.path.exists(tmp_path / "orbax")

    # a checkpoint of another network: the resume is refused whole (the JAX
    # package's fallback: training starts afresh), nothing half-loaded
    with np.load(tmp_path / f"{EXP}-4.ckpt") as data:
        flat = {k: data[k] for k in data.files if "all_modules_3/" not in k}
    with open(tmp_path / f"{EXP}-9.ckpt", "wb") as f:
        np.savez(f, **flat)
    fresh = torch_trainer(tree, batch, str(tmp_path), ["exp.resume=True"])
    assert fresh.it == 0 and fresh.latest_checkpoint is None and fresh.count == 0
    _assert_trees_equal(to_jax_params(fresh.params), tree)
