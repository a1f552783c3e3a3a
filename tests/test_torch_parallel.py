"""The port's device mesh (``buddy_tpu_torch/parallel``) against the JAX
package's on the CPU: the rank layout (with and without a tp axis) and the
refusals of ``make_mesh`` against the JAX ``make_mesh`` on the 8 virtual
devices, each rank's block of a batch against the JAX ``NamedSharding``'s
shards, the tensor-parallel rule against the JAX ``param_shardings`` and its
blocks gathered back into the JAX tree, the port's train step at dp=2, at
dp=1 x sp=2 and at dp=1 x tp=2 (with and without remat) in a world of two
gloo processes against the JAX Trainer's step on those meshes (JAX's draws
replayed), the ranks' batches under the real loader, and the sharded tester
in a world of two against one process.  Each world is spawned once
(``tests/torch_parallel_worker.py``) and meets through a file store under
the test's temporary directory.  Test size: TINY_NET, batch 2 x 4096 for
training, 2 utterances of 16384 samples for the tester.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_common import (REPO, TINY_NET, TRAIN_SMALL, assert_after_adam, clean_wav,
                               gradient_tolerances, jax_tiny_bundle, jax_train_draws,
                               jax_trainer, rel_err, torch_tiny_bundle)

from buddy_tpu_torch.parallel import mesh as pmesh

N = 4096
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORKER_TIMEOUT = 300


def _ids(jmesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jmesh.devices)


def _mesh_at(monkeypatch, rank, *args, world=8):
    """``make_mesh(*args)`` as rank ``rank`` of a world of ``world``, with
    no process group."""
    monkeypatch.setattr(pmesh, "world_size", lambda: world)
    monkeypatch.setattr(pmesh, "global_rank", lambda: rank)
    return pmesh.make_mesh(*args)


# ---------------------------------------------------------------------------
# the layout, with no process group
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 1), (1, 2), (-1, 1), (-1, 2), (-1, 4)])
def test_make_mesh_layout_against_jax(monkeypatch, dp, sp):
    """Axis names, shape, size and the grid of ranks (dp-major, sp-minor)
    equal the JAX mesh's grid of device ids over 8 devices; each rank's
    coordinates are its place in that grid, and ranks past it are outside."""
    from buddy_tpu.parallel.mesh import make_mesh as jax_make_mesh
    jm = jax_make_mesh(dp, 1, sp)
    for rank in range(8):
        m = _mesh_at(monkeypatch, rank, dp, 1, sp)
        assert m.axis_names == jm.axis_names and m.shape == dict(jm.shape)
        assert m.size == jm.devices.size
        np.testing.assert_array_equal(m.devices, _ids(jm))
        where = np.argwhere(_ids(jm) == rank)
        assert m.in_mesh == bool(len(where))
        if m.in_mesh:
            assert tuple(m.coords.values()) == tuple(where[0])
        assert m.groups == {name: None for name in m.axis_names} and m.group is None


@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 1), (1, 2, 2), (2, 2, 2), (4, 2, 1)])
def test_make_mesh_tp_layout_against_jax(monkeypatch, dp, tp, sp):
    """With a tp axis: the axis names, shape and grid of ranks (dp-major,
    then tp, then sp) equal the JAX mesh's device ids over 8 devices; each
    rank's coordinates and its tp line (the ranks of its row along "tp") are
    those of its device, and ``Mesh.tp`` names its place on that line."""
    from buddy_tpu.parallel.mesh import make_mesh as jax_make_mesh
    jm = jax_make_mesh(dp, tp, sp)
    ids = _ids(jm)
    axis = jm.axis_names.index("tp")
    for rank in range(8):
        m = _mesh_at(monkeypatch, rank, dp, tp, sp)
        assert m.axis_names == jm.axis_names and m.shape == dict(jm.shape)
        np.testing.assert_array_equal(m.devices, ids)
        where = np.argwhere(ids == rank)
        assert m.in_mesh == bool(len(where))
        if not m.in_mesh:
            assert m.tp is None
            continue
        assert tuple(m.coords.values()) == tuple(where[0])
        line = np.moveaxis(ids, axis, -1)[tuple(np.delete(where[0], axis))]
        assert m.line("tp") == list(line) and m.line("tp")[m.coords["tp"]] == rank
        assert (m.tp.rank, m.tp.size, m.tp.group) == (m.coords["tp"], tp, None)


def test_make_mesh_refusals_against_jax(monkeypatch):
    """Too many ranks and an sp or tp axis that leaves none for dp: the JAX
    make_mesh asserts, the port raises ValueError."""
    from buddy_tpu.parallel.mesh import make_mesh as jax_make_mesh
    # one process and no process group: a one-rank mesh
    m = pmesh.make_mesh()
    assert m.shape == {"dp": 1} and m.coords == {"dp": 0} and m.group is None
    for dp, tp, sp in ((8, 1, 2), (16, 1, 1), (-1, 1, 16), (4, 4, 1), (-1, 16, 1), (2, 2, 4)):
        with pytest.raises(AssertionError):
            jax_make_mesh(dp, tp, sp)
        with pytest.raises(ValueError, match="ranks"):
            _mesh_at(monkeypatch, 0, dp, tp, sp)
    assert m.shape == {"dp": 1} and m.coords == {"dp": 0} and m.group is None


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 1), (1, 2), (2, 4)])
def test_shard_slices_against_jax_named_sharding(monkeypatch, dp, sp):
    """Each rank's block of a (batch, samples) array under
    ``shard_waveform_batch`` and ``shard_batch`` is the index of the
    matching device's shard under the JAX ``NamedSharding`` (P("dp", "sp"),
    P("dp")); ``replicated_sharding`` keeps the whole; a rank outside the
    mesh is refused."""
    from buddy_tpu.parallel.mesh import (batch_sharding, make_mesh as jax_make_mesh,
                                         waveform_sharding)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    jm = jax_make_mesh(dp, 1, sp)
    for jsh, fn in ((waveform_sharding(jm), pmesh.shard_waveform_batch),
                    (batch_sharding(jm), pmesh.shard_batch)):
        shards = {s.device.id: s.index for s in jax.device_put(x, jsh).addressable_shards}
        assert sorted(shards) == sorted(_ids(jm).flat)
        for rank in range(8):
            m = _mesh_at(monkeypatch, rank, dp, 1, sp)
            if rank in shards:
                np.testing.assert_array_equal(fn(m, x), x[shards[rank]])
                np.testing.assert_array_equal(pmesh.replicated_sharding(m).local(x), x)
            else:
                with pytest.raises(ValueError, match="outside"):
                    fn(m, x)
    assert tuple(NamedSharding(jm, P("dp")).spec) == pmesh.batch_sharding(m).spec


@pytest.fixture(scope="module")
def tiny_tree():
    return jax_tiny_bundle(N, seed=5)[1]


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_param_shardings_against_jax(monkeypatch, tiny_tree, dp, tp):
    """The port's rule on TINY_NET's whole state marks exactly the leaves
    the JAX ``param_shardings`` shards on the same mesh: the conv kernels
    whose output channels divide (at tp=4 the 2-channel output convs stay
    replicated), along the output axis (the JAX HWIO kernel's last, the
    port's OIHW weight's first)."""
    from buddy_tpu.parallel.mesh import make_mesh as jax_make_mesh, param_shardings as jax_rule
    from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
    from buddy_tpu_torch.training.checkpoint import tree_leaves
    state = from_jax_params(tiny_tree)
    m = _mesh_at(monkeypatch, 0, dp, tp, 1)
    port = pmesh.param_shardings(m, state)
    assert {sh.spec for sh in port.values()} == {(), ("tp",)}
    marks = to_jax_params({k: np.full(v.shape, float(bool(port[k].spec)), np.float32)
                           for k, v in state.items()})
    specs = jax.tree.leaves(jax_rule(jax_make_mesh(dp, tp, 1), tiny_tree),
                            is_leaf=lambda x: isinstance(x, NamedSharding))
    marked = [bool(a.all()) for a in tree_leaves(marks)]
    assert len(specs) == len(marked) and any(marked) and not all(marked)
    for spec, sharded, leaf in zip(specs, marked, tree_leaves(tiny_tree)):
        want = (None, None, None, "tp") if sharded else ()
        assert tuple(spec.spec) == want, (leaf.shape, spec.spec)
    kernels = [sh for sh, leaf in zip(marked, tree_leaves(tiny_tree)) if np.ndim(leaf) == 4]
    assert all(kernels) == (tp == 2)


@pytest.mark.parametrize("tp", [2, 4])
def test_blocks_gather_back_into_the_jax_tree(monkeypatch, tiny_tree, tp):
    """Each rank's blocks of a whole JAX tree (``from_jax_params(tree,
    mesh)``) packed as ``gather_params`` sends them and unpacked as its
    first rank assembles them give the JAX tree back bit for bit, in the JAX
    layout; each rank holds 1/tp of every sharded kernel."""
    from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
    from buddy_tpu_torch.training.checkpoint import tree_leaves
    whole = from_jax_params(tiny_tree)
    blocks = [from_jax_params(tiny_tree, _mesh_at(monkeypatch, r, 1, tp, 1)) for r in range(tp)]
    shardings = pmesh.param_shardings(_mesh_at(monkeypatch, 0, 1, tp, 1), whole)
    for k, sh in shardings.items():
        if sh.spec:
            assert blocks[1][k].shape[0] * tp == whole[k].shape[0]
    parts = [pmesh.pack_blocks(shardings, b) for b in blocks]
    got = to_jax_params(pmesh.unpack_blocks(shardings, blocks[0], parts))
    want = tree_leaves(tiny_tree)
    assert len(tree_leaves(got["params"])) == len(want)
    for a, b in zip(tree_leaves(got["params"]), want):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_init_distributed(monkeypatch):
    """No WORLD_SIZE: False and no process group (the one-process path);
    two ranks on a host with one card: refused before any group is made;
    one rank a card: the rank's card set first, then NCCL for CUDA tensors
    and gloo for CPU ones (gloo alone without CUDA) unless a backend is
    named."""
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.init_distributed() is False and not dist.is_initialized()
    assert pmesh.world_size() == 1 and pmesh.global_rank() == 0
    assert pmesh.describe() == "one process (no process group)"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank a card"):
        pmesh.init_distributed()
    assert not dist.is_initialized()

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    monkeypatch.setattr(dist, "init_process_group", lambda **k: calls.append(("pg", k)))
    for cuda, backend, expected in ((True, None, "cpu:gloo,cuda:nccl"), (False, None, "gloo"),
                                    (True, "gloo", "gloo")):
        calls.clear()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
        assert pmesh.init_distributed(backend) is True
        assert calls[-1] == ("pg", {"backend": expected, "init_method": "env://", "rank": 0,
                                    "world_size": 2})
        assert calls[:-1] == ([("card", 1)] if cuda else [])


# ---------------------------------------------------------------------------
# worlds of two gloo processes
# ---------------------------------------------------------------------------
def _start_world(root, spec: dict, inputs: dict, world: int = 2):
    """Write the spec and inputs, start ``world`` worker processes; returns
    the processes (wait with ``_finish_world``)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(root, "inputs.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, WORKER, str(root), str(r), str(world)], cwd=REPO,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _finish_world(root, procs) -> list:
    """Wait for every worker (a time limit each); each rank's results."""
    failed = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            failed.append(f"rank {r} exited with {p.returncode}:\n{err[-3000:]}")
    assert not failed, "\n".join(failed)
    assert all(p.poll() is not None for p in procs)
    res = []
    for r in range(len(procs)):
        with np.load(os.path.join(root, f"rank{r}.npz")) as data:
            res.append({k: data[k] for k in data.files})
    return res


def _flat(tree, prefix):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            out[prefix + "/".join(path)] = np.asarray(node)
    walk(tree, [])
    return out


def _leaves(res, case, what):
    keys = sorted(k for k in res if k.startswith(f"{case}/{what}/"))
    return [res[k] for k in keys]


TRAIN_CASES = {"dp2": ["exp.mesh.dp=2"], "sp2": ["exp.mesh.dp=1", "exp.mesh.sp=2"],
               "tp2": ["exp.mesh.dp=1", "exp.mesh.tp=2"]}
# train steps only (no loader case): tp=2 with each ResBlock recomputed
REMAT_CASES = {"tp2_remat": ["exp.mesh.dp=1", "exp.mesh.tp=2", "network.remat=true"]}
LOADER_STEPS = 3
# of the peak: the raw samples of a batch of one a rank against a batch of
# two, the CPU's float32 convolutions rounding each shape its own way
# through the sampler's steps (1.2e-5 read); a wrong row or draw is O(1)
SAMPLES_TOL = 1e-4


def _train_set(root) -> str:
    """Four utterances of two speakers in ``VCTKTrain``'s layout."""
    from buddy_tpu_torch.data.audio_io import write_wav
    for i in range(4):
        os.makedirs(os.path.join(root, f"p10{i % 2}"), exist_ok=True)
        write_wav(os.path.join(root, f"p10{i % 2}", f"utt{i}.wav"), clean_wav(i), 16000)
    return str(root)


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    """One world of two gloo ranks: the train steps (JAX's draws of the
    global batch replayed) and the loader cases; the JAX Trainer's steps on
    the same meshes run meanwhile.  Returns (the JAX results by case, each
    rank's results)."""
    from buddy_tpu_torch.training.checkpoint import tree_leaves
    tmp_path = tmp_path_factory.mktemp("train_world")
    _, tree = jax_tiny_bundle(N, seed=3)
    batch = np.stack([clean_wav(0)[1000:1000 + N], clean_wav(1)[5000:5000 + N]])
    inputs = {"batch": batch, **_flat(tree, "tree/")}
    jts = {}
    for name, extra in {**TRAIN_CASES, **REMAT_CASES}.items():
        jts[name] = jax_trainer(tree, batch, str(tmp_path / f"jax_{name}"), extra)
        _, draws = jax_train_draws(jts[name].rng, batch.shape)
        inputs[f"draws/{name}/sigma"], inputs[f"draws/{name}/prior"] = \
            draws["sigma"][0], draws["prior"][0]
    data = [f"dset.train.path={_train_set(tmp_path / 'vctk')}", "dset.train.segment_length=4096",
            "dset.train.speakers_test=[]", f"dset.test.path={_paired_set(tmp_path / 'paired')}",
            'dset.test.speakers_test=["p226"]', "dset.test.num_examples=2",
            "tester.sampling_params.T=2", "tester.unconditional.num_samples=2",
            "tester.unconditional.audio_len=4096"]
    spec = {"jobs": [
        {"job": "train", "cases": [{"name": k, "overrides": TINY_NET + TRAIN_SMALL + v}
                                   for k, v in {**TRAIN_CASES, **REMAT_CASES}.items()]},
        {"job": "loader", "steps": LOADER_STEPS,
         "cases": [{"name": f"loader_{k}", "overrides": TINY_NET + TRAIN_SMALL + data + v}
                   for k, v in TRAIN_CASES.items()]}]}
    root = tmp_path / "world"
    procs = _start_world(root, spec, inputs)
    jax_out = {}
    for name, jt in jts.items():
        jt.train_step()
        jax_out[name] = (jax.device_get(jt._metrics_acc),
                         [np.asarray(v) for v in jax.tree.leaves(jax.device_get(jt.opt_state))],
                         tree_leaves(jax.device_get(jt.params)),
                         tree_leaves(jax.device_get(jt.ema_params)),
                         any(np.ndim(v) == 4 and not v.sharding.is_fully_replicated
                             for v in jax.tree.leaves(jt.params)))
    assert jts["dp2"].mesh.shape == {"dp": 2} and jts["sp2"].mesh.shape == {"dp": 1, "sp": 2}
    assert all(jts[k].mesh.shape == {"dp": 1, "tp": 2} for k in ("tp2", "tp2_remat"))
    return jax_out, _finish_world(root, procs)


def test_train_steps_dp2_and_sp2_against_jax(train_world):
    """One train step on two gloo ranks at exp.mesh.dp=2 and at dp=1 x
    sp=2, JAX's draws of the global batch replayed, against the JAX
    Trainer's step on the same meshes of the virtual devices: the loss and
    the pre-clip norm (1e-5 relative), the bin sums, the gradients (from
    Adam's first moment: ``gradient_tolerances``), the moments, the
    parameters and the EMA (``assert_after_adam``); both ranks bit for bit;
    the mesh of the whole world runs on the default group, its one axis
    reusing it; the first rank alone writes the checkpoint, which every
    rank resumes."""
    jax_out, ranks = train_world
    for name in ("dp2", "sp2"):
        r0, r1 = ranks
        assert list(r0[f"{name}/mesh"]) == ([2, 1] if name == "dp2" else [1, 2])
        assert sorted(tuple(r[f"{name}/coords"]) for r in ranks) == \
            ([(0, 0), (1, 0)] if name == "dp2" else [(0, 0), (0, 1)])
        assert all(r[f"{name}/groups"].all() for r in ranks)
        for k in r0:                      # both ranks hold the same bits
            if k.startswith(name + "/") and not k.endswith(("/coords", "/files")):
                np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        assert [str(f) for f in r0[f"{name}/files"]] == ["VCTK_16k_4s_time-0.ckpt"]
        assert len(r1[f"{name}/files"]) == 0
        assert bool(r0[f"{name}/resumed"]) and bool(r1[f"{name}/resumed"])
        _against_jax(jax_out[name], r0, name)


def _against_jax(jax_out, r0, name):
    """The first rank's metrics, gradients, moments, parameters and EMA
    after one step against the JAX Trainer's."""
    jm, j_opt, j_params, j_ema, _ = jax_out
    tm = {k.split("/")[-1]: r0[k] for k in r0 if k.startswith(f"{name}/metrics/")}
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    np.testing.assert_array_equal(tm["bin_count"], jm["bin_count"])
    np.testing.assert_allclose(tm["bin_sum"], jm["bin_sum"], rtol=1e-5, atol=1e-9)
    t_opt = _leaves(r0, name, "opt")
    n = (len(j_opt) - 1) // 2
    assert len(t_opt) == len(j_opt) and int(t_opt[0]) == int(j_opt[0]) == 1
    g_jax = [m / np.float32(0.1) for m in j_opt[1:1 + n]]
    g_tol = gradient_tolerances(g_jax)
    for a, b, tol in zip(_leaves(r0, name, "grads"), g_jax, g_tol):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for a, b, tol in zip(t_opt[1:1 + n], j_opt[1:1 + n], g_tol):
        np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * tol)
    assert_after_adam(_leaves(r0, name, "params"), j_params, g_jax, g_tol)
    assert_after_adam(_leaves(r0, name, "ema"), j_ema, g_jax, g_tol)


@pytest.mark.parametrize("case", ["tp2", "tp2_remat"])
def test_train_step_tp2_against_jax(train_world, case):
    """One train step at exp.mesh.dp=1 x tp=2 on two gloo ranks (with
    ``remat``: each ResBlock's recomputation issuing its all-gathers again),
    JAX's draws replayed, against the JAX Trainer's step on the (1, 2) mesh,
    whose conv kernels GSPMD shards: the loss, the norm, the bin sums, and
    the gradients, moments, parameters and EMA gathered to the first rank,
    at dp2 and sp2's tolerances.  Each rank holds its half of every conv
    kernel and of its moments and EMA (the gathered tree's rows of that
    rank) and the same bits of every replicated leaf; the first rank alone
    writes the checkpoint, which every rank resumes at tp=2 and at tp=1
    (the whole tree, bit for bit)."""
    from buddy_tpu_torch.models.convert import from_jax_params
    from buddy_tpu_torch.training.checkpoint import tree_like
    jax_out, ranks = train_world
    assert jax_out[case][4], "the JAX Trainer did not shard a conv kernel over tp"
    _against_jax(jax_out[case], ranks[0], case)
    _, tree = jax_tiny_bundle(N, seed=3)
    whole = {what: from_jax_params(tree_like(tree, _leaves(ranks[0], case, what)))
             for what in ("grads", "params", "ema")}
    opt = _leaves(ranks[0], case, "opt")
    n = (len(opt) - 1) // 2
    whole["mu"] = from_jax_params(tree_like(tree, opt[1:1 + n]))
    whole["nu"] = from_jax_params(tree_like(tree, opt[1 + n:]))
    halves = 0
    for r, rk in enumerate(ranks):
        assert list(rk[f"{case}/tp"]) == [2, r] and list(rk[f"{case}/groups"]) == [True, True]
        assert list(rk[f"{case}/mesh"]) == [1, 1] and list(rk[f"{case}/coords"]) == [0, 0]
        for what, state in whole.items():
            for k, v in state.items():
                mine = rk[f"{case}/blocks/{what}/{k}"]
                if mine.shape != v.shape:           # this rank's rows of a sharded kernel
                    assert mine.ndim == 4 and 2 * mine.shape[0] == v.shape[0], k
                    v, halves = v[r * mine.shape[0]:(r + 1) * mine.shape[0]], halves + 1
                np.testing.assert_array_equal(mine, v.numpy(), err_msg=f"{case} {what} {k}")
        assert bool(rk[f"{case}/resumed"]) and bool(rk[f"{case}/resumed_tp1"])
    assert halves == 2 * 5 * sum(v.ndim == 4 for v in whole["params"].values())
    assert [str(f) for f in ranks[0][f"{case}/files"]] == ["VCTK_16k_4s_time-0.ckpt"]
    assert len(ranks[1][f"{case}/files"]) == 0


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_ranks_train_on_the_first_ranks_global_batch(train_world, case):
    """The training CLI's order on both ranks (the real ``VCTKTrain`` and
    native loader with exp.num_workers threads, whose order differs from
    rank to rank, then a test set, the in-training tester, the Trainer):
    whatever each rank's loader read,
    ``get_batch`` hands every rank its rows of the first rank's global
    batch, at dp=2 its half, at dp=1 x sp=2 the whole batch on both ranks.
    The tester samples on the trainer's mesh: ``heavy_logging``'s 2 samples
    (one a rank at dp=2, both on each rank at sp=2) reach the first rank,
    which alone writes them, and agree between the two meshes within
    ``SAMPLES_TOL``."""
    _, (r0, r1) = train_world
    key = f"loader_{case}"
    assert bool(r0[f"{key}/tester_mesh"]) and bool(r1[f"{key}/tester_mesh"])
    assert [str(f) for f in r0[f"{key}/files"]] == ["sample_0_it0.wav", "sample_1_it0.wav"]
    assert len(r1[f"{key}/files"]) == 0
    if case == "dp2":
        assert f"{key}/samples" not in r1
    else:
        np.testing.assert_array_equal(r1[f"{key}/samples"], r0[f"{key}/samples"])
    assert r0[f"{key}/samples"].shape == (2, N) and np.isfinite(r0[f"{key}/samples"]).all()
    assert rel_err(r0["loader_dp2/samples"], r0["loader_sp2/samples"]) < SAMPLES_TOL
    assert rel_err(r0[f"{key}/samples"], r0["loader_sp2/samples"]) < SAMPLES_TOL
    for i in range(LOADER_STEPS):
        glob = r0[f"loader_{case}/read{i}"]
        assert glob.shape == (2, N) and np.abs(glob).max() > 0
        b0, b1 = r0[f"loader_{case}/batch{i}"], r1[f"loader_{case}/batch{i}"]
        if case == "dp2":
            np.testing.assert_array_equal(np.concatenate([b0, b1]), glob)
        else:
            np.testing.assert_array_equal(b0, glob)
            np.testing.assert_array_equal(b1, glob)


def _paired_set(root):
    """Two clean/RIR pairs of 16384 samples in ``VCTKTestPaired``'s layout."""
    from buddy_tpu_torch.data.audio_io import write_wav
    rng = np.random.default_rng(23)
    for i in range(2):
        rir = np.exp(-np.arange(3000) / 450.0) * rng.standard_normal(3000) * 0.3
        rir[0] = 1.5
        for sub, data in (("clean", clean_wav(i)[:16384]), ("rir", rir.astype(np.float32))):
            os.makedirs(os.path.join(root, sub, "p226"), exist_ok=True)
            write_wav(os.path.join(root, sub, "p226", f"utt{i}.wav"), data, 16000)
    return str(root)


TESTER_TOL = 1e-5               # of each WAV's peak, world of two against one process


def test_sharded_tester_against_one_process(tmp_path):
    """``Tester.do_test()`` on two gloo ranks against the same run in one
    process: batched blind dereverberation of 2 utterances (batch 2, one
    utterance a rank, the global batch's draws sliced) and 2 unconditional
    samples (one a rank).  Every WAV within 1e-5 of its peak (one utterance
    a batch against two: the CPU's convolutions and FFTs may round a batch
    of one otherwise); the first rank writes the one set of outputs, the
    second none; the samples returned on the first rank."""
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.testing.tester import Tester
    _, tree = jax_tiny_bundle(16384, seed=44)
    data = _paired_set(tmp_path / "paired")
    base = [*TINY_NET, "tester.sampling_params.T=2", "tester.overriden_name=run"]
    cases = {
        "blind": (["tester=blind_dereverberation_BUDDy", *base, "dset=vctk_16k_4s_test-benchmark",
                   f"dset.test.path={data}", 'dset.test.speakers_test=["p226"]',
                   "tester.posterior_sampling.blind_hp.op_updates_per_step=1",
                   "tester.posterior_sampling.warm_initialization.mode=reverb_scaled",
                   "tester.batched.use=True", "tester.batched.batch_size=2"], True),
        "unconditional": (["tester=only_unconditional", *base,
                           "tester.unconditional.num_samples=2",
                           "tester.unconditional.audio_len=16384"], False)}
    spec = {"jobs": [{"job": "tester", "cases": [{"name": k, "overrides": v, "test_set": ts}
                                                 for k, (v, ts) in cases.items()]}]}
    root = tmp_path / "world"
    procs = _start_world(root, spec, _flat(tree, "tree/"))
    one = {}
    for name, (over, with_set) in cases.items():
        out = tmp_path / f"one_{name}"
        args = compose("conf_VCTK.yaml", over + [f"model_dir={out}"])
        t = Tester(args, torch_tiny_bundle(tree), instantiate(args["diff_params"]),
                   instantiate(args["dset"]["test"]) if with_set else None, device="cpu")
        assert t.mesh is None
        one[name] = (str(out), t.do_test())
    ranks = _finish_world(root, procs)

    for name in cases:
        out, samples = one[name]
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        assert [str(f) for f in ranks[0][f"{name}/files"]] == files and files
        assert len(ranks[1][f"{name}/files"]) == 0
        for f in files:
            if f.endswith(".wav"):
                a = read_wav(os.path.join(root, f"{name}_rank0", f))[0]
                b = read_wav(os.path.join(out, f))[0]
                assert a.shape == b.shape and np.isfinite(a).all()
                assert rel_err(a, b) < TESTER_TOL, f
        if name == "unconditional":
            assert rel_err(ranks[0][f"{name}/samples"], samples) < TESTER_TOL
            assert f"{name}/samples" not in ranks[1]
    assert sum(f.endswith(".wav") for f in ranks[0]["blind/files"]) == 10
