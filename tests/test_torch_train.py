"""The port's training half against the JAX package on the CPU: EDM's
training functions, one train step of the port's Trainer against the JAX
Trainer's (plain, with grad_accum=2, and with clipping acting) with JAX's
draws replayed, the EMA under its rampup, the sigma bins, the training set
and its loader, the in-training tester, and the training CLI.  Test size:
TINY_NET, batch 2 of 4096 samples, the in-repo WAVs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (REPO, TINY_NET, ReplayNoise, assert_after_adam, clean_wav,
                               gradient_tolerances, jax_tiny_bundle, jax_train_draws, jax_trainer,
                               torch_compose, torch_trainer)

from buddy_tpu_torch.models.convert import to_jax_params
from buddy_tpu_torch.training.checkpoint import tree_leaves

N = 4096
W_KEY = "unet.all_modules.0.W"


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    """Speaker directories of in-repo clean speech: p226 (two utterances of
    65536 samples and one of 3000, which is wrap-padded), p227 (a test
    speaker) and p280 (discarded)."""
    from buddy_tpu_torch.data.audio_io import write_wav
    root = tmp_path_factory.mktemp("train")
    files = {"p226": [clean_wav(0), clean_wav(1), clean_wav(2)[:3000]],
             "p227": [clean_wav(3)], "p280": [clean_wav(4)]}
    for spk, sigs in files.items():
        os.makedirs(root / spk)
        for i, s in enumerate(sigs):
            write_wav(str(root / spk / f"u{i}.wav"), s, 16000)
    return str(root)


@pytest.fixture(scope="module")
def weights():
    """TINY_NET weights (seeded) and a batch of in-repo speech."""
    _, tree = jax_tiny_bundle(N, seed=3)
    batch = np.stack([clean_wav(0)[1000:1000 + N], clean_wav(1)[5000:5000 + N]])
    return tree, batch


# ---------------------------------------------------------------------------
# EDM's training half
# ---------------------------------------------------------------------------
def test_edm_training_half_against_jax():
    """sample_time_training, sample_prior, prepare_train_preconditioning,
    loss_fn (with JAX's split order: noise levels, then noise), lambda_w and
    the Tweedie/score/ODE conversions against buddy_tpu/diffusion/edm.py,
    1e-6 of each output's peak."""
    from buddy_tpu.diffusion.edm import EDM as JEDM
    from buddy_tpu_torch.diffusion.edm import EDM
    hp = dict(torch_compose([])["diff_params"]["sde_hp"])
    je, te = JEDM(sde_hp=hp), EDM(sde_hp=hp)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 512)) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(9)
    _, draws = jax_train_draws(key, x.shape)
    rel = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                             / (np.abs(np.asarray(b)).max() + 1e-30))

    t_j = je.sample_time_training(jax.random.split(jax.random.split(key)[1])[0], 3)
    t_t = te.sample_time_training(ReplayNoise(draws), 3)
    assert rel(t_t, t_j) < 1e-6
    n_t = te.sample_prior(ReplayNoise(draws), x.shape)
    np.testing.assert_array_equal(n_t.numpy(), draws["prior"][0])

    xt, tt, nt = torch.from_numpy(x), torch.as_tensor(np.asarray(t_j)), torch.from_numpy(
        draws["prior"][0])
    for a, b in zip(te.prepare_train_preconditioning(xt, tt, nt),
                    je.prepare_train_preconditioning(jnp.asarray(x), t_j, jnp.asarray(nt.numpy()))):
        assert rel(a, b) < 1e-6

    w = rng.standard_normal(512).astype(np.float32)
    jnet = lambda z, c: jnp.tanh(z * jnp.asarray(w)) + c[:, None]
    tnet = lambda z, c: torch.tanh(z * torch.from_numpy(w)) + c[:, None]
    err_j, sig_j = je.loss_fn(jnet, jax.random.split(key)[1], jnp.asarray(x))
    err_t, sig_t = te.loss_fn(tnet, ReplayNoise(draws), xt)
    assert rel(err_t, err_j) < 1e-6 and rel(sig_t, sig_j) < 1e-6

    score = rng.standard_normal(x.shape).astype(np.float32)
    s = torch.from_numpy(score)
    assert rel(te.lambda_w(tt), je.lambda_w(t_j)) < 1e-6
    assert rel(te.tweedie_to_score(nt, xt, tt), je.tweedie_to_score(nt.numpy(), x, t_j)) < 1e-6
    assert rel(te.score_to_tweedie(s, xt, tt), je.score_to_tweedie(score, x, t_j)) < 1e-6
    assert rel(te.ode_integrand(xt, tt, s), je.ode_integrand(x, t_j, score)) < 1e-6
    assert te._mean(xt, tt) is xt and te._std(tt) is tt


# ---------------------------------------------------------------------------
# one train step against the JAX Trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,extra", [
    ("plain", []),
    ("grad_accum", ["exp.grad_accum=2"]),
    ("clipping", ["exp.max_grad_norm=0.004"]),
])
def test_train_step_against_jax(tmp_path, weights, case, extra):
    """One train step at it=0 with JAX's draws replayed: the loss and the
    pre-clip global norm (1e-5 relative), the (clipped, averaged) gradients
    read from Adam's first moment (1e-4 of each leaf's peak), the moments,
    the parameters and the EMA (see ``assert_after_adam``), the sigma bins,
    and the frozen W bit for bit."""
    tree, batch = weights
    jt = jax_trainer(tree, batch, str(tmp_path / "jax"), extra)
    _, draws = jax_train_draws(jt.rng, batch.shape)
    jt.train_step()
    jm = jax.device_get(jt._metrics_acc)
    tt = torch_trainer(tree, batch, str(tmp_path / "torch"), extra, noise=ReplayNoise(draws))
    tt.train_step()
    tm = {k: v.numpy() for k, v in tt._metrics_acc.items()}

    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    if case == "clipping":
        assert jm["grad_norm"] > 0.004          # the clip acts
    else:
        assert jm["grad_norm"] < 1.0
    np.testing.assert_array_equal(tm["bin_count"], jm["bin_count"])
    np.testing.assert_allclose(tm["bin_sum"], jm["bin_sum"], rtol=1e-5, atol=1e-9)

    j_opt = [np.asarray(v) for v in jax.tree.leaves(jax.device_get(jt.opt_state))]
    t_opt = tt.opt_leaves()
    n = (len(j_opt) - 1) // 2
    assert len(t_opt) == len(j_opt) and int(t_opt[0]) == int(j_opt[0]) == 1
    assert t_opt[0].dtype == j_opt[0].dtype == np.int32
    g_jax = [m / np.float32(0.1) for m in j_opt[1:1 + n]]
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tt.params.items()}
    g_tol = gradient_tolerances(g_jax)
    for a, b, tol in zip(tree_leaves(to_jax_params(grads)), g_jax, g_tol):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    for a, b, tol in zip(t_opt[1:1 + n], j_opt[1:1 + n], g_tol):          # mu = 0.1 g
        np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * tol)
    for a, b, g, tol in zip(t_opt[1 + n:], j_opt[1 + n:], g_jax, g_tol):  # nu = 1e-3 g^2
        peak = float(np.abs(g).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * (2 * peak * tol + tol * tol))

    j_params = tree_leaves(jax.device_get(jt.params))
    assert_after_adam(tree_leaves(to_jax_params(tt.params)), j_params, g_jax, g_tol)
    assert_after_adam(tree_leaves(to_jax_params(tt.ema)),
                      tree_leaves(jax.device_get(jt.ema_params)),
                      g_jax, g_tol)
    w0 = tree["params"]["unet"]["all_modules_0"]["W"]
    np.testing.assert_array_equal(tt.params[W_KEY].detach().numpy(), w0)
    np.testing.assert_array_equal(
        np.asarray(jt.params["params"]["unet"]["all_modules_0"]["W"]), w0)


def test_ema_rampup_and_frozen_w(tmp_path, weights):
    """The EMA after each step against a float32 numpy oracle of
    ema s + p (1 - s), s = clip(it batch / rampup, 0, rate) while
    it batch < rampup, else rate (rampup 10, batch 2: s = 0, 0.2, 0.4 and
    then the rate); the frozen W keeps its bits and zero moments."""
    tree, batch = weights
    tt = torch_trainer(tree, batch, str(tmp_path), ["exp.ema_rampup=10"])
    ema = {k: v.detach().numpy().copy() for k, v in tt.params.items()}
    w0 = tt.params[W_KEY].detach().clone()
    for it, s in ((0, 0.0), (1, 0.2), (2, 0.4), (5, 0.9999)):
        tt.it = it
        tt.train_step()
        s = np.float32(s)
        for k, p in tt.params.items():
            ema[k] = ema[k] * s + p.detach().numpy() * (np.float32(1.0) - s)
            np.testing.assert_allclose(tt.ema[k].numpy(), ema[k], rtol=1e-6, atol=0)
    assert torch.equal(tt.params[W_KEY], w0)
    assert not tt.params[W_KEY].requires_grad
    assert not tt.mu[W_KEY].any() and not tt.nu[W_KEY].any()
    assert tt.count == 4


def test_sigma_bins_match_numpy_oracle(tmp_path, weights):
    """The device-side sigma-bin sums equal a numpy computation from the
    same error and sigmas (left searchsorted clipped to the last bin, every
    item counted); easy_logging reports the same mean loss through
    training.stats and writes train_log.jsonl."""
    from buddy_tpu_torch.training import stats
    from test_torch_common import torch_tiny_bundle
    tree, batch = weights
    _, d0 = jax_train_draws(jax.random.PRNGKey(1), (4, N))
    big = np.concatenate([batch, batch[::-1]])
    tt = torch_trainer(tree, big, str(tmp_path), ["exp.batch_size=4"], noise=ReplayNoise(d0))
    tt.train_step()
    acc = {k: v.numpy() for k, v in tt._metrics_acc.items()}

    net = torch_tiny_bundle(tree)
    with torch.no_grad():
        error, sigma = tt.diff_params.loss_fn(
            lambda x, c: net(x[:, None, :], c)[:, 0, :], ReplayNoise(d0), torch.from_numpy(big))
    per = error.numpy().reshape(4, -1).mean(1)
    bins = tt.sigma_bins
    idx = np.clip(np.searchsorted(bins, sigma.numpy()), 0, len(bins) - 1)
    want = np.zeros((3, len(bins)))
    for i, b in enumerate(idx):
        want[:, b] += (per[i], per[i] ** 2, 1)
    np.testing.assert_allclose(acc["loss"], error.numpy().mean(), rtol=1e-5)
    np.testing.assert_array_equal(acc["bin_count"], want[2])
    np.testing.assert_allclose(acc["bin_sum"], want[0], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(acc["bin_sumsq"], want[1], rtol=1e-5, atol=1e-12)

    # an edge goes to its own bin, a sigma past the last edge to the last bin
    s = torch.tensor([bins[3], bins[-1] * 2, bins[0] / 2, bins[3] * 1.0001], dtype=torch.float32)
    counts = tt._bin_stats(torch.ones(4, 8), s)[2].numpy()
    assert counts[3] == 1 and counts[4] == 1 and counts[-1] == 1 and counts[0] == 1

    stats._counters.clear()
    tt.easy_logging()
    assert abs(tt.stats_collector.mean("loss") - float(error.mean())) < 1e-5
    with open(tmp_path / "train_log.jsonl") as f:
        row = json.loads(f.readline())
    assert row["it"] == 0 and abs(row["loss"] - float(error.mean())) < 1e-5
    assert len(row["bin_means"]) == len(bins)
    assert tt._metrics_acc is None


def test_heavy_logging_samples_the_ema_and_leaves_the_trainer_weights(tmp_path, weights):
    """heavy_logging samples from the EMA through the shared network (the
    in-training tester makes no directories) and writes the samples; the
    trainer's parameters keep their bits and no gradient is taken."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.testing.tester import Tester
    from test_torch_common import torch_tiny_bundle
    tree, batch = weights
    extra = ["exp.ema_rampup=10", "tester.sampling_params.T=2",
             "tester.unconditional.num_samples=2", f"tester.unconditional.audio_len={N}"]
    tt = torch_trainer(tree, batch, str(tmp_path), extra)
    tester = Tester(tt.args, tt.network, tt.diff_params, device="cpu", in_training=True)
    tt.tester = tester
    for it in (0, 1):
        tt.it = it
        tt.train_step()
    before = {k: p.detach().clone() for k, p in tt.params.items()}
    grads = {k: None if p.grad is None else p.grad.clone() for k, p in tt.params.items()}
    assert not all(torch.equal(tt.ema[k], before[k]) for k in before)
    tt.heavy_logging()
    for k, p in tt.params.items():
        assert torch.equal(p, before[k])
        assert (p.grad is None) == (grads[k] is None)
        assert p.grad is None or torch.equal(p.grad, grads[k])
    files = sorted(os.listdir(tmp_path))
    assert files == ["sample_0_it1.wav", "sample_1_it1.wav"], files

    ref = torch_tiny_bundle(tree)
    ref.module.load_state_dict({k: v.clone() for k, v in tt.ema.items()})
    ref_tester = Tester(tt.args, ref, tt.diff_params, device="cpu", in_training=True)
    want = ref_tester.do_test(it=1)
    from buddy_tpu_torch.data.audio_io import read_wav
    got = read_wav(str(tmp_path / "sample_0_it1.wav"))[0]
    np.testing.assert_allclose(got, 0.95 * want[0] / np.abs(want[0]).max(), rtol=0, atol=1e-6)


def test_profiler_hook_follows_the_schedule(tmp_path, weights):
    """logging.profiling: one trace over the ``active`` iterations after
    ``wait`` + ``warmup``, per cycle, ``repeat`` cycles, then off."""
    tree, batch = weights
    tt = torch_trainer(tree, batch, str(tmp_path), [
        "logging.profiling.enabled=True", "logging.profiling.wait=1",
        "logging.profiling.warmup=0", "logging.profiling.active=1",
        "logging.profiling.repeat=2", "exp.max_iters=5"])
    tt.training_loop()
    assert sorted(os.listdir(tmp_path / "tbprofile")) == ["trace_it1-2.json", "trace_it3-4.json"]
    assert not tt.profile and tt._profiler is None


def test_trainer_needs_the_card_unless_asked_for_the_cpu(monkeypatch, weights):
    from buddy_tpu_torch.config import instantiate
    from test_torch_common import FixedLoader, torch_tiny_bundle
    tree, batch = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = torch_compose(TINY_NET)
    with pytest.raises(RuntimeError, match="CUDA"):
        instantiate(args["exp"]["trainer"], args, FixedLoader(batch), torch_tiny_bundle(tree),
                    instantiate(args["diff_params"]), None)
    # one process: a mesh of two ranks is refused, along dp or along tp (as
    # the JAX package's make_mesh refuses two devices of one)
    for over, error, match in (("exp.mesh.dp=2", ValueError, "ranks"),
                               ("exp.mesh.tp=2", ValueError, "ranks")):
        bad = torch_compose(TINY_NET + [over])
        with pytest.raises(error, match=match):
            instantiate(bad["exp"]["trainer"], bad, FixedLoader(batch), torch_tiny_bundle(tree),
                        instantiate(bad["diff_params"]), None, device="cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _train_kwargs(path, seed=3, segment=N):
    return dict(fs=16000, segment_length=segment, path=path, speakers_discard=["p280"],
                speakers_test=["p227"], seed=seed)


def test_vctk_train_segments_match_jax(train_dir):
    """For the same files and seed, VCTKTrain yields the JAX class's segments
    (crops of the long files, wrap-pads of the short one), and scans only
    the training speakers."""
    from buddy_tpu.data.vctk import VCTKTrain as JTrain
    from buddy_tpu_torch.data.vctk import VCTKTrain
    jd = JTrain(**_train_kwargs(train_dir))
    want = [jd.sample_segment() for _ in range(12)]
    td = VCTKTrain(**_train_kwargs(train_dir))
    got = [td.sample_segment() for _ in range(12)]
    assert [os.path.relpath(f, train_dir) for f in td.train_samples] == \
        ["p226/u0.wav", "p226/u1.wav", "p226/u2.wav"]
    assert td.train_samples == jd.train_samples
    for a, b in zip(got, want):
        assert a.shape == (N,) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    short = clean_wav(2)[:3000]
    assert any(np.array_equal(np.sort(g[:3000]), np.sort(short)) for g in got)


def test_loader_batches_match_jax(train_dir):
    """The threaded loader's batches equal the JAX PythonBatchLoader's over
    the same dataset seed; the loader's thread stops on close.  (For a
    VCTKTrain ``make_train_loader`` builds the native loader, held to the
    JAX package's in tests/test_torch_native_io.py.)"""
    from buddy_tpu.data.loader import PythonBatchLoader as JLoader
    from buddy_tpu.data.vctk import VCTKTrain as JTrain
    from buddy_tpu_torch.data.loader import PythonBatchLoader
    from buddy_tpu_torch.data.vctk import VCTKTrain
    jl = JLoader(JTrain(**_train_kwargs(train_dir, seed=5)), batch_size=3, prefetch=1)
    want = [jl.next_batch() for _ in range(4)]
    jl.close()                 # its thread draws (numpy's global generator) until it is let go
    while jl._thread.is_alive():
        try:
            jl._q.get(timeout=0.1)
        except Exception:      # noqa: BLE001 -- queue.Empty: the thread is finishing its draw
            pass
        jl._thread.join(0.1)
    tl = PythonBatchLoader(VCTKTrain(**_train_kwargs(train_dir, seed=5)), batch_size=3)
    got = [tl.next_batch() for _ in range(4)]
    tl.close()
    assert not tl._thread.is_alive()
    for a, b in zip(got, want):
        assert a.shape == (3, N) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loader_raises_the_dataset_error():
    from buddy_tpu_torch.data.loader import PythonBatchLoader

    def broken():
        yield np.zeros(4, np.float32)
        raise OSError("unreadable file")

    class Data:
        def __iter__(self):
            return broken()

    loader = PythonBatchLoader(Data(), batch_size=2)
    with pytest.raises(RuntimeError, match="thread failed"):
        loader.next_batch()
    loader.close()


def test_read_segment_crop_and_wrap(tmp_path):
    """A random crop of a longer file (a contiguous slice in range), a
    cyclic wrap-pad of a shorter one, the same for the same seed."""
    from buddy_tpu_torch.data.audio_io import read_segment, write_wav
    x = (np.random.default_rng(0).standard_normal(3000) * 0.1).astype(np.float32)
    p = str(tmp_path / "seg.wav")
    write_wav(p, x, 16000)
    starts = set()
    for seed in range(20):
        seg = read_segment(p, 1000, seed=seed)
        start = [s for s in range(2000) if np.array_equal(x[s:s + 1000], seg)]
        assert len(start) == 1
        starts.add(start[0])
    assert len(starts) > 10
    np.testing.assert_array_equal(read_segment(p, 1000, 7), read_segment(p, 1000, 7))
    seg = read_segment(p, 5000, seed=7)
    idx = [i for i in range(2000) if np.array_equal(seg, x[(np.arange(5000) - i) % 3000])]
    assert len(idx) == 1
    np.testing.assert_array_equal(read_segment(p, 3000, seed=1), x)


# ---------------------------------------------------------------------------
# the trainer's other options
# ---------------------------------------------------------------------------
def test_fft_convolve_zero_pad_against_jax():
    from buddy_tpu.ops.fftconv import fft_convolve as jconv
    from buddy_tpu_torch.ops.fftconv import fft_convolve
    rng = np.random.default_rng(2)
    y, h = rng.standard_normal((2, 1000)).astype(np.float32), rng.standard_normal(300).astype(
        np.float32)
    for zp in (False, True):
        got = fft_convolve(torch.from_numpy(y), torch.from_numpy(h), zero_pad=zp).numpy()
        want = np.asarray(jconv(jnp.asarray(y), jnp.asarray(h), zero_pad=zp))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    direct = np.stack([np.convolve(r, h)[:1000] for r in y])
    np.testing.assert_allclose(fft_convolve(torch.from_numpy(y), torch.from_numpy(h),
                                            zero_pad=True).numpy(), direct, atol=1e-4)


def test_write_audio_file_normalize_and_plot(tmp_path):
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.utils.log import plot_loss_by_sigma, write_audio_file
    x = np.linspace(-2, 1, 100).astype(np.float32)
    path = write_audio_file(x, 16000, "a", path=str(tmp_path / "d"), normalize=True, stereo=True)
    y, sr = read_wav(path)
    assert sr == 16000 and abs(float(np.abs(y).max()) - 0.95) < 1e-6
    np.testing.assert_allclose(y, 0.95 * x / 2, atol=1e-7)
    y2 = read_wav(write_audio_file(x, 16000, "b", path=str(tmp_path)))[0]
    np.testing.assert_array_equal(y2, x)
    out = plot_loss_by_sigma([1.0, np.nan, 0.5], [0.1, 0.0, 0.2], [1e-3, 1e-2, 1e-1],
                             out_path=str(tmp_path / "p.png"))
    assert os.path.getsize(out) > 0


def test_training_cli_on_cpu(tmp_path, train_dir):
    """``python -m buddy_tpu_torch.training`` with device=cpu trains two
    iterations past 0, logs, samples in training and saves a checkpoint,
    which ``python -m buddy_tpu_torch.testing`` loads."""
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "buddy_tpu_torch.training", "--config-name=conf_VCTK.yaml",
           *TINY_NET, f"dset.train.path={train_dir}", "dset.train.segment_length=4096",
           "exp.batch_size=2", "exp.audio_len=4096", "exp.max_iters=2",
           "logging.save_interval=2", "logging.log_interval=1", "logging.heavy_log_interval=2",
           "tester.sampling_params.T=2", "tester.unconditional.num_samples=1",
           "tester.unconditional.audio_len=4096", f"model_dir={out}", "+gpu=0", "device=cpu"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Training options:" in run.stdout and "it=2 loss=" in run.stdout
    files = sorted(os.listdir(out))
    assert "VCTK_16k_4s_time-2.ckpt" in files and "sample_0_it2.wav" in files, files
    with open(out / "train_log.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["it"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)

    os.makedirs(tmp_path / "paired" / "clean")           # an empty test set
    cmd = [sys.executable, "-m", "buddy_tpu_torch.testing", "--config-name=conf_VCTK.yaml",
           *TINY_NET, "tester=only_unconditional",
           f"tester.checkpoint={out}/VCTK_16k_4s_time-2.ckpt",
           "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={tmp_path / 'paired'}",
           "tester.sampling_params.T=2", "tester.unconditional.num_samples=1",
           "tester.unconditional.audio_len=4096", "tester.overriden_name=cli",
           f"model_dir={out}", "device=cpu"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "(it=2)" in run.stdout
    assert sorted(os.listdir(out / "cli" / "unconditional" / "VCTK_16k_4s_time")) == \
        [".argv", "unconditional_0.wav"]
