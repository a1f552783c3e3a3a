"""The port's tester and CLI against the JAX package on the CPU: the paired
test set, the metrics, loading a checkpoint that the JAX package wrote, the
batching helpers, the chunked path, and ``do_test`` in each mode with the JAX
tester's random draws replayed (same directory layout, same waveforms).
Test size: TINY_NET, 16384-sample signals, T = 2, 2 operator updates.
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

from test_torch_common import (REPO, ReplayNoise, TINY_NET, jax_compose, jax_tester_draws,
                               jax_tiny_bundle, rel_err, torch_compose, torch_tiny_bundle)

N = 16384
LENGTHS = (N, 15000)            # the second item is bucket-padded to 16384


def _read(path):
    from buddy_tpu_torch.data.audio_io import read_wav
    return read_wav(path)[0]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two clean/RIR pairs in ``VCTKTestPaired``'s layout: in-repo clean
    speech, seeded decaying-noise RIRs with a pre-delay before the direct
    path (so the trim at the argmax has something to remove)."""
    from buddy_tpu_torch.data.audio_io import write_wav
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(17)
    for i, n in enumerate(LENGTHS):
        clean = _read(os.path.join(REPO, "quality_out_heldout", f"clean_utt{i}.wav"))[:n]
        rir = np.exp(-np.arange(3000) / 450.0) * rng.standard_normal(3000) * 0.3
        rir[0] = 1.5
        rir = np.concatenate([0.01 * rng.standard_normal(23 + i), rir]).astype(np.float32)
        for sub, data in (("clean", clean), ("rir", rir)):
            os.makedirs(root / sub / "p226", exist_ok=True)
            write_wav(str(root / sub / "p226" / f"utt{i}.wav"), data, 16000)
    os.makedirs(root / "clean" / "p999", exist_ok=True)      # not a test speaker: skipped
    write_wav(str(root / "clean" / "p999" / "x.wav"), np.zeros(100, np.float32), 16000)
    return str(root)


def _overrides(dataset, model_dir, tester, extra=()):
    return [f"tester={tester}", *TINY_NET, "dset=vctk_16k_4s_test-benchmark",
            f"dset.test.path={dataset}", 'dset.test.speakers_test=["p226"]',
            f"model_dir={model_dir}", "tester.overriden_name=run",
            "tester.sampling_params.T=2", "tester.evaluate.use=True", *extra]


@pytest.fixture(scope="module")
def nets():
    jnet, tree = jax_tiny_bundle(N, seed=44)
    return jnet, tree


def _testers(overrides, nets):
    """The JAX tester and the port's, on the same config and weights."""
    from buddy_tpu.config import instantiate as jinst
    from buddy_tpu.testing.tester import Tester as JTester
    from buddy_tpu_torch.config import instantiate as tinst
    from buddy_tpu_torch.testing.tester import Tester
    jargs, targs = jax_compose(overrides), torch_compose(overrides)
    targs["model_dir"] = os.path.join(str(targs["model_dir"]), "torch")
    jargs["model_dir"] = os.path.join(str(jargs["model_dir"]), "jax")
    jt = JTester(jargs, nets[0], jinst(jargs["diff_params"]), jinst(jargs["dset"]["test"]))
    tt = Tester(targs, torch_tiny_bundle(nets[1]), tinst(targs["diff_params"]),
                tinst(targs["dset"]["test"]), device="cpu")
    return jt, tt


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _compare_runs(jt, tt, tol):
    """Same files in both output trees; every WAV agrees within ``tol`` of its
    peak (the inputs exactly-ish: 1e-5); metrics.jsonl has the same keys."""
    jroot, troot = jt.path_sampling, tt.path_sampling
    files = _tree(troot)
    assert files == _tree(jroot) and files
    for f in files:
        if f.endswith(".wav"):
            a, b = _read(os.path.join(troot, f)), _read(os.path.join(jroot, f))
            assert a.shape == b.shape and np.isfinite(a).all(), f
            exact = any(s in f for s in ("original", "degraded", "true_rir"))
            assert rel_err(a, b) < (1e-5 if exact else tol), f
        elif f.endswith("metrics.jsonl"):
            keys = lambda root: [sorted(json.loads(ln)) for ln in open(os.path.join(root, f))]
            assert keys(troot) == keys(jroot)
    return files


# --- data, metrics, checkpoints ----------------------------------------------------
def test_paired_test_set_against_jax(dataset):
    from buddy_tpu.data.vctk import VCTKTestPaired as JPaired
    from buddy_tpu_torch.data.vctk import VCTKTest, VCTKTestPaired
    kw = dict(fs=16000, segment_length=-1, path=dataset, speakers_discard=[],
              speakers_test=["p226"], num_examples=-1, shuffle=False)
    jset, tset = JPaired(**kw), VCTKTestPaired(**kw)
    assert len(tset) == len(jset) == 2
    for i in range(2):
        (ta, tr, tn), (ja, jr, jn) = tset[i], jset[i]
        assert tn == jn == f"utt{i}.wav"
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tr, jr)
        assert len(ta) == LENGTHS[i] and len(tr) == 3000 and abs(tr[0]) == 1.0
    with pytest.raises(AssertionError):
        VCTKTestPaired(**dict(kw, num_examples=3))
    single = VCTKTest(fs=16000, segment_length=4096, path=os.path.join(dataset, "clean"),
                      speakers_test=["p226"], num_examples=2, shuffle=False)
    assert len(single) == 2 and single[0][0].shape == (4096,) and single[1][1] == "utt1.wav"


def test_evaluation_against_jax():
    from buddy_tpu import evaluation as jev
    from buddy_tpu_torch import evaluation as tev
    rng = np.random.default_rng(3)
    clean = rng.standard_normal(8000)
    est, deg = clean + 0.1 * rng.standard_normal(8000), clean + rng.standard_normal(8000)
    rir = np.exp(-np.arange(2000) / 300.0) * rng.standard_normal(2000)
    args = (clean, est)
    kw = dict(degraded=deg, true_rir=rir, est_rir=1.1 * rir[:1500])
    assert tev.evaluate_utterance(*args, **kw) == jev.evaluate_utterance(*args, **kw)
    assert set(tev.evaluate_utterance(*args)) == {"si_sdr", "lsd"}
    assert tev.si_sdr(clean, 3.0 * clean) > 100


def test_jax_checkpoint_loads_into_the_port(tmp_path, nets):
    """A ``.ckpt`` written by the JAX package's ``save_checkpoint`` loads
    through ``load_any_checkpoint`` and ``from_jax_params``; both networks
    then give the same output (1e-4 of the peak: float32 U-Net, as in
    test_torch_model).  EMA weights are preferred; Orbax directories raise a
    clear error, and a ``.pt`` path goes to the reference-layout loader
    (tests/test_torch_checkpoint.py), which reports a missing file."""
    from buddy_tpu.training.checkpoint import save_checkpoint
    from buddy_tpu_torch.training.checkpoint import find_latest_checkpoint, load_any_checkpoint
    jnet, tree = nets
    ema = jax.tree.map(lambda a: np.asarray(a), tree)
    raw = jax.tree.map(lambda a: np.asarray(a) * 0.0, tree)
    path = save_checkpoint(str(tmp_path / "VCTK_16k_4s_time-12"), params=raw, ema_params=ema,
                           it=12)
    save_checkpoint(str(tmp_path / "VCTK_16k_4s_time-3"), params=raw, ema_params=ema, it=3)
    assert find_latest_checkpoint(str(tmp_path), "VCTK_16k_4s_time") == path
    assert find_latest_checkpoint(str(tmp_path), "other") is None
    loaded, it = load_any_checkpoint(path, prefer_ema=True)
    assert it == 12
    tnet = torch_tiny_bundle(loaded)
    x = np.random.default_rng(0).standard_normal((2, 1, 4096)).astype(np.float32)
    c = np.asarray([0.3, -0.7], np.float32)
    ref = np.asarray(jnet.module.apply(jnet.params, jnp.asarray(x), jnp.asarray(c)))
    out = tnet(torch.from_numpy(x), torch.from_numpy(c)).detach().numpy()
    assert rel_err(out, ref) < 1e-4
    zeros, _ = load_any_checkpoint(path, prefer_ema=False)
    assert all(not np.any(v) for v in jax.tree.leaves(zeros))
    with pytest.raises(FileNotFoundError):
        load_any_checkpoint(str(tmp_path / "weights.pt"))
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_any_checkpoint(str(tmp_path))
    with pytest.raises(ValueError):
        load_any_checkpoint(str(tmp_path / "weights.bin"))


# --- the tester's helpers ------------------------------------------------------------
class _EchoSampler:
    """Returns its observation: the chunked path must then return its input."""

    def __init__(self):
        self.blind_flags = []

    def predict_conditional(self, y, operator, blind=False, noise=None):
        self.blind_flags.append(blind)
        return y


@pytest.fixture(scope="module")
def plain_tester(dataset, tmp_path_factory):
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.testing.tester import Tester
    args = torch_compose(_overrides(dataset, tmp_path_factory.mktemp("plain"),
                                    "blind_dereverberation_BUDDy"))
    return Tester(args, lambda x, c: x, instantiate(args["diff_params"]), None, device="cpu")


@pytest.mark.parametrize("n,expected", [(1, 16384), (16384, 16384), (16385, 32768), (65536, 65536)])
def test_bucket_pad(plain_tester, n, expected):
    assert plain_tester._bucket_pad(n) == expected


def test_grouping_and_tail_padding(plain_tester):
    """Items group by padded length (blind) or by padded length and RIR
    bucket (informed); a tail batch runs at its own size (the JAX tester's
    repeat-padding never pads: it sizes the batch to the items left)."""
    item = lambda name, n_pad, rir_len: (None, None, np.zeros(rir_len), None, name, n_pad, n_pad,
                                         None)
    items = [item("a", 16384, 4096), item("b", 16384, 8192), item("c", 32768, 4096),
             item("d", 16384, 4096), item("e", 16384, 4096)]
    names = lambda blind, bs: [(n_pad, [it[4] for it in batch])
                               for n_pad, batch in plain_tester._group_items(items, blind, bs)]
    assert names(True, 3) == [(16384, ["a", "b", "d"]), (16384, ["e"]), (32768, ["c"])]
    assert names(False, 2) == [(16384, ["a", "d"]), (16384, ["e"]), (16384, ["b"]),
                               (32768, ["c"])]
    assert names(True, 8)[0] == (16384, ["a", "b", "d", "e"])


@pytest.mark.parametrize("n,chunks", [(1000, 1), (4096, 1), (4097, 2), (9000, 3), (20000, 6)])
def test_chunked_weights_sum_to_one(plain_tester, monkeypatch, n, chunks):
    """With a sampler that echoes its observation the overlap-add returns the
    input (1e-6): the cross-fade weights sum to one everywhere.  Blind
    estimation runs on the first chunk only."""
    plain_tester.args["tester"]["chunked"] = {"threshold": 0, "chunk_size": 4096, "overlap": 512}
    echo = _EchoSampler()
    monkeypatch.setattr(plain_tester, "sampler", echo)
    y = np.random.default_rng(n).standard_normal((1, n)).astype(np.float32)
    out = plain_tester._predict_chunked(torch.from_numpy(y), None, True, n)
    assert out.shape == (1, n) and np.abs(out - y).max() < 1e-6
    assert echo.blind_flags == [True] + [False] * (chunks - 1)


# --- do_test against the JAX tester ----------------------------------------------------
def test_do_test_unconditional(dataset, tmp_path, nets):
    """2 samples of 16384; 5e-3 of the peak (test_torch_informed)."""
    over = _overrides(dataset, tmp_path, "only_unconditional",
                      ["tester.unconditional.num_samples=2", f"tester.unconditional.audio_len={N}"])
    jt, tt = _testers(over, nets)
    draws, _ = jax_tester_draws("unconditional", 0, N, 2, 0, 0, 0, samples=2)
    tt.noise = ReplayNoise(draws)
    jt.do_test()
    preds = tt.do_test()
    assert preds.shape == (2, N)
    files = _compare_runs(jt, tt, 5e-3)
    assert files == ["unconditional/VCTK_16k_4s_time/.argv",
                     "unconditional/VCTK_16k_4s_time/unconditional_0.wav",
                     "unconditional/VCTK_16k_4s_time/unconditional_1.wav"]


@pytest.mark.parametrize("batched", [False, True])
def test_do_test_informed(dataset, tmp_path, nets, batched):
    """Informed dereverberation of both items, serial and as one batch; the
    true RIR is trimmed, peak-normalised and bucket-padded to 4096 on both
    sides.  5e-3 of the peak (test_torch_informed)."""
    over = _overrides(dataset, tmp_path, "informed_dereverberation_DPS",
                      [f"tester.batched.use={batched}", "tester.batched.batch_size=2"])
    jt, tt = _testers(over, nets)
    draws, _ = jax_tester_draws("informed_dereverberation", 2, N, 2, 0, 0, 0, batched=batched)
    tt.noise = ReplayNoise(draws)
    jt.do_test()
    tt.do_test()
    files = _compare_runs(jt, tt, 5e-3)
    base = "informed_dereverberation/VCTK_16k_4s_time/"
    assert files == sorted([base + ".argv", base + "metrics.jsonl"]
                           + [f"{base}{sub}/utt{i}.wav" for i in range(2)
                              for sub in ("original", "degraded", "reconstructed", "true_rir")])
    assert len(_read(os.path.join(tt.path_sampling, base, "reconstructed/utt1.wav"))) == LENGTHS[1]
    with open(os.path.join(tt.path_sampling, base, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 2


@pytest.mark.parametrize("batched", [False, True])
def test_do_test_blind(dataset, tmp_path, nets, batched):
    """Blind dereverberation (reverb-scaled warm init, as
    test_torch_sampler::test_blind_program_batched: the complex64 WPE differs
    between the frameworks), serial with ``reset`` per item and as one batch
    with ``reset_batched``; the estimated RIRs are written too.  1e-3 of the
    peak for the waveform and 2e-3 for the estimated RIR (the blind
    program's tolerance; the RIR passes through the final H once more)."""
    extra = ["tester.posterior_sampling.blind_hp.op_updates_per_step=2",
             "tester.posterior_sampling.warm_initialization.mode=reverb_scaled",
             f"tester.batched.use={batched}", "tester.batched.batch_size=2"]
    over = _overrides(dataset, tmp_path, "blind_dereverberation_BUDDy", extra)
    jt, tt = _testers(over, nets)
    draws, resets = jax_tester_draws("blind_dereverberation", 2, N, 2, 2, 12800 + 1024, 12800,
                                     batched=batched)
    tt.noise, tt.reset_noise = ReplayNoise(draws), ReplayNoise(resets)
    jt.do_test()
    tt.do_test()
    files = _compare_runs(jt, tt, 2e-3)
    base = "blind_dereverberation/VCTK_16k_4s_time/"
    assert len([f for f in files if f.startswith(base + "estimated_rir/")]) == 2
    for i in range(2):
        a = _read(os.path.join(tt.path_sampling, base, f"reconstructed/utt{i}.wav"))
        b = _read(os.path.join(jt.path_sampling, base, f"reconstructed/utt{i}.wav"))
        assert rel_err(a, b) < 1e-3
    assert not tt.noise.draws["eps"] and not tt.reset_noise.draws["reset"]


# --- the CLI ------------------------------------------------------------------------------
def test_cli_on_cpu(dataset, tmp_path):
    """``python -m buddy_tpu_torch.testing ... device=cpu`` with the tiny
    checkpoint the JAX package wrote: exits 0, prints the header, loads the
    checkpoint and leaves its WAV sets."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from make_torch_tiny_ckpt import OUT, TINY_CKPT_NET
    cmd = [sys.executable, "-m", "buddy_tpu_torch.testing", "--config-name=conf_VCTK.yaml",
           "tester=informed_dereverberation_DPS", *TINY_CKPT_NET, f"tester.checkpoint={OUT}",
           "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={dataset}",
           'dset.test.speakers_test=["p226"]', "dset.test.num_examples=1",
           "tester.sampling_params.T=2", "tester.overriden_name=cli", f"model_dir={tmp_path}",
           "+gpu=0", "device=cpu"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Test options:" in run.stdout and "(it=7)" in run.stdout
    base = tmp_path / "cli" / "informed_dereverberation" / "VCTK_16k_4s_time"
    for sub in ("original", "degraded", "reconstructed", "true_rir"):
        wav = _read(str(base / sub / "utt0.wav"))
        assert np.isfinite(wav).all() and len(wav) == (3000 if sub == "true_rir" else N)
    assert os.path.exists(base / ".argv")
    # with no device= and no card the CLI refuses instead of running on the CPU
    run = subprocess.run(cmd[:-1], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode != 0 and "CUDA" in run.stderr
