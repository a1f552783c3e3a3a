"""The port's spans (``buddy_tpu_torch/utils/spans.py``) on the CPU at nf=8:
off, nothing is recorded and ``span`` hands out one shared no-op; on, spans
nest with their parents and groups, and the guided sampler and the trainer
open the spans the benchmark's span readers read, as many as the program's
structure gives (Heun skips its second evaluation where t_{i+1} = 0), with
one ``noise.draw`` for each draw ``NoiseSource.draws`` counts. No JAX."""

import numpy as np
import pytest
import torch

from buddy_tpu_torch.utils import spans

N = 16384
T = 3
TINY_NET = ["network.nf=8", "network.ch_mult=[1,2]", "network.num_res_blocks=1",
            "network.image_size=256"]
INFORMED = ["tester=informed_dereverberation_DPS", *TINY_NET, f"tester.sampling_params.T={T}",
            f"exp.audio_len={N}"]
TRAIN = [*TINY_NET, "exp.batch_size=2", "exp.audio_len=4096", "exp.mesh.dp=1",
         "exp.resume=False", "logging.log=False", "logging.save_model=False"]


@pytest.fixture
def tracing():
    """Tracing on for the test, off and cleared after it."""
    spans.enable(True)
    try:
        yield
    finally:
        spans.enable(False)
        spans.take()


def _compose(overrides):
    from buddy_tpu_torch.config import compose
    return compose("conf_VCTK.yaml", list(overrides))


def _names(record) -> dict:
    out: dict = {}
    for s in record:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def _informed_batch(extra=()):
    """One informed batch (B=2, T steps, a RIR an utterance) of the port's
    DPS sampler at nf=8 on the CPU, its draws from the port's own source."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.operators.reverb import RIROperator
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    torch.manual_seed(0)
    args = _compose(INFORMED + list(extra))
    net = NetworkBundle(instantiate(args["network"], device="cpu"))
    sampler = instantiate(args["tester"]["sampler"], net, instantiate(args["diff_params"]), args,
                          device="cpu")
    op = RIROperator(args["tester"]["informed_dereverberation"]["op_hp"], time_kernel_size=1024,
                     device="cpu")
    rng = np.random.default_rng(3)
    rirs = (np.exp(-np.arange(1024) / 200.0) * rng.standard_normal((2, 1024))).astype(np.float32)
    rirs[:, 0] = 1.0
    ys = torch.from_numpy(rng.standard_normal((2, 1, N)).astype(np.float32) * 0.05)
    noise = NoiseSource(torch.Generator().manual_seed(5))
    out = sampler.predict_conditional_batched(ys, op, blind=False, noise=noise,
                                              H_batch=torch.from_numpy(rirs))
    assert out.shape == (2, 1, N) and torch.isfinite(out).all()


def test_off_records_nothing_and_shares_one_noop():
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    spans.enable(False)
    spans.take()
    assert spans.span("dps.step") is spans.span("noise.draw")
    before = NoiseSource.draws
    with spans.span("dps.batch"):
        NoiseSource(torch.Generator().manual_seed(1)).normal("init", (2, 8), "cpu")
    assert spans.take() == []
    assert NoiseSource.draws == before + 1          # the counter counts on or off


def test_spans_nest_with_parent_and_group(tracing):
    with spans.span("a", group=7):
        with spans.span("b"):
            with spans.span("c"):
                pass
        with spans.span("d", group=99):     # a child keeps its root's group
            pass
    with spans.span("e"):                    # a root without a group: the count of roots
        pass
    with spans.span("f"):
        pass
    rec = spans.take()
    by = {s["name"]: s for s in rec}
    assert [s["name"] for s in rec] == ["a", "b", "c", "d", "e", "f"]
    assert by["a"]["parent"] is None and by["e"]["parent"] is None
    assert by["b"]["parent"] == by["a"]["id"] and by["d"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert {by[k]["group"] for k in "abcd"} == {7}
    assert by["f"]["group"] == by["e"]["group"] + 1
    assert len({s["id"] for s in rec}) == 6
    for s in rec:
        assert 0 < s["t0_ns"] <= s["t1_ns"]
    assert by["a"]["t0_ns"] <= by["b"]["t0_ns"] and by["c"]["t1_ns"] <= by["b"]["t1_ns"]
    assert spans.take() == []                # take clears the record


def test_take_gives_no_device_extents_on_the_cpu(tracing):
    assert not torch.cuda.is_available()
    with spans.span("a"):
        torch.ones(4).sum()
    (s,) = spans.take()
    assert s["d0_ms"] is None and s["d1_ms"] is None


def test_spans_reach_the_profiler_trace(tracing):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("dps.denoise"):
            torch.ones(4).sum()
    assert "dps.denoise" in {e.name for e in prof.events()}


def test_informed_full_guidance_batch(tracing):
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    before = NoiseSource.draws
    _informed_batch()
    rec = spans.take()
    draws = NoiseSource.draws - before
    assert _names(rec) == {"dps.batch": 1, "dps.step": T, "dps.denoise": 2 * T - 1,
                           "dps.vjp": 2 * T - 1, "noise.draw": 1 + T}
    assert draws == 1 + T
    (root,) = [s for s in rec if s["name"] == "dps.batch"]
    assert root["parent"] is None
    assert {s["group"] for s in rec} == {root["group"]}
    by_id = {s["id"]: s for s in rec}
    for s in rec:
        if s["name"] in ("dps.denoise", "dps.vjp"):
            assert by_id[s["parent"]]["name"] == "dps.step"
        elif s["name"] == "dps.step":
            assert s["parent"] == root["id"]
    # the initial draw lies in the batch, each churn draw in its step
    parents = [by_id[s["parent"]]["name"] for s in rec if s["name"] == "noise.draw"]
    assert parents == ["dps.batch"] + ["dps.step"] * T


def test_identity_guidance_has_no_vjp(tracing):
    _informed_batch(["tester.posterior_sampling.guidance_jacobian=identity"])
    names = _names(spans.take())
    assert "dps.vjp" not in names
    assert names["dps.denoise"] == 2 * T - 1 and names["dps.step"] == T


def test_train_step(tracing, tmp_path):
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import NetworkBundle

    class Loader:
        def next_batch(self):
            return np.full((2, 4096), 0.1, np.float32)

    torch.manual_seed(0)
    args = _compose(TRAIN + [f"model_dir={tmp_path}"])
    args["exp"]["model_dir"] = args["model_dir"]
    trainer = instantiate(args["exp"]["trainer"], args, Loader(),
                          NetworkBundle(instantiate(args["network"], device="cpu")),
                          instantiate(args["diff_params"]), None, device="cpu")
    spans.take()
    trainer.it = 5
    trainer.train_step()
    rec = spans.take()
    assert _names(rec) == {"train.step": 1, "train.get_batch": 1, "noise.draw": 2}
    (root,) = [s for s in rec if s["name"] == "train.step"]
    assert root["parent"] is None and {s["group"] for s in rec} == {5}
    assert all(s["parent"] == root["id"] for s in rec if s is not root)
