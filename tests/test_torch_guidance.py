"""Identity-Jacobian guidance (``tester.posterior_sampling.guidance_jacobian
=identity``, the fast serving profile) in the port against the JAX package
on the CPU: the blind program and informed DPS with a batched RIR
operator, JAX's draws replayed (dps.py:357 split, :277 k_init, :224 k_eps,
:150 k_reg) and the TINY_NET parameters shared through ``from_jax_params``;
then the port alone: with a linear-diagonal denoiser identity equals full
guidance (``tests/test_samplers.py::test_identity_guidance_equals_full_for_
linear_denoiser``), and on TINY_NET the two modes differ.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (BLIND_SMALL, REPO, TINY_NET, ReplayNoise, jax_compose,
                               jax_program_draws, jax_tiny_bundle, op_hp, rel_err,
                               to_torch as _t, torch_compose, torch_tiny_bundle)

N = 16384
IDENTITY = ["tester.posterior_sampling.guidance_jacobian=identity"]
INFORMED = ["tester=informed_dereverberation_DPS", *TINY_NET, "tester.sampling_params.T=2"]


@pytest.fixture(scope="module")
def nets():
    jnet, tree = jax_tiny_bundle(N, seed=21)
    return jnet, torch_tiny_bundle(tree)


def _samplers(overrides, nets):
    from buddy_tpu.config import instantiate as jinst
    from buddy_tpu_torch.config import instantiate as tinst
    jargs, targs = jax_compose(overrides), torch_compose(overrides)
    js = jinst(jargs["tester"]["sampler"], nets[0], jinst(jargs["diff_params"]), jargs)
    ts = tinst(targs["tester"]["sampler"], nets[1], tinst(targs["diff_params"]), targs,
               device="cpu")
    return js, ts, jargs, targs


@pytest.fixture(scope="module")
def blind(nets):
    """The blind program at test size (B=2, 16384 samples, T=2, 2 operator
    updates a step) with identity guidance in both packages, the port's
    warm init handed JAX's WPE output (the complex64 WPE solves differ by
    ~0.5% of the peak between the two: tests/test_torch_sampler.py); and the
    port's full-guidance program on the same draws and WPE output."""
    import buddy_tpu_torch.sampling.wpe as twpe
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu.sampling.wpe import wpe_dereverb as jwpe
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    js, ts, jargs, targs = _samplers(BLIND_SMALL + IDENTITY, nets)
    assert js.guidance_jacobian == ts.guidance_jacobian == "identity"
    _, ts_full, _, _ = _samplers(BLIND_SMALL, nets)
    assert ts_full.guidance_jacobian == "full"
    jop = JBlind(op_hp(jargs), sample_rate=16000)
    params, H = jop.reset_batched(jax.random.PRNGKey(1), 2)
    params = {k: np.asarray(v) for k, v in params.items()}
    H = np.asarray(H)
    ys = np.stack([read_wav(os.path.join(REPO, "quality_out_heldout",
                                         f"degraded_utt{i}.wav"))[0][:N] for i in range(2)])
    ys = ys[:, None].astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(js.predict_conditional_batched(
        jnp.asarray(ys), jop, blind=True, rng=key,
        op_params_batch={k: jnp.asarray(v) for k, v in params.items()}, H_batch=jnp.asarray(H)))
    wpe_ref = np.asarray(jax.vmap(lambda y: jwpe(y, taps=10, delay=2, iterations=5))(
        jnp.asarray(ys)))[:, 0]
    out, H_out = {}, {}
    saved = twpe.wpe_dereverb
    twpe.wpe_dereverb = lambda y, **kw: torch.tensor(wpe_ref)
    try:
        for mode, sampler in (("identity", ts), ("full", ts_full)):
            top = BlindSubbandFiltering(op_hp(targs), sample_rate=16000, device="cpu")
            draws = jax_program_draws(key, 2, N, sampler.T, 2, top.length_rir + 1024, reg=True)
            out[mode] = sampler.predict_conditional_batched(
                torch.from_numpy(ys), top, blind=True, noise=ReplayNoise(draws),
                op_params_batch=_t(params), H_batch=torch.tensor(H)).numpy()
            H_out[mode] = top.H.numpy()
    finally:
        twpe.wpe_dereverb = saved
    return dict(ref=ref, H_ref=np.asarray(jop.H), out=out, H=H_out)


def test_blind_identity_program_against_jax(blind):
    """The whole blind program under identity guidance, B=2: the final x_den
    (B, 1, N) and the final H within 1e-3 of the peak, the tolerance of the
    full-guidance program (tests/test_torch_sampler.py): the Adam steps
    amplify gradient rounding where the second moment is tiny."""
    out, ref = blind["out"]["identity"], blind["ref"]
    assert out.shape == ref.shape == (2, 1, N)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) < 1e-3
    assert rel_err(blind["H"]["identity"], blind["H_ref"]) < 1e-3


def test_identity_and_full_differ_on_tiny_net(blind):
    """On TINY_NET (a nonlinear denoiser) the two modes, with the same
    draws, weights and warm init, end more than 1% of the peak apart, a
    hundred times the identity program's tolerance against JAX: the switch
    acts."""
    out = blind["out"]
    assert np.isfinite(out["full"]).all()
    assert rel_err(out["identity"], out["full"]) > 1e-2
    assert rel_err(blind["H"]["identity"], blind["H"]["full"]) > 1e-3


def test_informed_identity_rir_batched(nets):
    """Informed DPS under identity guidance with a ``RIROperator`` and one
    RIR per utterance (B=2, T=2, second-order steps) against the JAX
    package, within 5e-3 of the peak as with full guidance
    (tests/test_torch_informed.py): the Heun correction at t = 1e-4 scales
    the U-Net's float32 rounding by ~2500."""
    from buddy_tpu.operators.reverb import RIROperator as JRIR
    from buddy_tpu_torch.operators.reverb import RIROperator
    js, ts, jargs, targs = _samplers(INFORMED + IDENTITY, nets)
    assert js.guidance_jacobian == ts.guidance_jacobian == "identity"
    rng = np.random.default_rng(3)
    rirs = (np.exp(-np.arange(4096) / 500.0) * rng.standard_normal((2, 4096))).astype(np.float32)
    rirs[:, 0] = 1.0
    x = np.random.default_rng(4).standard_normal((2, N)).astype(np.float32) * 0.05
    jop = JRIR(op_hp(jargs), time_kernel_size=4096)
    top = RIROperator(op_hp(targs), time_kernel_size=4096, device="cpu")
    ys = np.stack([np.asarray(jop.degradation(jnp.asarray(x[b:b + 1]), filt=jnp.asarray(rirs[b])))
                   for b in range(2)])                                   # (2, 1, N)
    key = jax.random.PRNGKey(8)
    ref = np.asarray(js.predict_conditional_batched(jnp.asarray(ys), jop, blind=False, rng=key,
                                                    H_batch=jnp.asarray(rirs)))
    out = ts.predict_conditional_batched(
        torch.from_numpy(ys), top, blind=False,
        noise=ReplayNoise(jax_program_draws(key, 2, N, ts.T, 0, 0, reg=False)),
        H_batch=torch.from_numpy(rirs))
    assert out.shape == ref.shape == (2, 1, N)
    assert torch.isfinite(out).all()
    assert rel_err(out.numpy(), ref) < 5e-3


def test_identity_equals_full_for_linear_denoiser():
    """With a linear-diagonal denoiser s^2 / (s^2 + t^2) x the full guidance
    is the operator-side gradient times a positive scalar per utterance,
    which the zeta normalisation divides out: the two modes agree within
    1e-5 (informed, RIR operator, T=5, first order, no churn, the same
    draws), on a sample that the guidance moved (against zeta = 0)."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.operators.reverb import RIROperator
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    rng = np.random.default_rng(0)
    rir = (rng.standard_normal(1000) * np.exp(-np.arange(1000) / 150)).astype(np.float32)
    rir[0] = 1.0
    x_clean = torch.from_numpy(rng.standard_normal((1, 4096)).astype(np.float32) * 0.05)
    x_init = torch.from_numpy(rng.standard_normal((1, 4096)).astype(np.float32))
    s = 0.05
    outs = {}
    for label, mode, zeta in (("full", "full", None), ("identity", "identity", None),
                              ("unguided", "full", 0)):
        args = torch_compose(["tester=informed_dereverberation_DPS", "exp.audio_len=4096",
                              "tester.sampling_params.T=5", "tester.sampling_params.order=1",
                              "tester.sampling_params.Schurn=0",
                              f"tester.posterior_sampling.guidance_jacobian={mode}"]
                             + ([] if zeta is None else [f"tester.posterior_sampling.zeta={zeta}"]))
        sampler = instantiate(args["tester"]["sampler"], None, instantiate(args["diff_params"]),
                              args, device="cpu")
        sampler._denoise = lambda x, t: s ** 2 / (s ** 2 + t ** 2) * x
        sampler.initialize_x = lambda y, t0, noise: x_init.clone()
        op = RIROperator(op_hp(args), time_kernel_size=1000, device="cpu")
        op.update_params(rir)
        y = op.degradation(x_clean)
        outs[label] = sampler.predict_conditional(
            y, op, blind=False, noise=NoiseSource(torch.Generator().manual_seed(0))).numpy()
    assert np.isfinite(outs["identity"]).all()
    np.testing.assert_allclose(outs["identity"], outs["full"], atol=1e-5, rtol=1e-5)
    # the guidance acts (zeta = 0 leaves the unguided sampler): the two
    # modes agree on a guided sample
    assert rel_err(outs["full"], outs["unguided"]) > 1e-2
