"""Parity of the port's blind DPS sampler with the JAX package on the CPU:
one blind step, and the whole blind program at test size (B=2, 16384
samples, T=2, 2 operator updates per step, WPE taps=10 —
tests/test_batched.py:28-40).  The TINY_NET parameters are shared through
``from_jax_params``; JAX's random draws (dps.py:357 split, :277 k_init,
:224 k_eps, :150 k_reg) are replayed into the port's sampler.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (BLIND_SMALL, REPO, ReplayNoise, jax_compose, jax_program_draws,
                               jax_step_draws, jax_tiny_bundle, op_hp, rel_err, to_torch as _t,
                               torch_compose, torch_tiny_bundle, TINY_NET)

N = 16384


@pytest.fixture(scope="module")
def setup():
    from buddy_tpu.config import instantiate as jinst
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu_torch.config import instantiate as tinst
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    jargs, targs = jax_compose(BLIND_SMALL), torch_compose(BLIND_SMALL)
    jnet, tree = jax_tiny_bundle(N, seed=21)
    jedm = jinst(jargs["diff_params"])
    jsampler = jinst(jargs["tester"]["sampler"], jnet, jedm, jargs)
    tsampler = tinst(targs["tester"]["sampler"], torch_tiny_bundle(tree),
                     tinst(targs["diff_params"]), targs, device="cpu")
    jop = JBlind(op_hp(jargs), sample_rate=16000)
    top = BlindSubbandFiltering(op_hp(targs), sample_rate=16000, device="cpu")
    params, H = jop.reset_batched(jax.random.PRNGKey(1), 2)
    ys = np.stack([read_wav(os.path.join(REPO, "quality_out_heldout",
                                         f"degraded_utt{i}.wav"))[0][:N] for i in range(2)])
    return dict(jsampler=jsampler, tsampler=tsampler, jop=jop, top=top, jnet=jnet,
                params={k: np.asarray(v) for k, v in params.items()}, H=np.asarray(H),
                ys=ys[:, None].astype(np.float32))


def test_edm_and_schedule():
    """EDM preconditioning and the denoiser with a linear mock network, the
    T+1-point schedule (t[T] = 0) and the churn, against the JAX package
    (1e-6 relative: float32 scalar arithmetic)."""
    from buddy_tpu.diffusion.edm import EDM as JEDM
    from buddy_tpu.sampling.schedule import create_schedule as jsched, get_gamma as jgamma
    from buddy_tpu_torch.diffusion.edm import EDM
    from buddy_tpu_torch.sampling.schedule import create_schedule, get_gamma
    hp = {"sigma_data": 0.05, "sigma_min": 1e-4, "sigma_max": 0.5, "rho": 10}
    jedm, tedm = JEDM(sde_hp=hp), EDM(sde_hp=hp)
    sig = np.asarray([1e-4, 0.01, 0.5], np.float32)
    for name in ("cskip", "cout", "cin", "cnoise"):
        np.testing.assert_allclose(getattr(tedm, name)(torch.from_numpy(sig)).numpy(),
                                   np.asarray(getattr(jedm, name)(jnp.asarray(sig))), rtol=1e-6)
    x = np.random.default_rng(1).standard_normal((3, 1, 64)).astype(np.float32)
    net = lambda v, c: 0.3 * v + c.reshape(-1, 1, 1)
    np.testing.assert_allclose(
        tedm.denoiser(torch.from_numpy(x), net, torch.from_numpy(sig)).numpy(),
        np.asarray(jedm.denoiser(jnp.asarray(x), net, jnp.asarray(sig))), rtol=1e-6, atol=1e-7)
    for T in (2, 5, 201):
        t = create_schedule(T, sigma_min=1e-4, sigma_max=0.5, rho=10)
        np.testing.assert_allclose(t, np.asarray(jsched(T, sigma_min=1e-4, sigma_max=0.5, rho=10)),
                                   rtol=1e-6)
        assert t[-1] == 0 and len(t) == T + 1
        np.testing.assert_array_equal(get_gamma(t, Schurn=50, Stmin=0, Stmax=10),
                                      np.asarray(jgamma(jnp.asarray(t), Schurn=50, Stmin=0,
                                                        Stmax=10)))


def test_blind_step(setup):
    """One blind step of utterance 0 (churn noise, 2 Adam updates of the
    operator with the RIR-noise regulariser, full guidance through the
    U-Net, speech-magnitude constraint, Euler update).  Tolerance 1e-3 of
    the largest value: the step chains the float32 U-Net vjp, cons and the
    zeta-normalised guidance, and the Adam steps amplify gradient rounding
    (a step of lr*sign where the second moment is tiny)."""
    js, ts, jop, top = setup["jsampler"], setup["tsampler"], setup["jop"], setup["top"]
    y = setup["ys"][0]                                       # (1, N)
    x0 = np.random.default_rng(9).standard_normal((1, N)).astype(np.float32) * 0.3
    params = {k: v[0] for k, v in setup["params"].items()}
    H = setup["H"][0]
    t = js.create_schedule()
    gamma = js.get_gamma(t)
    key = jax.random.PRNGKey(5)
    n_up = 2

    js._build_losses(jop, blind=True)
    js.y = jnp.asarray(y)
    opt = js._make_opt()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    step = jax.jit(partial(js._scan_step, jop, opt, True, net_params=setup["jnet"].params))
    (xj, _, pj, _, Hj), xdj = step((jnp.asarray(x0), key, jp, opt.init(jp), jnp.asarray(H)),
                                   (t[0], t[1], gamma[0]))

    _, eps, regs = jax_step_draws(key, n_up, (1, N), jop.length_rir + 1024, reg=True)
    noise = ReplayNoise({"eps": [eps], "reg": [r[None] for r in regs]})
    ts._build_losses(top, blind=True)
    ts._prepare_observation(top, torch.from_numpy(y))
    tp = _t({k: v[None] for k, v in params.items()})
    zeros = {k: torch.zeros_like(v) for k, v in tp.items()}
    (xt, pt, _, Ht), xdt = ts._scan_step(
        top, True, (torch.from_numpy(x0), tp, (0, zeros, dict(zeros)), torch.tensor(H[None])),
        float(t[0]), float(t[1]), float(gamma[0]), noise)

    assert rel_err(xdt[0].numpy(), np.asarray(xdj)[0]) < 1e-3
    assert rel_err(xt[0].numpy(), np.asarray(xj)[0]) < 1e-3
    assert rel_err(Ht[0].numpy(), np.asarray(Hj)) < 1e-3
    for k in ("decay", "weights"):
        assert rel_err(pt[k][0].numpy(), np.asarray(pj[k])) < 1e-3, k


def test_blind_program_batched(setup, monkeypatch):
    """The whole blind program, predict_conditional_batched with B=2: warm
    init, 2 steps, the final x_den (B, 1, N) and the final operator state.
    The complex64 WPE solves are ill-conditioned (the two frameworks differ
    by ~0.5% of the peak, test_torch_operators), so the port's warm init is
    handed JAX's WPE output here; tolerance 1e-3 of the largest value, as
    for one step.  Unpatched, the port's own WPE moves the result by 0.7%
    of the peak (measured); that check allows 2e-2, the WPE golden's
    tolerance, since reduction order alone moves complex64 WPE by ~1.6%
    (tests/make_wpe_golden.py)."""
    import buddy_tpu_torch.sampling.wpe as twpe
    from buddy_tpu.sampling.wpe import wpe_dereverb as jwpe
    js, ts, jop, top = setup["jsampler"], setup["tsampler"], setup["jop"], setup["top"]
    ys = setup["ys"]
    key = jax.random.PRNGKey(2)
    ref = np.asarray(js.predict_conditional_batched(
        jnp.asarray(ys), jop, blind=True, rng=key,
        op_params_batch={k: jnp.asarray(v) for k, v in setup["params"].items()},
        H_batch=jnp.asarray(setup["H"])))
    H_ref = np.asarray(jop.H)
    wpe_ref = np.asarray(jax.vmap(lambda y: jwpe(y, taps=10, delay=2, iterations=5))(
        jnp.asarray(ys)))[:, 0]

    def run():
        draws = jax_program_draws(key, 2, N, ts.T, 2, top.length_rir + 1024, reg=True)
        return ts.predict_conditional_batched(
            torch.from_numpy(ys), top, blind=True, noise=ReplayNoise(draws),
            op_params_batch=_t(setup["params"]), H_batch=torch.tensor(setup["H"]))

    out = run()
    assert out.shape == ref.shape == (2, 1, N)
    assert torch.isfinite(out).all()
    assert rel_err(out.numpy(), ref) < 2e-2
    monkeypatch.setattr(twpe, "wpe_dereverb", lambda y, **kw: torch.from_numpy(wpe_ref))
    out = run()
    assert rel_err(out.numpy(), ref) < 1e-3
    assert rel_err(top.H.numpy(), H_ref) < 1e-3


def test_informed_program_order2(setup):
    """The informed program (known subband filter from a seeded RIR), with
    the informed tester config: second-order steps (skipped where
    t_{i+1} == 0), reverb-scaled warm init, B=2, T=2.  Tolerance 5e-3 of the
    largest value (measured 1.3e-3): with T=2 the Heun correction runs at
    t=1e-4, where (x - x_den)/t scales the U-Net's float32 rounding by
    |dt|/(2t) ~ 2500 before it reaches the output."""
    from buddy_tpu.config import instantiate as jinst
    from buddy_tpu.operators.subband import SubbandFiltering as JSub
    from buddy_tpu_torch.config import instantiate as tinst
    from buddy_tpu_torch.operators.subband import SubbandFiltering
    over = ["tester=informed_dereverberation_DPS", *TINY_NET, "tester.sampling_params.T=2"]
    jargs, targs = jax_compose(over), torch_compose(over)
    assert int(jargs["tester"]["sampling_params"]["order"]) == 2
    # the subband geometry of the blind config (the informed tester's own
    # op_hp describes its RIR operator)
    jop = JSub(op_hp(jax_compose(BLIND_SMALL)), sample_rate=16000)
    top = SubbandFiltering(op_hp(torch_compose(BLIND_SMALL)), sample_rate=16000, device="cpu")
    rng = np.random.default_rng(11)
    rirs = (np.exp(-np.arange(4000) / 600) * rng.standard_normal((2, 4000))).astype(np.float32)
    H = np.stack([np.asarray(jop.rir_to_H(jnp.asarray(r))) for r in rirs])
    js = jinst(jargs["tester"]["sampler"], setup["jnet"], jinst(jargs["diff_params"]), jargs)
    ts = tinst(targs["tester"]["sampler"], setup["tsampler"].model,
               tinst(targs["diff_params"]), targs, device="cpu")
    ys = setup["ys"]
    key = jax.random.PRNGKey(3)
    ref = np.asarray(js.predict_conditional_batched(jnp.asarray(ys), jop, blind=False, rng=key,
                                                    H_batch=jnp.asarray(H)))
    draws = jax_program_draws(key, 2, N, ts.T, 0, 0, reg=False)
    out = ts.predict_conditional_batched(torch.from_numpy(ys), top, blind=False,
                                         noise=ReplayNoise(draws), H_batch=torch.tensor(H))
    assert out.shape == ref.shape == (2, 1, N)
    assert rel_err(out.numpy(), ref) < 5e-3
