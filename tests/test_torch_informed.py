"""Parity of the port's informed path with the JAX package on the CPU: FFT
convolution, the RIR operator, informed DPS with a time-domain RIR (batched
with per-utterance RIRs, and the serial B = 1 entry point), and the
unconditional Euler-Heun sampler.  Seeded numpy inputs go through both; the
TINY_NET parameters are shared through ``from_jax_params`` and JAX's random
draws are replayed into the port's sampler.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (ReplayNoise, TINY_NET, jax_compose, jax_program_draws,
                               jax_tiny_bundle, jax_unconditional_draws, op_hp, rel_err,
                               torch_compose, torch_tiny_bundle)

N = 16384
INFORMED = ["tester=informed_dereverberation_DPS", *TINY_NET, "tester.sampling_params.T=2"]
UNCOND = ["tester=only_unconditional", *TINY_NET, "tester.sampling_params.T=3"]


def _rirs(seed: int, count: int, length: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rir = np.exp(-np.arange(length) / 500.0) * rng.standard_normal((count, length))
    rir[:, 0] = 1.0
    return rir.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    jnet, tree = jax_tiny_bundle(N, seed=33)
    return jnet, torch_tiny_bundle(tree)


def _samplers(overrides, nets):
    from buddy_tpu.config import instantiate as jinst
    from buddy_tpu_torch.config import instantiate as tinst
    jargs, targs = jax_compose(overrides), torch_compose(overrides)
    js = jinst(jargs["tester"]["sampler"], nets[0], jinst(jargs["diff_params"]), jargs)
    ts = tinst(targs["tester"]["sampler"], nets[1], tinst(targs["diff_params"]), targs,
               device="cpu")
    return js, ts, jargs, targs


@pytest.mark.parametrize("n,m", [(1000, 300), (4096, 4096), (777, 50)])
def test_fft_convolve(n, m):
    """Against the JAX package and against numpy's direct convolution (1e-5
    of the peak: float32 FFTs of a few thousand points)."""
    from buddy_tpu.ops.fftconv import fft_convolve as jconv
    from buddy_tpu_torch.ops.fftconv import fft_convolve
    rng = np.random.default_rng(n)
    y = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal(m).astype(np.float32)
    out = fft_convolve(torch.from_numpy(y), torch.from_numpy(h)).numpy()
    assert out.shape == (2, n)
    assert rel_err(out, np.asarray(jconv(jnp.asarray(y), jnp.asarray(h)))) < 1e-5
    assert rel_err(out[0], np.convolve(y[0].astype(np.float64), h.astype(np.float64))[:n]) < 1e-5


def test_fast_apply_rir_rm_delay_and_batched_filters():
    """``rm_delay`` trims the RIR at its argmax as the JAX package does; a
    (B, M) filter applies one RIR per utterance (1e-5 of the peak)."""
    from buddy_tpu.ops.fftconv import fast_apply_rir as japply
    from buddy_tpu_torch.ops.fftconv import fast_apply_rir
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 2000)).astype(np.float32)
    rirs = _rirs(6, 2, 400)
    delayed = np.concatenate([0.01 * rng.standard_normal(37).astype(np.float32), rirs[0]])
    for rm in (False, True):
        out = fast_apply_rir(torch.from_numpy(y), torch.from_numpy(delayed), rm_delay=rm).numpy()
        assert rel_err(out, np.asarray(japply(jnp.asarray(y), jnp.asarray(delayed),
                                              rm_delay=rm))) < 1e-5
    per = fast_apply_rir(torch.from_numpy(y), torch.from_numpy(rirs)).numpy()
    for b in range(2):
        assert rel_err(per[b], np.asarray(japply(jnp.asarray(y[b]), jnp.asarray(rirs[b])))) < 1e-5
    with pytest.raises(ValueError):
        fast_apply_rir(torch.from_numpy(y), torch.from_numpy(rirs), rm_delay=True)


def test_rir_operator():
    """degradation (stored RIR and ``filt=``), its gradient w.r.t. the signal
    against ``jax.grad``, and the STFT helpers (1e-5 of the peak)."""
    from buddy_tpu.operators.reverb import RIROperator as JRIR
    from buddy_tpu_torch.operators.reverb import RIROperator
    hp = op_hp(jax_compose(INFORMED))
    jop, top = JRIR(hp, time_kernel_size=3000), RIROperator(op_hp(torch_compose(INFORMED)),
                                                            time_kernel_size=3000, device="cpu")
    rir = _rirs(1, 1)[0]
    x = np.random.default_rng(2).standard_normal((1, 8192)).astype(np.float32)
    with pytest.raises(ValueError):
        top.degradation(torch.from_numpy(x))
    jop.update_params(jnp.asarray(rir))
    top.update_params(rir)
    assert top.get_time_RIR().shape == (3000,)
    ref = np.asarray(jop.degradation(jnp.asarray(x)))
    assert rel_err(top.degradation(torch.from_numpy(x)).numpy(), ref) < 1e-5
    assert rel_err(top.degradation(torch.from_numpy(x), filt=torch.from_numpy(2 * rir)).numpy(),
                   2 * ref) < 1e-5
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((top.degradation(xt) ** 2).sum(), xt)
    jg = jax.grad(lambda v: jnp.sum(jop.degradation(v) ** 2))(jnp.asarray(x))
    assert rel_err(g.numpy(), np.asarray(jg)) < 1e-5
    assert rel_err(top.apply_stft(torch.from_numpy(x)).numpy(),
                   np.asarray(jop.apply_stft(jnp.asarray(x)))) < 1e-5


def test_informed_dps_time_domain_rir_batched(nets):
    """``predict_conditional_batched`` with a ``RIROperator`` and one RIR per
    utterance (B = 2, T = 2, second-order steps), and with the operator's one
    shared RIR.  Tolerance 5e-3 of the peak, as for the informed subband
    program: the Heun correction at t = 1e-4 scales the U-Net's float32
    rounding by ~2500."""
    from buddy_tpu.operators.reverb import RIROperator as JRIR
    from buddy_tpu_torch.operators.reverb import RIROperator
    js, ts, jargs, targs = _samplers(INFORMED, nets)
    rirs = _rirs(3, 2, 4096)
    x = np.random.default_rng(4).standard_normal((2, N)).astype(np.float32) * 0.05
    jop = JRIR(op_hp(jargs), time_kernel_size=4096)
    top = RIROperator(op_hp(targs), time_kernel_size=4096, device="cpu")
    ys = np.stack([np.asarray(jop.degradation(jnp.asarray(x[b:b + 1]), filt=jnp.asarray(rirs[b])))
                   for b in range(2)])                                   # (2, 1, N)
    key = jax.random.PRNGKey(8)
    draws = lambda: ReplayNoise(jax_program_draws(key, 2, N, ts.T, 0, 0, reg=False))
    ref = np.asarray(js.predict_conditional_batched(jnp.asarray(ys), jop, blind=False, rng=key,
                                                    H_batch=jnp.asarray(rirs)))
    out = ts.predict_conditional_batched(torch.from_numpy(ys), top, blind=False, noise=draws(),
                                         H_batch=torch.from_numpy(rirs))
    assert out.shape == ref.shape == (2, 1, N)
    assert rel_err(out.numpy(), ref) < 5e-3
    jop.update_params(jnp.asarray(rirs[0]))
    top.update_params(rirs[0])
    ref = np.asarray(js.predict_conditional_batched(jnp.asarray(ys), jop, blind=False, rng=key))
    out = ts.predict_conditional_batched(torch.from_numpy(ys), top, blind=False, noise=draws())
    assert rel_err(out.numpy(), ref) < 5e-3


def test_informed_dps_serial_entry_point(nets):
    """``predict_conditional`` (one utterance, the operator's stored RIR)
    against the JAX package's serial entry point; 5e-3 of the peak."""
    from buddy_tpu.operators.reverb import RIROperator as JRIR
    from buddy_tpu_torch.operators.reverb import RIROperator
    js, ts, jargs, targs = _samplers(INFORMED, nets)
    rir = _rirs(9, 1, 4096)[0]
    jop = JRIR(op_hp(jargs), time_kernel_size=4096)
    top = RIROperator(op_hp(targs), time_kernel_size=4096, device="cpu")
    jop.update_params(jnp.asarray(rir))
    top.update_params(rir)
    x = np.random.default_rng(10).standard_normal((1, N)).astype(np.float32) * 0.05
    y = np.asarray(jop.degradation(jnp.asarray(x)))
    key = jax.random.PRNGKey(12)
    ref = np.asarray(js.predict_conditional(jnp.asarray(y), jop, shape=(1, N), blind=False, rng=key))
    noise = ReplayNoise(jax_program_draws(key, 1, N, ts.T, 0, 0, reg=False, split=False))
    out = ts.predict_conditional(torch.from_numpy(y), top, blind=False, noise=noise)
    assert out.shape == ref.shape == (1, N)
    assert rel_err(out.numpy(), ref) < 5e-3


@pytest.mark.parametrize("order", [1, 2])
def test_unconditional_sampler(nets, order):
    """``predict_unconditional`` for 2 samples, T = 3, with JAX's draws
    replayed: the final x (not x_den); 5e-3 of the peak (the last Heun
    correction at sigma_min divides float32 rounding by a tiny t)."""
    over = UNCOND + [f"tester.sampling_params.order={order}"]
    js, ts, _, _ = _samplers(over, nets)
    key = jax.random.PRNGKey(order)
    ref = np.asarray(js.predict_unconditional((2, N), rng=key))
    out = ts.predict_unconditional((2, N), noise=ReplayNoise(
        jax_unconditional_draws(key, (2, N), ts.T)))
    assert out.shape == ref.shape == (2, N) and torch.isfinite(out).all()
    assert rel_err(out.numpy(), ref) < 5e-3


def test_no_sampler_and_dps_refuses_unconditional(nets):
    from buddy_tpu_torch.sampling.euler_heun import NoSampler
    _, ts, _, targs = _samplers(INFORMED, nets)
    with pytest.raises(ValueError):
        ts.predict_unconditional((1, N))
    stub = NoSampler(nets[1], ts.diff_params, targs, device="cpu")
    assert stub.predict((1, N)) is None and stub.predict_conditional() is None
