"""Parity of the port's blind subband operator, loss and WPE with the JAX
package at the production operator geometry (NFFT 1024, hann 512, hop 128,
Nf 100), on the CPU.  JAX's ``reset_batched`` state is fed to both sides.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import (BLIND_SMALL, jax_compose, op_hp, rel_err, to_torch as _t,
                               torch_compose)

N = 16384
B = 2


@pytest.fixture(scope="module")
def ops():
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    jop = JBlind(op_hp(jax_compose(BLIND_SMALL)), sample_rate=16000)
    top = BlindSubbandFiltering(op_hp(torch_compose(BLIND_SMALL)), sample_rate=16000,
                                device="cpu")
    key = jax.random.PRNGKey(1)
    params, H = jop.reset_batched(key, B)
    params = {k: np.asarray(v) for k, v in params.items()}
    noise = np.stack([np.asarray(jax.random.normal(k, (jop.length_rir,)))
                      for k in jax.random.split(key, B)])
    return jop, top, params, np.asarray(H), noise


def test_reset_batched_and_compute_H(ops):
    """reset_batched with JAX's phase noise injected, and compute_H of JAX's
    reset state.  Tolerance 1e-4 of the largest |H|: the cons projection runs
    an ISTFT, a 25856-point minimum-phase chain (log, exp) and an STFT in
    float32 on both sides."""
    jop, top, params, H, noise = ops
    p_ours, H_ours = top.reset_batched(B, noise=torch.from_numpy(noise))
    assert rel_err(H_ours.numpy(), H) < 1e-4
    np.testing.assert_allclose(p_ours["decay"].numpy(), params["decay"], rtol=1e-6)
    np.testing.assert_allclose(p_ours["weights"].numpy(), params["weights"], rtol=1e-6)
    ref = np.asarray(jax.jit(jax.vmap(jop.compute_H))(
        {k: jnp.asarray(v) for k, v in params.items()}))
    assert rel_err(top.compute_H(_t(params)).numpy(), ref) < 1e-4


def test_degradation_and_time_rir(ops):
    """degradation of a waveform batch and get_time_RIR through H
    (1e-5 of the largest value: STFT -> subband conv -> ISTFT in float32)."""
    jop, top, params, H, _ = ops
    x = np.random.default_rng(3).standard_normal((B, N)).astype(np.float32) * 0.05
    ref = np.asarray(jax.jit(jax.vmap(lambda xx, hh: jop.degradation(xx, H=hh)))(
        jnp.asarray(x), jnp.asarray(H)))
    ours = top.degradation(torch.from_numpy(x), H=torch.from_numpy(H))
    assert ours.shape == ref.shape == (B, N)
    assert rel_err(ours.numpy(), ref) < 1e-5
    rir_ref = np.asarray(jax.jit(jax.vmap(jop.get_time_RIR))(jnp.asarray(H)))
    rir = top.get_time_RIR(torch.from_numpy(H))
    assert rir.shape == rir_ref.shape
    assert rel_err(rir.numpy(), rir_ref) < 1e-5


@pytest.mark.parametrize("strictly_decreasing", [False, True])
def test_project(ops, strictly_decreasing, monkeypatch):
    """The clamps of project on parameters pushed out of range, with the
    config's plain clamps and with strictly decreasing decays (exact up to
    float32 rounding of the bounds)."""
    jop, top, params, _, _ = ops
    monkeypatch.setattr(jop, "strictly_decreasing_decay", strictly_decreasing)
    monkeypatch.setattr(top, "strictly_decreasing_decay", strictly_decreasing)
    rng = np.random.default_rng(4)
    decay = np.concatenate([params["decay"], params["decay"][:, :1] * 0.5], axis=1)
    p = {"decay": decay * rng.uniform(0.01, 20, decay.shape).astype(np.float32),
         "weights": np.concatenate([params["weights"]] * 2, axis=1)
         * rng.uniform(0, 1e3, decay.shape).astype(np.float32), "phases": params["phases"]}
    ref = jax.vmap(jop.project)({k: jnp.asarray(v) for k, v in p.items()})
    ours = top.project(_t(p))
    for k in ("decay", "weights"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6)


def test_rir_to_H(ops):
    """A known RIR to the subband filter: scale 8/(win/hop), frame 0
    dropped, cut to Nf frames (1e-5 of the largest value)."""
    jop, top, _, _, _ = ops
    rng = np.random.default_rng(7)
    rir = (np.exp(-np.arange(6000) / 800) * rng.standard_normal(6000)).astype(np.float32)
    ours = top.rir_to_H(torch.from_numpy(rir))
    ref = np.asarray(jop.rir_to_H(jnp.asarray(rir)))
    assert ours.shape == ref.shape == (513, 100)
    assert rel_err(ours.numpy(), ref) < 1e-5


def test_inner_loss_param_grads(ops):
    """Gradient of the blind inner-loop loss (compressed-STFT reconstruction
    plus the RIR-noise regulariser, fixed noise) w.r.t. {decay, weights,
    phases}, per utterance.  Tolerance 5e-4 of the largest gradient: the
    chain runs cons (minimum phase through log/exp), two STFT round trips and
    the 0.667-power compression in float32, differentiated on both sides."""
    from buddy_tpu.losses import get_loss as jget
    from buddy_tpu_torch.losses import get_loss as tget
    jop, top, params, H, _ = ops
    args = jax_compose(BLIND_SMALL)
    ps = args["tester"]["posterior_sampling"]
    rng = np.random.default_rng(5)
    x_den = rng.standard_normal((B, N)).astype(np.float32) * 0.05
    y = np.asarray(jax.vmap(lambda xx, hh: jop.degradation(xx, H=hh))(
        jnp.asarray(rng.standard_normal((B, N)).astype(np.float32) * 0.05), jnp.asarray(H)))
    reg_noise = rng.standard_normal((B, jop.length_rir + 1024)).astype(np.float32)
    t_op = 0.005

    jrec, jreg = jget(ps["rec_loss_params"], jop), jget(ps["RIR_noise_regularization"]["loss"], jop)

    def jloss(p, xd, yy, nz):
        Hh = jop.compute_H(p)
        X = jop.apply_stft(xd)
        y_hat = jop.degradation(None, H=Hh, X=X, length=N)
        rir = jop.get_time_RIR(H=Hh)
        return (jrec(jrec.prepare(jop.apply_stft(yy)), y_hat, x_prepared=True)
                + jreg(rir, jax.lax.stop_gradient(rir + t_op * nz)))
    g_ref = jax.jit(jax.vmap(jax.grad(jloss)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x_den), jnp.asarray(y),
        jnp.asarray(reg_noise))

    trec, treg = tget(ps["rec_loss_params"], top), tget(ps["RIR_noise_regularization"]["loss"], top)
    p = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    Hh = top.compute_H(p)
    y_hat = top.degradation(None, H=Hh, X=top.apply_stft(torch.from_numpy(x_den)), length=N)
    rir = top.get_time_RIR(Hh)
    loss = (trec(trec.prepare(top.apply_stft(torch.from_numpy(y))), y_hat, x_prepared=True)
            + treg(rir, (rir + t_op * torch.from_numpy(reg_noise)).detach()))
    assert loss.shape == (B,)
    grads = torch.autograd.grad(loss.sum(), list(p.values()))
    for k, g in zip(p, grads):
        assert rel_err(g.numpy(), np.asarray(g_ref[k])) < 5e-4, k


@pytest.mark.parametrize("cfg", [
    {"name": "l2_stft_sum"},
    {"name": "l2_stft_mag_sum", "freq_weighting": "sqrt"},
    {"name": "l2_stft_logmag_sum"},
    {"name": "l2_comp_stft_sum", "compression_factor": 0.5, "freq_weighting": "log"},
    {"name": "l2_comp_stft_mean", "compression_factor": 0.667, "weight": 3.0},
    {"name": "l2_log_stft_sum", "freq_weighting": "linear"},
    {"name": "l2_sum", "weight": 2.0},
    {"name": "l2_mean"},
], ids=lambda c: c["name"] + "_" + c.get("freq_weighting", "none"))
def test_loss_zoo(ops, cfg):
    """Every loss of get_loss on waveforms through the operator's STFT, and
    its gradient w.r.t. the estimate, per utterance.  Tolerance 1e-4
    relative (float32 STFTs, powers and logs)."""
    from buddy_tpu.losses import get_loss as jget
    from buddy_tpu_torch.losses import get_loss as tget
    jop, top, _, _, _ = ops
    rng = np.random.default_rng(9)
    x, x_hat = (rng.standard_normal((B, 4096)).astype(np.float32) * 0.05 for _ in range(2))
    jl, tl = jget(cfg, jop), tget(cfg, top)
    f = lambda a, b: jl(a[None], b[None])
    ref = np.asarray(jax.vmap(f)(jnp.asarray(x), jnp.asarray(x_hat)))
    g_ref = np.asarray(jax.vmap(jax.grad(f, argnums=1))(jnp.asarray(x), jnp.asarray(x_hat)))
    xt = torch.from_numpy(x_hat).requires_grad_(True)
    ours = tl(torch.from_numpy(x), xt)
    ours.sum().backward()
    assert ours.shape == (B,)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-4)
    assert rel_err(xt.grad.numpy(), g_ref) < 1e-4


def test_loss_zero_bins():
    """l2_comp_stft_summean values and gradients with zero bins (the
    zero-padded STFT frames): both sides give the bin the value (1e-8)^c and
    a zero gradient.  Tolerance 1e-5 relative (float32 powers)."""
    from buddy_tpu.losses import get_loss as jget
    from buddy_tpu_torch.losses import get_loss as tget
    cfg = {"name": "l2_comp_stft_summean", "weight": 512, "compression_factor": 0.667}
    rng = np.random.default_rng(6)
    a, b, y = (rng.standard_normal((B, 513, 40)).astype(np.float32) for _ in range(3))
    a[:, :, -3:] = 0
    b[:, :, -3:] = 0
    a[0, 7, 5] = b[0, 7, 5] = 0
    Y = (y + 1j * y[::-1]).astype(np.complex64)
    jl, tl = jget(cfg), tget(cfg)
    f = lambda yy, aa, bb: jl(yy, jax.lax.complex(aa, bb))
    args = (jnp.asarray(Y), jnp.asarray(a), jnp.asarray(b))
    ref = np.asarray(jax.vmap(f)(*args))
    ga, gb = jax.vmap(jax.grad(f, argnums=(1, 2)))(*args)
    at, bt = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    ours = tl(torch.from_numpy(Y), torch.complex(at, bt))
    ours.sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5)
    assert rel_err(at.grad.numpy(), np.asarray(ga)) < 1e-5
    assert rel_err(bt.grad.numpy(), np.asarray(gb)) < 1e-5
    assert at.grad[0, 7, 5] == 0 and bt.grad[:, :, -3:].abs().max() == 0


def test_wpe_against_jax_and_float64():
    """wpe_dereverb of reverberant speech (two in-repo utterances through a
    seeded RIR), taps=10 as in the test-size warm init, against the JAX
    package and against the port's own WPE solved in complex128.  The
    complex64 per-bin solves are ill-conditioned: on this input both float32
    implementations sit 0.3-0.4% of the peak from the complex128 solution
    and 0.55% from each other, and reduction order alone moves complex64
    WPE by ~1.6% (tests/make_wpe_golden.py): 2e-2 of the largest value
    against JAX, 1e-2 against complex128."""
    from buddy_tpu.sampling.wpe import wpe_dereverb as jwpe
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    from buddy_tpu_torch.sampling.wpe import wpe_bins, wpe_dereverb
    from test_torch_common import REPO
    src = np.stack([read_wav(os.path.join(REPO, "quality_out_heldout", f"clean_utt{i}.wav"))[0]
                    [8000:8000 + N] for i in range(B)])
    rng = np.random.default_rng(8)
    rir = (np.exp(-np.arange(1500) / 300) * rng.standard_normal(1500)).astype(np.float32)
    rir[0] = 1.0
    y = np.stack([np.convolve(s, rir)[:N] for s in src]).astype(np.float32)
    ref = np.asarray(jwpe(jnp.asarray(y), taps=10, delay=2, iterations=5))
    ours = wpe_dereverb(torch.from_numpy(y), taps=10, delay=2, iterations=5).numpy()
    assert ours.shape == ref.shape
    assert rel_err(ours, ref) < 2e-2
    geom = STFT(512, 128, hann_window(512), pad_mode="constant", device="cpu")
    X64 = wpe_bins(geom.stft(torch.from_numpy(y)).to(torch.complex128), 10, 2, 5)
    z64 = geom.istft(X64.to(torch.complex64), length=N).numpy()
    assert rel_err(ours, z64) < 1e-2


def test_wpe_golden():
    """The pinned WPE golden (tests/goldens/wpe_golden.npz): real speech with
    a seeded RIR through the production warm init (taps=50, delay=2, 5
    iterations).  Tolerance 2e-2 of the largest value (measured: 0.95%):
    the golden pins one float32 CPU run of the JAX package, and
    tests/make_wpe_golden.py records that reduction-order noise alone moves
    it ~1.6% through the five ill-conditioned iterations."""
    from buddy_tpu_torch.sampling.wpe import wpe_dereverb
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "wpe_golden.npz"))
    z = wpe_dereverb(torch.from_numpy(g["y"]), taps=50, delay=2, iterations=5).numpy()
    assert np.isfinite(z).all()
    assert rel_err(z, g["z"]) < 2e-2
