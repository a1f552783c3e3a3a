"""The plain versions of kernels K4-K7, forward and explicit backward, against
the JAX functions they replace and ``jax.grad``, on seeded numpy inputs.

The backward kernels implement the explicit formulas checked here
(``*_backward_plain``); on the card ``chip_smoke.py`` holds each kernel
against these plain versions.  Gradients of a real loss w.r.t. a complex
tensor follow torch's convention, which is the conjugate of ``jax.grad``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import BLIND_SMALL, jax_compose, op_hp, rel_err, torch_compose


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _spectra(seed, shape=(2, 9, 14)):
    """A reference A (already compressed) and an estimate X with exact zero
    bins (the STFT's zero-padded frames) and one bin far below the 1e-8
    floor's scale."""
    rng = np.random.default_rng(seed)
    A, X = _cplx(rng, *shape), _cplx(rng, *shape) * 3.0
    X[:, :, -2:] = 0
    X[0, 0, 0] = 1e-6 + 1e-7j
    return A, X


# --- K4 -----------------------------------------------------------------------
@pytest.mark.parametrize("factor", [0.667, 0.3, 1.0])
def test_compress_forward_backward(factor):
    """C(X) against the JAX package's ``_compress`` (1e-6 relative: float32
    pow), the explicit backward against ``jax.vjp`` (conjugated) and against
    autograd of the plain forward (1e-5: the formula's own rounding)."""
    from buddy_tpu.losses import _compress as jcompress
    from buddy_tpu_torch.ops.spec_loss import compress_backward_plain, compress_plain
    A, X = _spectra(1)
    ref, vjp = jax.vjp(lambda x: jcompress(x, factor), jnp.asarray(X))
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = compress_plain(Xt, factor)
    assert rel_err(out.detach().numpy(), np.asarray(ref)) < 1e-6
    assert out[0, 0, -1] == complex((1e-8) ** factor, 0)
    g = torch.from_numpy(A)
    explicit = compress_backward_plain(Xt.detach(), g, factor)
    (auto,) = torch.autograd.grad(out, Xt, g)
    assert rel_err(explicit.numpy(), auto.numpy()) < 1e-5
    assert rel_err(explicit.numpy(), np.conj(np.asarray(vjp(jnp.asarray(np.conj(A)))[0]))) < 1e-5
    assert torch.all(explicit[:, :, -2:] == 0)


@pytest.mark.parametrize("name", ["l2_comp_stft_sum", "l2_comp_stft_mean",
                                  "l2_comp_stft_summean"])
def test_comp_loss_against_jax(name):
    """The three reductions through ``get_loss`` against the JAX loss per
    utterance, value and both gradients (1e-5 relative: float32 sums of a few
    hundred terms); the explicit backward against autograd of the plain."""
    from buddy_tpu.losses import get_loss as jget
    from buddy_tpu_torch.losses import get_loss
    from buddy_tpu_torch.ops.spec_loss import comp_loss_backward_plain
    cfg = {"name": name, "weight": 512, "compression_factor": 0.667}
    jloss, tloss = jget(cfg), get_loss(cfg)
    A, X = _spectra(2)
    At = torch.from_numpy(A).requires_grad_(True)
    Xt = torch.from_numpy(X).requires_grad_(True)
    out = tloss(At, Xt, x_prepared=True)
    assert out.shape == (2,)
    gw = torch.tensor([0.7, -1.3])
    gA, gX = torch.autograd.grad((out * gw).sum(), [At, Xt])
    for b in range(2):
        f = lambda a, x: jloss(a, x, x_prepared=True)
        val, (ja, jx) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(A[b]),
                                                               jnp.asarray(X[b]))
        assert abs(float(out[b]) - float(val)) < 1e-5 * abs(float(val))
        assert rel_err(gA[b].numpy(), float(gw[b]) * np.conj(np.asarray(ja))) < 1e-5
        assert rel_err(gX[b].numpy(), float(gw[b]) * np.conj(np.asarray(jx))) < 1e-5
    F_, T_ = X.shape[-2:]
    scale = 512 / {"l2_comp_stft_sum": 1, "l2_comp_stft_mean": F_ * T_,
                   "l2_comp_stft_summean": T_}[name]
    eA, eX = comp_loss_backward_plain(At.detach(), Xt.detach(), gw, 0.667, scale)
    assert rel_err(eA.numpy(), gA.numpy()) < 1e-5
    assert rel_err(eX.numpy(), gX.numpy()) < 1e-5


def test_comp_loss_unprepared_reference_carries_gradient():
    """``loss(x, x_hat)`` with a raw reference spectrum (the RIR regulariser's
    call): the gradient reaches x through the compression, as in JAX."""
    from buddy_tpu.losses import get_loss as jget
    from buddy_tpu_torch.losses import get_loss
    cfg = {"name": "l2_comp_stft_summean", "weight": 2.0, "compression_factor": 0.5}
    A, X = _spectra(3, (1, 6, 8))
    At = torch.from_numpy(A).requires_grad_(True)
    (g,) = torch.autograd.grad(get_loss(cfg)(At, torch.from_numpy(X)).sum(), At)
    ref = jax.grad(lambda a: jget(cfg)(a, jnp.asarray(X[0])))(jnp.asarray(A[0]))
    assert rel_err(g[0].numpy(), np.conj(np.asarray(ref))) < 1e-5


# --- K5 -----------------------------------------------------------------------
@pytest.mark.parametrize("L", [64, 101, 33])
def test_minimum_phase_forward_backward(L):
    """Even and odd n (n = 2L is always even; the odd window is exercised
    through ``hilbert``), a zero row (|H| = 0 everywhere, gradient 0).
    Forward against JAX 2e-5 of the peak (float32 FFT chains through log and
    exp); explicit backward against autograd 1e-4 and ``jax.grad`` 2e-4."""
    from buddy_tpu.ops.minphase import minimum_phase_version as jmin
    from buddy_tpu_torch.ops.minphase import (minimum_phase_backward_plain, minimum_phase_plain,
                                              minimum_phase_version)
    rng = np.random.default_rng(L)
    h = (np.exp(-np.arange(L) / 9.0) * rng.standard_normal((3, L))).astype(np.float32)
    h[2] = 0
    g = rng.standard_normal((3, L)).astype(np.float32)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = minimum_phase_version(ht)                          # CPU: the plain version
    ref = jax.vmap(jmin)(jnp.asarray(h))
    assert rel_err(out.detach().numpy(), np.asarray(ref)) < 2e-5
    (auto,) = torch.autograd.grad(minimum_phase_plain(ht), ht, torch.from_numpy(g))
    explicit = minimum_phase_backward_plain(ht.detach(), torch.from_numpy(g))
    assert torch.isfinite(explicit).all()
    assert rel_err(explicit.numpy(), auto.numpy()) < 1e-4
    jg = jax.grad(lambda x: jnp.sum(jax.vmap(jmin)(x) * jnp.asarray(g)))(jnp.asarray(h))
    assert rel_err(explicit[:2].numpy(), np.asarray(jg)[:2]) < 2e-4


@pytest.mark.parametrize("n", [16, 17])
def test_hilbert_window_even_and_odd(n):
    """The flipped Heaviside window has the value 2 at the centre of an odd
    length and no centre for an even one; ``hilbert`` against JAX (1e-6)."""
    from buddy_tpu.ops.minphase import hilbert as jhilbert
    from buddy_tpu_torch.ops.minphase import _heaviside_window, hilbert
    w = _heaviside_window(n)
    assert w[: n // 2].tolist() == [2.0] * (n // 2) and w[-(n // 2):].tolist() == [0.0] * (n // 2)
    assert n % 2 == 0 or w[n // 2] == 2.0
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    assert rel_err(hilbert(torch.from_numpy(x)).numpy(), np.asarray(jhilbert(jnp.asarray(x)))) < 1e-6


# --- K6 -----------------------------------------------------------------------
def _operators(fix_extremes: bool, n_exp: int):
    from buddy_tpu.operators.subband import BlindSubbandFiltering as JBlind
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    over = [f"tester.informed_dereverberation.op_hp.fix_EQ_extremes={fix_extremes}"]
    if n_exp == 2:
        over += ["tester.informed_dereverberation.op_hp.init_params.T60_breakpoints=[0.1,0.4]",
                 "tester.informed_dereverberation.op_hp.init_params.multiexp_weighting=[2,1]"]
    jop = JBlind(op_hp(jax_compose(BLIND_SMALL + over)), sample_rate=16000)
    top = BlindSubbandFiltering(op_hp(torch_compose(BLIND_SMALL + over)), sample_rate=16000,
                                device="cpu")
    return jop, top


@pytest.mark.parametrize("fix_extremes,n_exp", [(True, 1), (True, 2), (False, 1), (False, 2)])
def test_filter_design_forward_backward(fix_extremes, n_exp):
    """H = design_filter * exp(i phases) against the JAX operator (2e-5 of
    the peak: decay^(-n) up to n = 99 in float32), and the explicit backward
    (decay, weights, phases) against autograd (1e-4) and ``jax.grad`` (3e-4:
    sums of ~51k float32 terms in another order)."""
    from buddy_tpu_torch.ops.filter_design import (filter_design, filter_design_backward_plain,
                                                   filter_design_plain)
    jop, top = _operators(fix_extremes, n_exp)
    rng = np.random.default_rng(7 + n_exp)
    B, bands = 2, top.num_bands
    decay0, w0 = top._init_decay_weights()
    assert decay0.shape == (n_exp, bands)
    decay = (decay0[None] * rng.uniform(0.5, 2.0, (B, n_exp, bands))).astype(np.float32)
    weights = (w0[None] * rng.uniform(0.5, 2.0, (B, n_exp, bands))).astype(np.float32)
    phases = rng.uniform(-np.pi, np.pi, (B, 513, top.Nf)).astype(np.float32)
    gH = _cplx(rng, B, 513, top.Nf)
    geom = top._design_geometry

    def jH(d, w, p):
        return jop.design_filter({"decay": d, "weights": w}) * jnp.exp(1j * p)

    td, tw, tp = (torch.from_numpy(a).requires_grad_(True) for a in (decay, weights, phases))
    H = filter_design(td, tw, tp, geom)                      # CPU: the plain version
    for b in range(B):
        assert rel_err(H[b].detach().numpy(),
                       np.asarray(jH(*(jnp.asarray(a[b]) for a in (decay, weights, phases))))) < 2e-5
    auto = torch.autograd.grad(filter_design_plain(td, tw, tp, geom), [td, tw, tp],
                               torch.from_numpy(gH))
    explicit = filter_design_backward_plain(td.detach(), tw.detach(), tp.detach(),
                                            torch.from_numpy(gH), geom)
    for e, a in zip(explicit, auto):
        assert e.shape == a.shape
        assert rel_err(e.numpy(), a.numpy()) < 1e-4
    for b in range(B):
        loss = lambda d, w, p: jnp.sum(jnp.real(jH(d, w, p) * jnp.conj(jnp.asarray(gH[b]))))
        jg = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a[b])
                                                 for a in (decay, weights, phases)))
        for e, j in zip(explicit, jg):
            assert rel_err(e[b].numpy(), np.asarray(j)) < 3e-4


def test_compute_H_batched_and_unbatched_against_jax():
    """``compute_H`` (K6's wrapper, then cons with K5's wrapper) for batched
    and unbatched parameters against the JAX operator (1e-4 of the peak)."""
    jop, top = _operators(True, 1)
    params, _ = jop.reset_batched(jax.random.PRNGKey(3), 2)
    ref = np.stack([np.asarray(jop.compute_H({k: v[b] for k, v in params.items()}))
                    for b in range(2)])
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    assert rel_err(top.compute_H(tp).numpy(), ref) < 1e-4
    assert rel_err(top.compute_H({k: v[0] for k, v in tp.items()}).numpy(), ref[0]) < 1e-4


# --- K7 -----------------------------------------------------------------------
def _wpe_systems(seed, batch=6, taps=10, T=80):
    """Power-weighted correlation systems as WPE builds them, from a seeded
    reverberant-like spectrum."""
    rng = np.random.default_rng(seed)
    Y = _cplx(rng, batch, T) * np.exp(-np.arange(T) / 30.0).astype(np.float32)
    Yt = np.stack([np.pad(Y, ((0, 0), (2 + k, 0)))[:, :T] for k in range(taps)], 1)
    power = np.maximum(np.abs(Y) ** 2, 1e-10)
    Yn = Yt / power[:, None, :]
    R = Yn @ np.conj(Yt).transpose(0, 2, 1)
    P = (Yn @ np.conj(Y)[..., None])[..., 0]
    return R.astype(np.complex64), P.astype(np.complex64)


@pytest.mark.parametrize("seed", [0, 1])
def test_wpe_solve_plain_against_jax_and_float64(seed):
    """The plain solve against the JAX formula by the residual of the loaded
    system (both below 1e-3 of |P|; complex64 on an ill-conditioned matrix),
    and against a complex128 solve of the same input."""
    from buddy_tpu_torch.ops.wpe_solve import wpe_solve
    R, P = _wpe_systems(seed)
    n = R.shape[-1]
    G = wpe_solve(torch.from_numpy(R), torch.from_numpy(P)).numpy()

    def jsolve(r, p):
        load = 1e-6 * (jnp.trace(r).real / n) + 1e-10
        return jnp.linalg.solve(r + load * jnp.eye(n, dtype=r.dtype), p)

    Gj = np.asarray(jax.vmap(jsolve)(jnp.asarray(R), jnp.asarray(P)))
    load = 1e-6 * np.trace(R, axis1=-2, axis2=-1).real / n + 1e-10
    A = R.astype(np.complex128) + load[:, None, None] * np.eye(n)
    resid = lambda g: np.linalg.norm((A @ g[..., None])[..., 0] - P) / np.linalg.norm(P)
    assert resid(G) < 1e-3 and resid(Gj) < 1e-3
    G64 = np.linalg.solve(A, P.astype(np.complex128)[..., None])[..., 0]
    assert resid(G64) < 1e-9
    assert G.shape == P.shape and np.isfinite(G).all()


def test_wpe_bins_uses_the_solve_wrapper(monkeypatch):
    """``wpe_bins`` reaches the solve only through K7's wrapper, once per
    iteration, with R (..., taps, taps) and P (..., taps)."""
    import buddy_tpu_torch.sampling.wpe as twpe
    calls = []
    real = twpe.wpe_solve
    monkeypatch.setattr(twpe, "wpe_solve",
                        lambda R, P, *a: calls.append((R.shape, P.shape)) or real(R, P, *a))
    Y = torch.from_numpy(_cplx(np.random.default_rng(4), 2, 5, 60))
    out = twpe.wpe_bins(Y, taps=4, delay=2, iterations=3)
    assert out.shape == Y.shape and torch.isfinite(torch.view_as_real(out)).all()
    assert calls == [(torch.Size([2, 5, 4, 4]), torch.Size([2, 5, 4]))] * 3


# --- the wrappers never fall back -------------------------------------------------
def test_fused_wrappers_refuse_cpu_fallback_for_other_devices():
    """K4-K7's wrappers take the plain version only for CPU tensors: a tensor
    on another device reaches the kernel path, which raises here."""
    from buddy_tpu_torch.ops import filter_design as fd, minphase, spec_loss, wpe_solve
    _, top = _operators(True, 1)
    c = lambda *s: torch.empty(s, dtype=torch.complex64, device="meta")
    f = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
    err = (ValueError, RuntimeError, ImportError, NotImplementedError)
    with pytest.raises(err):
        spec_loss.spec_compress(c(1, 3, 4), 0.5)
    with pytest.raises(err):
        spec_loss.comp_loss(c(1, 3, 4), c(1, 3, 4), 0.5, 1.0)
    with pytest.raises(err):
        minphase.minimum_phase_version(f(2, 8))
    with pytest.raises(err):
        fd.filter_design(f(1, 1, top.num_bands), f(1, 1, top.num_bands), f(1, 513, top.Nf),
                         top._design_geometry)
    with pytest.raises(err):
        wpe_solve.wpe_solve(c(2, 4, 4), c(2, 4))
