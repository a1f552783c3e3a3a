"""Parity of the port's signal kernels (plain versions, CPU) with the JAX
package: K2 STFT/ISTFT at the three geometries of the main path, K3 subband
convolution, K1 GroupNorm(+SiLU), and the minimum-phase chain.

Tolerances: both sides compute in float32 and sum in different orders (the
port's torch.fft frames against JAX's FFTs), so values agree to a few float32 ulps
of the largest output, stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import rel_err

GEOMETRIES = {
    # (n_fft, hop, window kind, pad mode): model, operator, WPE
    "model_510": (510, 128, "hann", "reflect"),
    "operator_1024": (1024, 128, "hann512_padded", "constant"),
    "wpe_512": (512, 128, "hann", "constant"),
}


def _window(n_fft, kind):
    from buddy_tpu_torch.ops.stft import hann_window
    return np.pad(hann_window(512), (0, 512)) if kind == "hann512_padded" else hann_window(n_fft)


def _geometry(name):
    from buddy_tpu_torch.ops.stft import STFT
    n_fft, hop, kind, mode = GEOMETRIES[name]
    return STFT(n_fft, hop, _window(n_fft, kind), pad_mode=mode, device="cpu"), n_fft, hop, kind, mode


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_stft_values_and_signal_grad(name):
    """stft values, and the gradient of a real loss of |stft|^2 w.r.t. the
    real signal.  Tolerance 2e-5 of the largest magnitude (float32 sums of
    ~512 products in different orders)."""
    from buddy_tpu.ops.stft import stft as jstft
    geom, n_fft, hop, kind, mode = _geometry(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    w = _window(n_fft, kind)
    ours = geom.stft(torch.from_numpy(x))
    ref = np.asarray(jstft(jnp.asarray(x), w, n_fft=n_fft, hop_length=hop, pad_mode=mode))
    assert ours.shape == ref.shape
    assert rel_err(ours.numpy(), ref) < 2e-5

    r = rng.standard_normal(ref.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.abs(geom.stft(xt)) ** 2 * torch.from_numpy(r)).sum().backward()
    g_ref = jax.grad(lambda v: jnp.sum(jnp.abs(
        jstft(v, w, n_fft=n_fft, hop_length=hop, pad_mode=mode)) ** 2 * r))(jnp.asarray(x))
    assert rel_err(xt.grad.numpy(), np.asarray(g_ref)) < 5e-5


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_istft_values_and_grad(name):
    """istft of a spectrum built from two real leaves (re, im), cropped to a
    length: values, and gradients w.r.t. the real leaves (torch's and JAX's
    complex conventions differ, real leaves compare like with like).
    Tolerance 1e-4 of the largest value: the envelope division amplifies
    rounding at the edges of the operator's half-zero window."""
    from buddy_tpu.ops.stft import istft as jistft
    geom, n_fft, hop, kind, mode = _geometry(name)
    w = _window(n_fft, kind)
    rng = np.random.default_rng(2)
    F = n_fft // 2 + 1
    re, im = (rng.standard_normal((2, F, 24)).astype(np.float32) for _ in range(2))
    length = 2900
    r = rng.standard_normal((2, length)).astype(np.float32)
    ret, imt = torch.from_numpy(re).requires_grad_(True), torch.from_numpy(im).requires_grad_(True)
    y = geom.istft(torch.complex(ret, imt), length=length)
    (y * torch.from_numpy(r)).sum().backward()

    def jfun(a, b):
        return jistft(jax.lax.complex(a, b), w, n_fft=n_fft, hop_length=hop, length=length)
    y_ref = np.asarray(jfun(jnp.asarray(re), jnp.asarray(im)))
    assert y.shape == y_ref.shape
    assert rel_err(y.detach().numpy(), y_ref) < 1e-4
    g_re, g_im = jax.grad(lambda a, b: jnp.sum(jfun(a, b) * r), argnums=(0, 1))(
        jnp.asarray(re), jnp.asarray(im))
    assert rel_err(ret.grad.numpy(), np.asarray(g_re)) < 1e-4
    assert rel_err(imt.grad.numpy(), np.asarray(g_im)) < 1e-4


def test_istft_padded_frames_and_roundtrip():
    """The model pads frames to a multiple of 16 before the U-Net; the
    padded frames change the tail envelope, as in torch.istft (1e-5 of the
    largest value).  Without padding stft -> istft returns the signal
    (1e-5: a float32 round trip)."""
    from buddy_tpu_torch.ops.stft import pad_spec_frames
    geom = _geometry("model_510")[0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4096)).astype(np.float32))
    spec = geom.stft(x)
    assert (geom.istft(spec, 4096) - x).abs().max() < 1e-5
    padded = pad_spec_frames(spec, 16)
    assert padded.shape[-1] % 16 == 0
    ref = torch.istft(padded, 510, 128, window=torch.from_numpy(_window(510, "hann")),
                      center=True, length=4096)
    assert rel_err(geom.istft(padded, 4096).numpy(), ref.numpy()) < 1e-5


def test_subband_conv_plain_matches_jax_and_adjoints():
    """K3 plain forward against the JAX subband_filtering (FFT convolution),
    and the plain adjoint / filter-gradient formulas against autograd of the
    plain forward.  Tolerance 1e-5 of the largest output (float32 sums of
    100 products against an FFT route)."""
    from buddy_tpu.operators.subband import SubbandFiltering as JSub
    from buddy_tpu_torch.ops import subband_conv as K3
    from test_torch_common import jax_compose, op_hp
    jop = JSub(op_hp(jax_compose(["tester=blind_dereverberation_BUDDy"])), sample_rate=16000)
    rng = np.random.default_rng(4)
    F, T, Nf = 513, 37, 100
    cplx = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)
    X, H, G = cplx(2, F, T), cplx(2, F, Nf), cplx(2, F, T)
    ours = K3.subband_conv(torch.from_numpy(X), torch.from_numpy(H), 1)
    ref = np.stack([np.asarray(jop.subband_filtering(jnp.asarray(X[b]), jnp.asarray(H[b])))
                    for b in range(2)])
    assert rel_err(ours.numpy(), ref) < 1e-5

    Xt = torch.from_numpy(X).requires_grad_(True)
    Ht = torch.from_numpy(H).requires_grad_(True)
    dX, dH = torch.autograd.grad(K3.subband_conv_plain(Xt, Ht, 1), (Xt, Ht),
                                 torch.from_numpy(G))
    Gt = torch.from_numpy(G)
    assert rel_err(K3.subband_conv_adjoint_plain(Gt, Ht.detach(), 1).numpy(), dX.numpy()) < 1e-5
    assert rel_err(K3.subband_conv_filter_grad_plain(Gt, Xt.detach(), Nf, 1).numpy(),
                   dH.numpy()) < 1e-5
    # a shared signal row (batch 1) broadcasts over the filters' batch
    shared = K3.subband_conv(torch.from_numpy(X[:1]), torch.from_numpy(H), 1)
    assert rel_err(shared[1].numpy(), K3.subband_conv(
        torch.from_numpy(X[:1]), torch.from_numpy(H[1:]), 1)[0].numpy()) < 1e-6


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_act_forward_and_vjp(silu):
    """K1 plain version against the JAX GroupNormAct in float32: forward and
    the vjp w.r.t. x, scale and bias.  Tolerance 1e-5 relative (float32
    moments over 96 elements per group)."""
    from buddy_tpu.models.layers import GroupNormAct as JGN
    from buddy_tpu_torch.ops.groupnorm import group_norm_act
    rng = np.random.default_rng(5 + silu)
    B, H, W, C, G = 2, 6, 8, 16, 4
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    dy = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mod = JGN(num_groups=G, epsilon=1e-6, act=jax.nn.silu if silu else None)
    f = lambda x_, s_, b_: mod.apply({"params": {"scale": s_, "bias": b_}}, x_)
    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    gx, gs, gb = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = group_norm_act(xt, st, bt, G, 1e-6, silu=silu)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    assert rel_err(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref)) < 1e-5
    assert rel_err(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)) < 1e-5
    assert rel_err(st.grad.numpy(), np.asarray(gs)) < 1e-5
    assert rel_err(bt.grad.numpy(), np.asarray(gb)) < 1e-5


def test_minimum_phase_and_hilbert():
    """minimum_phase_version and hilbert against the JAX package (1e-5 of the
    largest value; float32 FFTs of length 2*1000)."""
    from buddy_tpu.ops.minphase import hilbert as jh, minimum_phase_version as jmp
    from buddy_tpu_torch.ops.minphase import hilbert, minimum_phase_version
    rng = np.random.default_rng(6)
    h = (rng.standard_normal((2, 1000)) * np.exp(-np.arange(1000) / 200)).astype(np.float32)
    assert rel_err(minimum_phase_version(torch.from_numpy(h)).numpy(),
                   np.asarray(jmp(jnp.asarray(h)))) < 1e-5
    for n in (999, 1000):   # odd n puts the value 2 at the window's centre
        assert rel_err(hilbert(torch.from_numpy(h[:, :n])).numpy(),
                       np.asarray(jh(jnp.asarray(h[:, :n])))) < 1e-5


def test_dft_helpers():
    """The port's DFT helpers against numpy, and good_fft_size against the
    JAX package's (exact)."""
    from buddy_tpu.ops.fftconv import good_fft_size as jgood
    from buddy_tpu_torch.ops import dft
    for n in (7, 612, 625, 1000, 25856):
        assert dft.good_fft_size(n) == jgood(n)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    Z = np.fft.fft(x, 64)
    np.testing.assert_allclose(dft.cfft(torch.from_numpy(x), 64).numpy(), Z, atol=1e-4)
    np.testing.assert_allclose(dft.icfft_slice(torch.from_numpy(Z.astype(np.complex64)), 64, 5, 20)
                               .numpy(), np.fft.ifft(Z)[:, 5:25], atol=1e-5)
    np.testing.assert_allclose(dft.irfft(dft.rfft(torch.from_numpy(x), 40), 40).numpy(), x,
                               atol=1e-5)
