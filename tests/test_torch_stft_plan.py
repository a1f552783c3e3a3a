"""K2's FFT plan and the adjoint pair of its plain versions (CPU).

The CUDA kernels of K2 (``buddy_tpu_torch/csrc/stft.cu``) read a plan that
``StftPlan`` builds on the host: the radices of the packed complex FFT, the
Stockham twiddles, the direct-DFT roots and the post-twiddles of the real
split.  ``_plan_rfft`` / ``_plan_synthesis`` below run that plan in numpy
float32, stage by stage with the kernels' indexing, and are held against
``np.fft``: the tables are checked here before they reach the card.  The
adjoint tests hold the autograd functions' backward passes (the other
kernel, with per-bin weights) to the forward passes on the CPU path.
"""

import numpy as np
import pytest
import torch

from test_torch_signal import GEOMETRIES, _geometry, _window

MAX_STAGES = 12


def _plan(n_fft, window=None):
    from buddy_tpu_torch.ops.stft import StftPlan, hann_window
    return StftPlan(n_fft, 128, hann_window(n_fft) if window is None else window, device="cpu")


def _stages(plan, z):
    """The forward DFT of each row of z (complex64, length n_fft/2) through
    the plan's Stockham stages, as the kernels run them: butterfly j reads
    points j + r M/R, twiddles them from the table, and writes (j - k) R + k
    + q Ns with k = j mod Ns."""
    from buddy_tpu_torch.ops.stft import DIRECT_PRIMES
    tab = plan.table.numpy().view(np.complex64)
    h = plan.header
    S, M = int(h[4]), int(h[3])
    radices, tw_off, root_off = h[7:7 + S], h[7 + MAX_STAGES:7 + MAX_STAGES + S], \
        h[7 + 2 * MAX_STAGES:7 + 2 * MAX_STAGES + S]
    Ns = 1
    for R, to, ro in zip(radices, tw_off, root_off):
        R, nb = int(R), M // int(R)
        j = np.arange(nb)
        k = j % Ns
        v = np.stack([z[:, j + r * nb] for r in range(R)], -1)                 # (rows, nb, R)
        tw = tab[to + k[:, None] * (R - 1) + np.arange(R - 1)[None, :]]
        v = v * np.concatenate([np.ones((nb, 1), np.complex64), tw], 1)
        qr = np.outer(np.arange(R), np.arange(R)) % R
        W = tab[ro + qr] if R in DIRECT_PRIMES else \
            np.exp(-2j * np.pi * qr / R).astype(np.complex64)                  # butterflies: exact constants
        out = (v @ W).astype(np.complex64)
        y = np.empty_like(z)
        d = (j - k) * R + k
        for q in range(R):
            y[:, d + q * Ns] = out[..., q]
        z, Ns = y, Ns * R
    return z


def _plan_rfft(plan, x):
    """(rows, n) float32 -> (rows, n/2 + 1): packing, stages, real split."""
    M = plan.n_fft // 2
    post = plan.table.numpy().view(np.complex64)[plan.post_off:plan.post_off + M + 1]
    Z = _stages(plan, (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64))
    f = np.arange(M + 1)
    a, b = Z[:, f % M], np.conj(Z[:, (M - f) % M])
    X = (0.5 * (a + b) - 0.5j * post * (a - b)).astype(np.complex64)
    X[:, 0] = Z[:, 0].real + Z[:, 0].imag
    X[:, M] = Z[:, 0].real - Z[:, 0].imag
    return X


def _plan_synthesis(plan, X, w):
    """(rows, n/2 + 1) -> (rows, n): sum_f w_f Re(X_f e^{2 pi i f s / n})
    through the synthesis's packing (DC and Nyquist imaginary parts dropped,
    interior bins halved), the forward stages on conj(Z), and unpacking."""
    M = plan.n_fft // 2
    post = plan.table.numpy().view(np.complex64)[plan.post_off:plan.post_off + M + 1]
    Y = (X * w).astype(np.complex64)
    Y[:, 1:M] *= 0.5
    Y[:, [0, M]] = Y[:, [0, M]].real
    f = np.arange(M)
    a, b = Y[:, f], np.conj(Y[:, M - f])
    Z = (a + b) + 1j * np.conj(post[f]) * (a - b)
    r = _stages(plan, np.conj(Z).astype(np.complex64))
    s = np.empty((X.shape[0], plan.n_fft), np.float32)
    s[:, 0::2], s[:, 1::2] = r.real, -r.imag
    return s


def test_fft_radices():
    """The factorisations the kernels run, and the lengths they refuse."""
    from buddy_tpu_torch.ops.stft import fft_radices
    assert fft_radices(512) == [8, 8, 8]
    assert fft_radices(256) == [8, 8, 4]
    assert fft_radices(128) == [8, 8, 2]
    assert fft_radices(255) == [3, 5, 17]
    assert fft_radices(300) == [4, 3, 5, 5]
    assert fft_radices(124) == [4, 31]
    assert fft_radices(17 * 17) == [17, 17]
    for m in (37, 2 * 37, 7 * 11, 1):            # a prime above 31, two direct primes, nothing
        assert fft_radices(m) is None


@pytest.mark.parametrize("n_fft", [510, 512, 1024, 600, 248])
def test_plan_stage_loop_matches_numpy_fft(n_fft):
    """The plan's tables run stage by stage in float32 give np.fft.rfft and
    np.fft.irfft (weights 1/n at DC and Nyquist, 2/n elsewhere) to 1e-5 of
    the peak: float32 butterflies over log n stages.  600 = 2 (4 3 5 5)
    exercises the radix-3 and radix-5 butterflies, 248 = 2 (4 31) the
    largest direct DFT."""
    plan = _plan(n_fft)
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((6, n_fft)).astype(np.float32)
    X = _plan_rfft(plan, x)
    ref = np.fft.rfft(x.astype(np.float64))
    assert np.abs(X - ref).max() < 1e-5 * np.abs(ref).max()
    assert (X[:, 0].imag == 0).all() and (X[:, -1].imag == 0).all()

    Xr = (rng.standard_normal(ref.shape) + 1j * rng.standard_normal(ref.shape)).astype(np.complex64)
    s = _plan_synthesis(plan, Xr, plan.istft_weights.numpy())
    Xh = Xr.astype(np.complex128)
    Xh[:, [0, -1]] = Xh[:, [0, -1]].real            # a C2R sees no imaginary DC or Nyquist
    s_ref = np.fft.irfft(Xh, n=n_fft)
    assert np.abs(s - s_ref).max() < 1e-5 * np.abs(s_ref).max()


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_analysis_and_synthesis_are_adjoint(name):
    """<analysis(x), g> = <x, analysis^T(g)> and <synthesis(X), r> =
    <X, synthesis^T(r)> with the transposes from the autograd functions'
    backward passes (the other plain version with per-bin weights), in
    float64 to 1e-10 relative; each backward also equals autograd through
    the plain version's torch.fft ops (1e-10), and the synthesis's gradient
    has no imaginary part at DC or Nyquist."""
    from buddy_tpu_torch.ops import stft as K2
    geom = _geometry(name)[0]
    plan = geom.plan
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 2000)))
    blocks, T = geom.frame_blocks(x)
    blocks = blocks.detach().requires_grad_(True)
    spec = K2.stft_analysis(blocks, plan, T)
    g = torch.from_numpy(rng.standard_normal(spec.shape) + 1j * rng.standard_normal(spec.shape))
    inner = (spec.real * g.real + spec.imag * g.imag).sum()
    inner.backward()
    inner = float(inner.detach())
    assert abs(inner - float((blocks.detach() * blocks.grad).sum())) < 1e-10 * abs(inner)
    b2 = blocks.detach().requires_grad_(True)
    spec2 = K2.analysis_plain(b2, plan, T, plan.ones)
    (gb,) = torch.autograd.grad((spec2.real * g.real + spec2.imag * g.imag).sum(), b2)
    assert float((gb - blocks.grad).abs().max()) < 1e-10 * float(gb.abs().max())

    X = torch.from_numpy(rng.standard_normal(spec.shape) + 1j * rng.standard_normal(spec.shape))
    X.requires_grad_(True)
    y = K2.stft_synthesis(X, plan)
    r = torch.from_numpy(rng.standard_normal(y.shape))
    inner = (y * r).sum()
    inner.backward()
    gX, inner = X.grad, float(inner.detach())
    X = X.detach()
    assert abs(inner - float((X.real * gX.real + X.imag * gX.imag).sum())) < 1e-10 * abs(inner)
    assert (gX.imag[:, 0] == 0).all() and (gX.imag[:, -1] == 0).all()
    X2 = X.detach().requires_grad_(True)
    (gp,) = torch.autograd.grad((K2.synthesis_plain(X2, plan, plan.istft_weights) * r).sum(), X2)
    assert float((gp - gX).abs().max()) < 1e-10 * float(gp.abs().max())


def test_stft_refuses_unplannable_geometry_off_the_cpu():
    """Off the CPU (the ``meta`` device stands in for the card) an n_fft the
    kernels cannot plan raises when ``STFT`` is built: odd, n/2 with a
    prime factor above 31, or with two primes above 5.  The main path's geometries plan; on the CPU the
    plain versions take any n_fft (against torch.stft, 1e-5 of the peak)."""
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    for n_fft in (74, 511, 2 * 3 * 37, 2 * 7 * 11):
        with pytest.raises(ValueError, match="plan"):
            STFT(n_fft, 16, hann_window(n_fft), device="meta")
    for name in GEOMETRIES:
        n_fft, hop, kind, mode = GEOMETRIES[name]
        assert STFT(n_fft, hop, _window(n_fft, kind), pad_mode=mode, device="meta").plan.radices
    geom = STFT(74, 16, hann_window(74), pad_mode="constant", device="cpu")
    assert geom.plan.radices is None
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 700)).astype(np.float32))
    ref = torch.stft(x, 74, 16, window=torch.from_numpy(hann_window(74)), center=True,
                     pad_mode="constant", return_complex=True)
    ours = geom.stft(x)
    assert float((ours - ref).abs().max()) < 1e-5 * float(ref.abs().max())
