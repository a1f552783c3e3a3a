"""K2's FFT plan and the adjoint pair of its plain versions (CPU).

The CUDA kernels of K2 (``buddy_tpu_torch/csrc/stft.cu``) read a plan that
``StftPlan`` builds on the host: the radices of the packed complex FFT, the
Stockham twiddles, the direct-DFT roots and the post-twiddles of the real
split, or, on the chirp route (every other n_fft up to 8192), the stages of
a Bluestein step's convolution, its chirp and its two filters' spectra.
``_plan_rfft`` / ``_plan_synthesis`` below run the packed plan in numpy
float32, stage by stage with the kernels' indexing, ``_chirp_rfft`` /
``_chirp_synthesis`` the chirp plan's stages in float64 with its complex64
tables, and both are held against ``np.fft``: the tables are checked here
before they reach the card.  The
adjoint tests hold the autograd functions' backward passes (the other
kernel, with per-bin weights) to the forward passes on the CPU path.
"""

import importlib

import numpy as np
import pytest
import torch

from test_torch_signal import GEOMETRIES, _geometry, _window

MAX_STAGES = 12


def _plan(n_fft, window=None):
    from buddy_tpu_torch.ops.stft import StftPlan, hann_window
    return StftPlan(n_fft, 128, hann_window(n_fft) if window is None else window, device="cpu")


def _stages(plan, z, dtype=np.complex64):
    """The forward DFT of each row of z (complex64, length n_fft/2) through
    the plan's Stockham stages, as the kernels run them: butterfly j reads
    points j + r M/R, twiddles them from the table, and writes (j - k) R + k
    + q Ns with k = j mod Ns."""
    from buddy_tpu_torch.ops.stft import DIRECT_PRIMES
    tab = plan.table.numpy().view(np.complex64).astype(dtype)
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
            np.exp(-2j * np.pi * qr / R).astype(dtype)                         # butterflies: exact constants
        out = (v @ W).astype(dtype)
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


def _chirp_rfft(plan, x):
    """(rows, support) windowed frames -> (rows, F) through the chirp route:
    a_s = x_s w_s, A = stages(a), E = stages(conj(A B_a)), X_f = w_f conj(E_f)."""
    tab = plan.table.numpy().view(np.complex64).astype(np.complex128)
    M, S, F_ = plan.M, plan.support, plan.n_bins
    w = tab[plan.chirp_off:plan.chirp_off + max(S, F_)]
    a = np.zeros((x.shape[0], M), np.complex128)
    a[:, :S] = x * w[:S]
    A = _stages(plan, a, np.complex128)
    E = _stages(plan, np.conj(A * tab[plan.ba_off:plan.ba_off + M]), np.complex128)
    return w[:F_] * np.conj(E[:, :F_])


def _chirp_synthesis(plan, X, wts):
    """(rows, F) -> (rows, support): sum_f wts_f Re(X_f e^{2 pi i f s / n})
    through the chirp route: a_f = conj(wts_f X_f) w_f, the synthesis
    filter, y_s = Re(w_s conj(E_s))."""
    tab = plan.table.numpy().view(np.complex64).astype(np.complex128)
    M, S, F_ = plan.M, plan.support, plan.n_bins
    w = tab[plan.chirp_off:plan.chirp_off + max(S, F_)]
    a = np.zeros((X.shape[0], M), np.complex128)
    a[:, :F_] = np.conj(X * wts) * w[:F_]
    A = _stages(plan, a, np.complex128)
    E = _stages(plan, np.conj(A * tab[plan.bs_off:plan.bs_off + M]), np.complex128)
    return (w[:S] * np.conj(E[:, :S])).real


def _check_chirp_plan(n_fft, hop):
    """The chirp plan of n_fft: its route and convolution length, its
    stages against np.fft.rfft (1e-6 of the peak: complex64 tables in float64
    arithmetic), its synthesis against np.fft's inverse with the ISTFT's
    weights, and the round trip: the synthesis of the analysis of a frame
    is the frame times the window squared."""
    from buddy_tpu_torch.ops.stft import CHIRP, STFT, hann_window
    from buddy_tpu_torch.ops.fft_plan import butterfly_radices
    plan = STFT(n_fft, hop, hann_window(n_fft), pad_mode="constant", device="meta").plan
    assert plan.route == CHIRP and plan.header[7 + 3 * MAX_STAGES] == CHIRP
    assert plan.M >= plan.support + plan.n_bins - 1 and butterfly_radices(plan.M) == plan.radices
    assert plan.table.device.type == "meta"
    plan = _plan(n_fft)                       # the same tables, on the CPU to read them
    rng = np.random.default_rng(n_fft)
    win = hann_window(n_fft).astype(np.float64)[:plan.support]
    x = rng.standard_normal((4, plan.support))
    X = _chirp_rfft(plan, x * win)
    ref = np.fft.rfft(x * win, n=n_fft)
    assert np.abs(X - ref).max() < 1e-6 * np.abs(ref).max()
    wts = plan.istft_weights.numpy().astype(np.float64)
    Xr = ref + 1j * rng.standard_normal(ref.shape)
    y = _chirp_synthesis(plan, Xr, wts)
    Xh = Xr.copy()
    Xh[:, 0] = Xh[:, 0].real
    if n_fft % 2 == 0:
        Xh[:, -1] = Xh[:, -1].real
    y_ref = np.fft.irfft(Xh, n=n_fft)[:, :plan.support]
    assert np.abs(y - y_ref).max() < 1e-6 * np.abs(y_ref).max()
    back = _chirp_synthesis(plan, X, wts) * win
    assert np.abs(back - x * win ** 2).max() < 1e-6 * np.abs(x * win ** 2).max()


@pytest.mark.parametrize("n_fft,hop", [(2, 1), (3, 1), (75, 16), (101, 32), (8190, 2048),
                                       (8191, 2048)])
def test_chirp_route_plans_every_length_to_the_cap(n_fft, hop):
    """The chirp route at the smallest lengths, odd ones, and the longest
    (8190 = 2 3 3 5 7 13 has two primes above 5, 8191 is prime: M = 12288,
    whose two buffers fit in shared memory); above 8192 nothing plans."""
    _check_chirp_plan(n_fft, hop)


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
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
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
    """The n_fft the packed route alone refused off the CPU (odd, n/2 with a
    prime factor above 31, or with two primes above 5; the name dates from
    then) now plan on the ``meta`` device, which stands in for the card,
    on the chirp route, whose stages match np.fft and round-trip
    (``_check_chirp_plan``); above 8192 ``STFT`` raises, naming the cap.
    The main path's geometries keep the packed route; on the CPU the plain
    versions take any n_fft (against torch.stft, 1e-5 of the peak)."""
    from buddy_tpu_torch.ops.stft import CHIRP, MAX_N_FFT, PACKED, STFT, hann_window
    for n_fft in (74, 511, 2 * 3 * 37, 2 * 7 * 11):
        _check_chirp_plan(n_fft, 16)
    for n_fft in (MAX_N_FFT + 1, 2 * MAX_N_FFT):
        with pytest.raises(ValueError, match=str(MAX_N_FFT)):
            STFT(n_fft, 16, hann_window(n_fft), device="meta")
    for name in GEOMETRIES:
        n_fft, hop, kind, mode = GEOMETRIES[name]
        plan = STFT(n_fft, hop, _window(n_fft, kind), pad_mode=mode, device="meta").plan
        assert plan.route == PACKED and plan.radices
    geom = STFT(74, 16, hann_window(74), pad_mode="constant", device="cpu")
    assert geom.plan.route == CHIRP
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 700)).astype(np.float32))
    ref = torch.stft(x, 74, 16, window=torch.from_numpy(hann_window(74)), center=True,
                     pad_mode="constant", return_complex=True)
    ours = geom.stft(x)
    assert float((ours - ref).abs().max()) < 1e-5 * float(ref.abs().max())
