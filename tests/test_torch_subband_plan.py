"""K3's FFT plan and its FFT-route plain versions (CPU).

The CUDA kernel of K3 (``buddy_tpu_torch/csrc/subband_conv.cu``) runs every
entry point as a circular product of two rows of n = ``conv_fft_size(T, Nf)``
points through a ``ConvFftPlan``: Stockham stages, twiddles and direct-DFT
roots built on the host.  ``_plan_fft`` runs that plan in numpy float32,
stage by stage with the kernel's indexing, against ``np.fft``; the inverse is
the forward stages on the conjugate, as in the kernel.  The FFT-route plain
versions (what the CPU runs and the kernel mirrors, with and without the
hoisted frame spectrum) are held to the direct sums, and ``frame_fft`` with
``degradation(X=, Xf=)`` to the JAX package's.  Tolerances: 1e-5 of the
peak (float32 FFTs of at most 640 points against float32 direct sums or
against JAX's FFTs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import jax_compose, op_hp, rel_err, torch_compose

MAX_STAGES = 12
CONV_SHAPES = {   # (T, Nf): n and radices
    "main path, 517 frames": (517, 100, 640, [8, 8, 2, 5]),
    "3 * 2^6": (78, 100, 192, [8, 8, 3]),
    "RIR excitation, a radix-7 DFT": (109, 100, 224, [8, 4, 7]),
    "a radix-17 DFT": (37, 100, 136, [8, 17]),
}


def _plan_fft(plan, z):
    """The forward DFT of each row of z (complex64, length n) through the
    plan's Stockham stages as the kernel runs them: butterfly j reads points
    j + r n/R, twiddles them from the table, and writes (j - k) R + k + q Ns
    with k = j mod Ns."""
    from buddy_tpu_torch.ops.fft_plan import DIRECT_PRIMES
    tab = plan.table.numpy().view(np.complex64)
    h = plan.header
    n, S = int(h[0]), int(h[1])
    radices = h[3:3 + S]
    tw_off = h[3 + MAX_STAGES:3 + MAX_STAGES + S]
    root_off = h[3 + 2 * MAX_STAGES:3 + 2 * MAX_STAGES + S]
    Ns = 1
    for R, to, ro in zip(radices, tw_off, root_off):
        R, nb = int(R), n // int(R)
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


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("name", sorted(CONV_SHAPES))
def test_conv_fft_size_and_plan(name):
    """The transform length K3 picks and the plan's stages, run in numpy
    float32, against np.fft.fft and np.fft.ifft (the inverse as the
    conjugate of the forward stages on the conjugate, over n)."""
    from buddy_tpu_torch.ops.fft_plan import ConvFftPlan, conv_fft_size
    T, Nf, n, radices = CONV_SHAPES[name]
    assert conv_fft_size(T, Nf) == n >= T + Nf - 1
    plan = ConvFftPlan(n, device="cpu")
    assert plan.radices == radices and int(plan.header[0]) == n
    z = _cplx(np.random.default_rng(n), 5, n)
    ref = np.fft.fft(z.astype(np.complex128))
    assert np.abs(_plan_fft(plan, z) - ref).max() < 1e-5 * np.abs(ref).max()
    inv = np.conj(_plan_fft(plan, np.conj(z))) / n
    ref_inv = np.fft.ifft(z.astype(np.complex128))
    assert np.abs(inv - ref_inv).max() < 1e-5 * np.abs(ref_inv).max()


def test_conv_fft_size_is_the_cheapest_plannable_length():
    """conv_fft_size never picks a length without a plan, never one below
    the linear convolution's, and prefers 640 = 8 8 2 5 to the smaller
    625 = 5^4 (four radix-5 passes) and 620 = 4 5 31 (a 31-point DFT)."""
    from buddy_tpu_torch.ops.fft_plan import conv_fft_size, fft_cost, fft_radices
    for T in range(1, 700, 7):
        n = conv_fft_size(T, 100)
        assert n >= T + 99 and fft_radices(n) is not None
    assert fft_cost(640) < fft_cost(625) < fft_cost(620)


def _smem_wavefronts(n, shift, threads=256):
    """Shared-memory wavefronts of one pass of the kernels' stages over the
    frames of a CTA of ``threads``, with frames padded by ``shift``: every
    warp's 8-byte loads and stores, a wavefront per half-warp for each
    address sharing a bank with another (a model of the bank conflicts)."""
    from buddy_tpu_torch.ops.fft_plan import fft_radices
    padded = lambda i: i + (i >> shift)
    FS = padded(n - 1) + 1
    total, Ns = 0, 1

    def cost(addresses):
        waves = 0
        for h in range(0, len(addresses), 16):
            banks = {}
            for a in set(addresses[h:h + 16]):
                for b in (2 * a % 32, (2 * a + 1) % 32):
                    banks.setdefault(b, set()).add(a)
            waves += max(len(v) for v in banks.values())
        return waves

    for R in fft_radices(n):
        nb = n // R
        lanes = [(t // nb, t % nb) for t in range(threads // nb * nb)] if nb < threads else \
            [(0, t) for t in range(threads)]
        for w in range(0, len(lanes), 32):
            warp = lanes[w:w + 32]
            for r in range(R):
                total += cost([fr * FS + padded(j + r * nb) for fr, j in warp])
                total += cost([fr * FS + padded((j - j % Ns) * R + j % Ns + r * Ns)
                               for fr, j in warp])
        Ns *= R
    return total


@pytest.mark.parametrize("m", [512, 256, 255, 640])
def test_pad_shift_rule_agrees_with_the_bank_conflict_model(m):
    """At the frame lengths the kernels run (K2's halves of 1024, 512 and
    510; K3's 640), pad_shift's rule is the shift of fewest modelled
    wavefronts among none and one float2 in 4, 8, 16 or 32."""
    from buddy_tpu_torch.ops.fft_plan import pad_shift
    waves = {shift: _smem_wavefronts(m, shift) for shift in (4, 30, 5, 3, 2)}
    assert waves[pad_shift(m)] == min(waves.values())


CASES = [  # (T, Nf, pre, batch of X, batch of H)
    (37, 100, 1, 2, 2), (78, 100, 1, 1, 3), (20, 5, 2, 2, 1), (109, 100, 0, 2, 2)]


@pytest.mark.parametrize("T,Nf,pre,bx,bh", CASES)
def test_fft_route_plain_against_direct_sums(T, Nf, pre, bx, bh):
    """Forward, adjoint and filter gradient by the kernel's FFT route, with
    and without the hoisted frame spectrum, against the direct sums (1e-5
    of the peak), batch-1 operands broadcast."""
    from buddy_tpu_torch.ops import subband_conv as K3
    rng = np.random.default_rng(T + Nf)
    F, B = 3, max(bx, bh)
    X, H, G = (torch.from_numpy(_cplx(rng, *s)) for s in ((bx, F, T), (bh, F, Nf), (B, F, T)))
    Xf = K3.frame_spectrum(X, Nf)
    assert Xf.shape == (bx, F, K3.conv_fft_size(T, Nf))
    Xb, Hb = X.expand(B, F, T), H.expand(B, F, Nf)
    ref = K3.subband_conv_plain(X, H, pre)
    for Y in (K3.subband_conv_fft_plain(X, H, pre), K3.subband_conv_fft_plain(X, H, pre, Xf)):
        assert rel_err(Y.numpy(), ref.numpy()) < 1e-5
    ref = K3.subband_conv_adjoint_plain(G, Hb, pre)
    assert rel_err(K3.subband_conv_adjoint_fft_plain(G, H, pre).numpy(), ref.numpy()) < 1e-5
    ref = K3.subband_conv_filter_grad_plain(G, Xb, Nf, pre)
    for dH in (K3.subband_conv_filter_grad_fft_plain(G, X, Nf, pre),
               K3.subband_conv_filter_grad_fft_plain(G, X, Nf, pre, Xf)):
        assert rel_err(dH.numpy(), ref.numpy()) < 1e-5


@pytest.mark.parametrize("hoisted", [False, True])
def test_subband_conv_autograd(hoisted):
    """The wrapper's gradients (the adjoint and filter-gradient formulas,
    the hoisted spectrum for dH) against autograd of the direct sum, with a
    batch-1 signal shared by three filters (1e-5 of the peak)."""
    from buddy_tpu_torch.ops import subband_conv as K3
    rng = np.random.default_rng(11)
    T, Nf, pre = 57, 100, 1
    X = torch.from_numpy(_cplx(rng, 1, 4, T)).requires_grad_(True)
    H = torch.from_numpy(_cplx(rng, 3, 4, Nf)).requires_grad_(True)
    G = torch.from_numpy(_cplx(rng, 3, 4, T))
    Xf = K3.frame_spectrum(X.detach(), Nf) if hoisted else None
    Y = K3.subband_conv(X, H, pre, Xf)
    dX, dH = torch.autograd.grad(Y, (X, H), G)
    Yr = K3.subband_conv_plain(X, H, pre)
    dXr, dHr = torch.autograd.grad(Yr, (X, H), G)
    assert rel_err(Y.detach().numpy(), Yr.detach().numpy()) < 1e-5
    assert rel_err(dX.numpy(), dXr.numpy()) < 1e-5
    assert rel_err(dH.numpy(), dHr.numpy()) < 1e-5


def test_frame_fft_and_degradation_against_jax():
    """frame_fft + degradation(X=, Xf=) of the port against the JAX
    package's with its own Xf, values and the gradient w.r.t. H of a
    quadratic loss (1e-5 of the peak)."""
    from buddy_tpu.operators.subband import SubbandFiltering as JSub
    from buddy_tpu_torch.operators.subband import SubbandFiltering
    cfg = ["tester=blind_dereverberation_BUDDy"]
    jop = JSub(op_hp(jax_compose(cfg)), sample_rate=16000)
    top = SubbandFiltering(op_hp(torch_compose(cfg)), sample_rate=16000, device="cpu")
    rng = np.random.default_rng(7)
    N = 8192
    x = (rng.standard_normal((2, N)) * 0.1).astype(np.float32)
    H = _cplx(rng, 2, 513, top.Nf) * 0.1
    jX = jop.apply_stft(jnp.asarray(x))
    jf = lambda h: jop.degradation(None, H=h, X=jX, Xf=jop.frame_fft(jX), length=N)
    y_ref, vjp = jax.vjp(jf, jnp.asarray(H))
    (g_ref,) = vjp(jnp.ones_like(y_ref))

    X = top.apply_stft(torch.from_numpy(x))
    Xf = top.frame_fft(X)
    Ht = torch.from_numpy(H).requires_grad_(True)
    y = top.degradation(None, H=Ht, X=X, Xf=Xf, length=N)
    assert rel_err(y.detach().numpy(), np.asarray(y_ref)) < 1e-5
    assert rel_err(y.detach().numpy(),
                   top.degradation(None, H=Ht, X=X, length=N).detach().numpy()) < 1e-5
    (g,) = torch.autograd.grad(y.sum(), Ht)
    # JAX's cotangent of a complex input is the conjugate of torch's
    assert rel_err(g.numpy(), np.conj(np.asarray(g_ref))) < 1e-5


def test_wrappers_refuse_cpu_fallback_for_other_devices():
    """frame_spectrum and the two backward wrappers take their plain
    versions only for CPU tensors; a tensor on another device reaches the
    kernel path, which raises here."""
    from buddy_tpu_torch.ops import subband_conv as K3
    meta = lambda *s: torch.empty(s, dtype=torch.complex64, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        K3.frame_spectrum(meta(1, 3, 5), 2)
    with pytest.raises((ValueError, RuntimeError)):
        K3.subband_conv_adjoint(meta(1, 3, 5), meta(1, 3, 2), 1)
    with pytest.raises((ValueError, RuntimeError)):
        K3.subband_conv_filter_grad(meta(1, 3, 5), meta(1, 3, 5), 2, 1)
