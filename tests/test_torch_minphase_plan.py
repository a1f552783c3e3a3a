"""K5's plan and a numpy model of its schedule (CPU).

The CUDA kernels of K5 (``buddy_tpu_torch/csrc/minphase.cu``) run the whole
minimum-phase chain of a row in one thread-block cluster: every transform
is a packed complex FFT of L = n/2 points (direct: a four-step FFT, L = N1
x N2: N1-point Stockham FFTs of the columns, the twiddles, N2-point direct
DFTs in the paired form of ``fft.cuh``'s odd-prime butterfly; chirp: a
Bluestein step whose circular convolution of N1 x N2 >= 2 L - 1 points
runs as two such four-step FFTs), with a gather
before it that packs the real sequence of n points from the half spectra
the cluster holds and a pass after it that splits the L + 1 bins and does
the chain's elementwise work.  ``_forward`` / ``_backward`` below run that
schedule in numpy float64 with the plan's tables (``MinPhasePlan.table64``)
and the kernels' indexing and order of passes; they are held to a
complex128 chain (1e-9 of the peak) and to the JAX package's float32
``minimum_phase_version`` and its ``jax.grad`` (2e-5 and 2e-4 of the peak).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from buddy_tpu_torch.ops.fft_plan import (BUTTERFLIES, MAX_STAGES, MINPHASE_CHIRP,
                                          MINPHASE_CLUSTER, MINPHASE_DIRECT, MINPHASE_HEADER,
                                          MINPHASE_MAX_L, MINPHASE_MAX_N1, MINPHASE_MAX_SLOTS,
                                          MinPhasePlan, cluster_layout, minphase_factors,
                                          minphase_route)

EPS = 1e-8
# rows of the main path (L = 128 (Nf + 1), Nf = 100 and 99) and of
# tests/test_torch_fused.py::test_minimum_phase_forward_backward (direct plans)
LENGTHS = [12928, 12800, 64, 33]
# rows the 128 x 128 plans could not take: a prime (chirp), Nf = 130 (direct, N2 = 131), 2 x 257 and
# 2 x 7 x 11 x 13 (chirp), Nf = 250 and 512 (direct, N2 = 251 and 513)
NEW_LENGTHS = [101, 128 * 131, 2 * 257, 7 * 11 * 13 * 2, 128 * 251, 128 * 513]
HEADER_TOP = 13                       # header fields before the radices


def _plan(L):
    return MinPhasePlan(L, device="cpu")


# --- the schedule -------------------------------------------------------------
def _column_fft(plan, z):
    """(rows, cols, N1) -> the N1-point DFT of each column through the plan's
    Stockham stages (butterfly j reads points j + r N1/R, twiddles them from
    the table, writes (j - k) R + k + q Ns, k = j mod Ns)."""
    tab, Ns, N1 = plan.table64, 1, plan.N1
    for R, to in zip(plan.radices, plan.tw_off):
        nb = N1 // R
        j = np.arange(nb)
        k = j % Ns
        v = np.stack([z[..., j + r * nb] for r in range(R)], -1)
        tw = tab[to + k[:, None] * (R - 1) + np.arange(R - 1)[None, :]]
        v = v * np.concatenate([np.ones((nb, 1)), tw], 1)
        out = v @ np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        y = np.empty_like(z)
        for q in range(R):
            y[..., (j - k) * R + k + q * Ns] = out[..., q]
        z, Ns = y, Ns * R
    return z


def _direct_dft(plan, v):
    """(rows, N1, N2) -> the N2-point DFT along the last axis in the kernel's
    paired form: a_r = v_r + v_{N2-r}, b_r = v_r - v_{N2-r} in place, then for
    q <= N2/2  c = v_0 [+ (-1)^q v_{N2/2}] + sum_r a_r Re w_rq,  s = sum_r b_r
    Im w_rq (r = 1 .. (N2-1)/2, w from the roots table), out_q = c + i s and
    out_{N2-q} = c - i s.  The sums over r are matrix products here (the
    kernel's order of terms does not show at float64)."""
    N2 = plan.N2
    roots = plan.table64[plan.roots_off:plan.roots_off + N2]
    H = (N2 - 1) // 2
    r = np.arange(1, H + 1)
    q = np.arange(N2 // 2 + 1)
    a, b = v[..., r] + v[..., N2 - r], v[..., r] - v[..., N2 - r]
    w = roots[np.outer(r, q) % N2]                                   # (H, N2/2 + 1)
    c = v[..., :1] + a @ w.real
    if N2 % 2 == 0:
        c = c + v[..., N2 // 2:N2 // 2 + 1] * (-1.0) ** q
    s = b @ w.imag
    out = np.empty_like(v)
    out[..., (N2 - q) % N2] = c - 1j * s
    out[..., q] = c + 1j * s
    return out


def _four_step(plan, z):
    """The complex FFT of N = N1 N2 points, z (rows, N): column j2 holds the
    points N2 j1 + j2; its N1-point FFT, twiddled by exp(-2 pi i j2 k1 / N),
    goes to row k1 (the owner's slot); row k1's N2-point DFT gives bin
    k1 + N1 k2."""
    N1, N2 = plan.N1, plan.N2
    cols = z.reshape(z.shape[0], N1, N2).transpose(0, 2, 1)           # [row, j2, j1]
    A = _column_fft(plan, cols)                                      # [row, j2, k1]
    A = A * plan.table64[plan.tw4_off:plan.tw4_off + N1 * N2].reshape(N2, N1)
    Z = _direct_dft(plan, A.transpose(0, 2, 1))                      # [row, k1, k2]
    return Z.transpose(0, 2, 1).reshape(z.shape[0], N1 * N2)         # bin k1 + N1 k2


def _transform(plan, z):
    """The complex FFT of L points, z (rows, L): direct, the four-step FFT of
    L; chirp, Z_f = w_f conj(E_f) with E the four-step FFT of conj(A filt)
    and A that of z_j w_j zero-padded to N (the plan's chirp and filter
    spectrum, divided by N)."""
    if plan.route == MINPHASE_DIRECT:
        return _four_step(plan, z)
    L, N = plan.L, plan.N1 * plan.N2
    w = plan.table64[plan.chirp_off:plan.chirp_off + L]
    filt = plan.table64[plan.filt_off:plan.filt_off + N]
    a = np.zeros((z.shape[0], N), complex)
    a[:, :L] = z * w
    E = _four_step(plan, np.conj(_four_step(plan, a) * filt))
    return w * np.conj(E[:, :L])


def _pack(x_of):
    """The packed input z_j = x_{2j} + i x_{2j+1} of a real sequence of n
    points, x_of(idx) its value at the indices idx in [0, n)."""
    return x_of(0) + 1j * x_of(1)


def _rfft(plan, x_of):
    """Bins 0..L of the real FFT of n = 2L points: pack, four steps, split
    X_f = (Z_f + conj Z_g)/2 - i e_f (Z_f - conj Z_g)/2, g = L - f."""
    L = plan.L
    j = np.arange(L)
    Z = _transform(plan, _pack(lambda o: x_of(2 * j + o)))
    f = np.arange(L + 1)
    e = plan.table64[plan.post_off:plan.post_off + L + 1]
    a, b = Z[:, f % L], np.conj(Z[:, (L - f) % L])
    return 0.5 * (a + b) - 0.5j * e * (a - b)


def _irfft_half(plan, Y, scale):
    """scale * ifft of the Hermitian spectrum with bins Y (rows, L + 1),
    samples 0..L-1: U_f = (Y_f + conj Y_g)/2 + i conj(e_f) (Y_f - conj Y_g)/2,
    the forward four steps on conj(U), and y_2k + i y_2k+1 = conj(R_k) / L."""
    L = plan.L
    f = np.arange(L)
    e = plan.table64[plan.post_off:plan.post_off + L]
    a, b = Y[:, f], np.conj(Y[:, L - f])
    U = 0.5 * (a + b) + 0.5j * np.conj(e) * (a - b)
    u = np.conj(_transform(plan, np.conj(U))) / L * scale
    y = np.empty((Y.shape[0], 2 * L))
    y[:, 0::2], y[:, 1::2] = u.real, u.imag
    return y[:, :L]


def _even(half, L):
    """x_idx of the even sequence of n = 2L points with bins 0..L ``half``."""
    return lambda idx: half[:, np.where(idx <= L, idx, 2 * L - idx)]


def _odd(half, L):
    return lambda idx: np.where(idx <= L, 1.0, -1.0) * half[:, np.where(idx <= L, idx, 2 * L - idx)]


def _window_lower(half, L):
    """x_idx = 2 half_idx for idx < L (the flipped Heaviside window), else 0."""
    return lambda idx: np.where(idx < L, 2.0, 0.0) * half[:, np.minimum(idx, L)]


def _forward(plan, h):
    """y (rows, L) and the saved half spectra: H (rows, L + 1) and phi."""
    L, n = plan.L, 2 * plan.L
    pad = np.concatenate([h, np.zeros_like(h)], 1)
    H = _rfft(plan, lambda idx: pad[:, idx])                      # transform 1
    m = np.abs(H)
    c = _rfft(plan, _even(np.log(m + EPS), L)).real               # 2: fft of the even log m
    phi = _rfft(plan, _window_lower(c, L)).imag / n               # 3: -Im ifft(w c)
    y = _irfft_half(plan, m * np.exp(1j * phi), 1.0)              # 4: Re ifft(m e^{i phi})
    return y, H, phi


def _backward(plan, H, phi, g):
    """dL/dh (rows, L) from the saved half spectra and g = dL/dy."""
    L, n = plan.L, 2 * plan.L
    pad = np.concatenate([g, np.zeros_like(g)], 1)
    gW = _rfft(plan, lambda idx: pad[:, idx]) / n                 # transform 1
    m = np.abs(H)
    cs, sn = np.cos(phi), np.sin(phi)                             # z_i = -phi
    g_mag = gW.real * cs + gW.imag * sn
    a = m * (gW.imag * cs - gW.real * sn)                         # gz = -i a, a odd
    q = _rfft(plan, _odd(a, L)).imag                              # 2: fft(gz) = Im fft(a)
    g_log = _rfft(plan, _window_lower(q, L)).real / n             # 3: Re ifft(w fft(gz))
    g_mag = g_mag + g_log / (m + EPS)
    zero = m == 0
    gH = np.where(zero, 0.0, g_mag * H / np.where(zero, 1.0, m))
    return _irfft_half(plan, gH, float(n))                        # 4: Re n ifft(gH)


# --- the complex128 chain and the inputs ----------------------------------------
def _inputs(L, rows=3, seed=0):
    rng = np.random.default_rng(seed + L)
    h = np.exp(-np.arange(L) / (L / 6.0)) * rng.standard_normal((rows, L))
    h[:, 0] = 2.0
    h[-1] = 0.0                                                   # a zero row: gradient 0
    return h.astype(np.float32), rng.standard_normal((rows, L)).astype(np.float32)


def _chain128(h, g):
    from buddy_tpu_torch.ops.minphase import minimum_phase_backward_plain, minimum_phase_plain
    h64, g64 = torch.from_numpy(h).double(), torch.from_numpy(g).double()
    return minimum_phase_plain(h64).numpy(), minimum_phase_backward_plain(h64, g64).numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# --- the plan -------------------------------------------------------------------
@pytest.mark.parametrize("L,factors", [(12928, (128, 101)), (12800, (128, 100)),
                                       (64, (64, 1)), (33, (3, 11)), (16384, (128, 128))])
def test_factors_plan_the_main_path_and_its_neighbours(L, factors):
    """n/2 = 128 (Nf + 1) at the shipped Nf = 100 is 128 column FFTs' worth
    of 101-point direct DFTs; Nf = 99 plans 128 x 100: the direct route, as
    before the chirp route existed."""
    assert minphase_factors(L) == factors
    assert minphase_route(L) == (MINPHASE_DIRECT,) + factors
    assert set(_plan(L).radices) <= set(BUTTERFLIES)


@pytest.mark.parametrize("L", [101, 128 * 131, 2 * 257, 7 * 11 * 13 * 2, 128 * 251, 128 * 513])
def test_plan_refuses_what_the_kernel_cannot_run(L):
    """Every row length that once raised here now plans (the name dates
    from then): a direct DFT of up to MINPHASE_MAX_N2 points where L has
    a butterfly factor that leaves one (Nf = 130, 250 and 512 at hop 128),
    else a Bluestein step of N = 128 x ceil((2L - 1) / 128) points; the
    schedule runs in float64 against the complex128 chain (1e-9 of the
    peak) and the JAX package's float32 function and its ``jax.grad`` (2e-5
    and 2e-4 of the peak)."""
    from buddy_tpu.ops.minphase import minimum_phase_version as jmin
    p = _plan(L)
    route, N1, N2 = minphase_route(L)
    assert (p.route, p.N1, p.N2) == (route, N1, N2)
    if route == MINPHASE_DIRECT:
        assert N1 * N2 == L and N1 == 128
    else:
        assert N1 == 128 and N1 * N2 >= 2 * L - 1 > N1 * (N2 - 1)
    h, g = _inputs(L)
    y_ref, d_ref = _chain128(h, g)
    y, H, phi = _forward(p, h.astype(np.float64))
    d = _backward(p, H, phi, g.astype(np.float64))
    assert _rel(y, y_ref) < 1e-9 and _rel(d, d_ref) < 1e-9
    assert not y[-1].any() and not d[-1].any()
    hj, gj = h[:-1], g[:-1]
    y, H, phi = _forward(p, hj.astype(np.float64))
    assert _rel(y, np.asarray(jax.vmap(jmin)(jnp.asarray(hj)))) < 2e-5
    jg = jax.grad(lambda x: jnp.sum(jax.vmap(jmin)(x) * jnp.asarray(gj)))(jnp.asarray(hj))
    assert _rel(_backward(p, H, phi, gj.astype(np.float64)), np.asarray(jg)) < 2e-4


@pytest.mark.parametrize("L", [0, 1, MINPHASE_MAX_L + 1, 2 * MINPHASE_MAX_L])
def test_plan_refuses_rows_outside_the_cap(L):
    """Rows shorter than 2 or longer than MINPHASE_MAX_L raise ValueError,
    naming the cap (the CUDA path raises it before any launch); the cap
    holds Nf = 512 at hop 128 and the tester's 65536-sample utterance."""
    assert MINPHASE_MAX_L >= 128 * 513
    with pytest.raises(ValueError, match=str(MINPHASE_MAX_L)):
        _plan(L)


@pytest.mark.parametrize("L", [2, 3, 7, 11, 17, 100, 127, 1000, 4097, MINPHASE_MAX_L])
def test_every_length_has_a_route_that_fits(L):
    """Lengths across the range plan, and each plan's shared memory (the
    kernel's layout, with the column buffers sharing the rows' space) fits
    in the 227 KB a CTA can have; the chirp route's convolution holds the
    linear one (N >= 2L - 1)."""
    p = _plan(L)
    FS = (p.N1 - 1) + ((p.N1 - 1) >> p.pad_shift) + 1
    ncol = -(-p.N2 // MINPHASE_CLUSTER)
    keep = 2 * ((L // 2 + MINPHASE_CLUSTER) // MINPHASE_CLUSTER) if p.route == MINPHASE_CHIRP \
        else (p.N2 + 1) * p.slots
    floats = max(4 * ncol * FS, 4 * p.N2 * p.slots) + 2 * p.N2 + keep
    assert 4 * floats <= 227 * 1024
    if p.route == MINPHASE_CHIRP:
        assert p.N1 * p.N2 >= 2 * L - 1
        assert p.scratch_floats == 4 * p.N1 * p.N2 + 2 * (L + 1)
    else:
        assert p.N1 * p.N2 == L and p.scratch_floats == 4 * (L + 1)


@pytest.mark.parametrize("n1", [128, 64, 100, 3, 2])
def test_cluster_layout_keeps_pairs_together(n1):
    """Every k1 is owned once, with N1 - k1 in the same CTA (the split's
    partner bin), in at most MINPHASE_MAX_SLOTS slots, the pairs' first
    members (k1 <= N1/2) in the first slots, as the kernel's pair loop
    reads them; the CTAs' loads differ by at most two."""
    slot, k1_of = cluster_layout(n1, MINPHASE_CLUSTER)
    assert sorted(k for ks in k1_of for k in ks) == list(range(n1))
    owner = {k: c for c, ks in enumerate(k1_of) for k in ks}
    for ks in k1_of:
        low = [k for k in ks if 2 * k <= n1]
        assert ks[:len(low)] == low
    for k in range(n1):
        assert owner[(n1 - k) % n1] == owner[k]
        assert k1_of[owner[k]][slot[k]] == k
    sizes = [len(ks) for ks in k1_of]
    assert max(sizes) <= MINPHASE_MAX_SLOTS and max(sizes) - min(sizes) <= 2


@pytest.mark.parametrize("L", [12928, 33])
def test_header_and_table_layout(L):
    """The header decodes to the plan, as csrc/minphase.cu reads it, and the
    table holds at its offsets what the kernel reads there."""
    p = _plan(L)
    h = p.header
    assert len(h) == MINPHASE_HEADER
    assert list(h[:HEADER_TOP]) == [L, p.N1, p.N2, len(p.radices), p.pad_shift,
                                    MINPHASE_CLUSTER, p.slots, p.tw4_off, p.roots_off,
                                    p.post_off, p.route, p.chirp_off, p.filt_off]
    S = len(p.radices)
    assert list(h[HEADER_TOP:HEADER_TOP + S]) == p.radices
    assert list(h[HEADER_TOP + MAX_STAGES:HEADER_TOP + MAX_STAGES + S]) == p.tw_off
    o = HEADER_TOP + 3 * MAX_STAGES
    assert list(h[o:o + p.N1]) == p.slot
    k1_of = h[o + MINPHASE_MAX_N1:].reshape(MINPHASE_CLUSTER, MINPHASE_MAX_SLOTS)
    for c, ks in enumerate(p.k1_of):
        assert list(k1_of[c, :len(ks)]) == ks and (k1_of[c, len(ks):] == -1).all()
    t = p.table64
    j2, k1 = 7 % p.N2, 5 % p.N1
    assert np.isclose(t[p.tw4_off + j2 * p.N1 + k1], np.exp(-2j * np.pi * j2 * k1 / L))
    assert np.isclose(t[p.roots_off + 1], np.exp(-2j * np.pi / p.N2))
    assert np.isclose(t[p.post_off + L], -1.0) and len(t) == p.post_off + L + 1
    assert np.array_equal(p.table.numpy().view(np.complex64), t.astype(np.complex64))


# --- the schedule against the chain -------------------------------------------------
@pytest.mark.parametrize("L", LENGTHS)
def test_schedule_against_complex128_chain(L):
    """The kernel's schedule in float64 against the chain in complex128
    (torch.fft): forward and backward to 1e-9 of the peak; the zero row's
    output and gradient are 0."""
    p = _plan(L)
    h, g = _inputs(L)
    y_ref, d_ref = _chain128(h, g)
    y, H, phi = _forward(p, h.astype(np.float64))
    assert _rel(y, y_ref) < 1e-9
    d = _backward(p, H, phi, g.astype(np.float64))
    assert _rel(d, d_ref) < 1e-9
    assert not y[-1].any() and not d[-1].any()
    # the half spectra hold the chain's structure: phi is 0 at DC and Nyquist
    assert np.abs(phi[:, [0, L]]).max() == 0.0


@pytest.mark.parametrize("L", LENGTHS)
def test_schedule_against_jax(L):
    """Against the JAX package's float32 ``minimum_phase_version`` (forward,
    2e-5 of the peak) and its ``jax.grad`` (2e-4), on the CPU."""
    from buddy_tpu.ops.minphase import minimum_phase_version as jmin
    p = _plan(L)
    h, g = _inputs(L, seed=1)
    y, H, phi = _forward(p, h.astype(np.float64))
    assert _rel(y, np.asarray(jax.vmap(jmin)(jnp.asarray(h)))) < 2e-5
    jg = jax.grad(lambda x: jnp.sum(jax.vmap(jmin)(x) * jnp.asarray(g)))(jnp.asarray(h))
    d = _backward(p, H, phi, g.astype(np.float64))
    assert _rel(d[:-1], np.asarray(jg)[:-1]) < 2e-4
