"""K5 — the elementwise passes of the minimum-phase projection as Triton kernels.

Replaces the XLA-fused chain of ``buddy_tpu/ops/minphase.py::
minimum_phase_version`` (:38; with ``hilbert`` :27) between its four FFTs:

    H = fft(h, n)               n = 2 L, h real (N, L)
    l = log(|H| + 1e-8)                              logmag_kernel
    z = ifft(w * fft(l))        w the flipped Heaviside window
                                                     window_kernel
    W = |H| * exp(-i Im z)                           phasor_kernel
    out = Re(ifft(W))[:, :L]                         real_crop_kernel

and the same chain backwards (``phasor_bwd_kernel``, ``window_kernel``,
``mag_bwd_kernel``, ``real_crop_kernel``).  The FFTs stay ``torch.fft``
(cuFFT), as the JAX package computes them outside any kernel.

Layout: complex64 (N, n) rows as interleaved float32; every kernel is a flat
elementwise pass over N * n (or N * L) elements.

What bounds it on the H100: memory, and at the main path's size (8 x 25856
complex, 1.7 MB a pass) really the launch: each pass is about a
microsecond of traffic.  The design therefore fuses everything between two
FFTs into one launch (the eager chain needs three to five), recomputes |H|
from H instead of storing it, and folds the 1/n of the inverse transforms'
adjoints into the passes.
"""

import triton
import triton.language as tl

from buddy_tpu_torch.csrc.spec_loss import _hypot


@triton.jit
def logmag_kernel(h_ptr, out_ptr, total, BLOCK: tl.constexpr):
    """out = log(|H| + 1e-8), real."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(h_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(h_ptr + 2 * offs + 1, mask=mask, other=0.0)
    tl.store(out_ptr + offs, tl.log(_hypot(re, im) + 1e-8), mask=mask)


@triton.jit
def window_kernel(u_ptr, w_ptr, v_ptr, total, n, BLOCK: tl.constexpr):
    """V = w[k] * U along each row of n."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    w = tl.load(w_ptr + offs % n, mask=mask, other=0.0)
    re = tl.load(u_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(u_ptr + 2 * offs + 1, mask=mask, other=0.0)
    tl.store(v_ptr + 2 * offs, w * re, mask=mask)
    tl.store(v_ptr + 2 * offs + 1, w * im, mask=mask)


@triton.jit
def phasor_kernel(h_ptr, z_ptr, out_ptr, total, BLOCK: tl.constexpr):
    """W = |H| * exp(-i Im z)."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(h_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(h_ptr + 2 * offs + 1, mask=mask, other=0.0)
    zi = tl.load(z_ptr + 2 * offs + 1, mask=mask, other=0.0)
    mag = _hypot(re, im)
    tl.store(out_ptr + 2 * offs, mag * tl.cos(zi), mask=mask)
    tl.store(out_ptr + 2 * offs + 1, -mag * tl.sin(zi), mask=mask)


@triton.jit
def real_crop_kernel(w_ptr, out_ptr, total, n, L, BLOCK: tl.constexpr):
    """out[r, t] = Re w[r, t] for t < L."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    src = (offs // L) * n + offs % L
    tl.store(out_ptr + offs, tl.load(w_ptr + 2 * src, mask=mask, other=0.0), mask=mask)


@triton.jit
def phasor_bwd_kernel(h_ptr, z_ptr, gw_ptr, gz_ptr, gmag_ptr, total, inv_n,
                      BLOCK: tl.constexpr):
    """From gW = inv_n * gw (torch's convention): the gradient of the final
    product w.r.t. |H| (real, kept for ``mag_bwd_kernel``) and w.r.t. z
    (purely imaginary: only Im z is used)."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(h_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(h_ptr + 2 * offs + 1, mask=mask, other=0.0)
    zi = tl.load(z_ptr + 2 * offs + 1, mask=mask, other=0.0)
    gr = tl.load(gw_ptr + 2 * offs, mask=mask, other=0.0) * inv_n
    gi = tl.load(gw_ptr + 2 * offs + 1, mask=mask, other=0.0) * inv_n
    mag = _hypot(re, im)
    c, s = tl.cos(zi), tl.sin(zi)
    tl.store(gmag_ptr + offs, gr * c - gi * s, mask=mask)
    tl.store(gz_ptr + 2 * offs, tl.zeros_like(gr), mask=mask)
    tl.store(gz_ptr + 2 * offs + 1, -mag * (gr * s + gi * c), mask=mask)


@triton.jit
def mag_bwd_kernel(h_ptr, gmag_ptr, y_ptr, gh_ptr, total, BLOCK: tl.constexpr):
    """gH = (gmag + Re(y) / (|H| + 1e-8)) * H / |H|, 0 where H == 0: both
    uses of |H| (the final product and the log branch, whose gradient
    arrives as Re y) pulled back to H."""
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(h_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(h_ptr + 2 * offs + 1, mask=mask, other=0.0)
    gm = tl.load(gmag_ptr + offs, mask=mask, other=0.0)
    gl = tl.load(y_ptr + 2 * offs, mask=mask, other=0.0)
    mag = _hypot(re, im)
    zero = mag == 0.0
    g = (gm + gl / (mag + 1e-8)) / tl.where(zero, 1.0, mag)
    tl.store(gh_ptr + 2 * offs, tl.where(zero, 0.0, g * re), mask=mask)
    tl.store(gh_ptr + 2 * offs + 1, tl.where(zero, 0.0, g * im), mask=mask)
