"""K4's compression — the power-law compressed STFT as Triton kernels.

Replaces the XLA-fused chain of ``buddy_tpu/losses.py::_compress`` (:51):

    C(X) = (|X| + 1e-8)^c * X / |X|,    C(0) = (1e-8)^c + 0j  (gradient 0),

forward and vjp.  (The loss over it, ``loss_fn`` :120, is the CUDA pair of
``csrc/spec_loss.cu``.)

Layout: complex64 viewed as interleaved float32 (..., 2), one flat pass.

What bounds it on the H100: memory.  A few tens of FLOPs per complex
element against 16 bytes moved (forward) or 24 (backward), so the least
time is the bytes over 3.35 TB/s; each direction is one elementwise pass.
"""

import triton
import triton.language as tl


@triton.jit
def _hypot(re, im):
    """|re + i im| without underflow of the squares; 0 at the zero bin."""
    ar, ai = tl.abs(re), tl.abs(im)
    mx = tl.maximum(ar, ai)
    safe = tl.where(mx == 0.0, 1.0, mx)
    r, i = ar / safe, ai / safe
    return mx * tl.sqrt(r * r + i * i)


@triton.jit
def _scale(mag, c):
    """s(m) = (m + 1e-8)^c / m for m > 0 (callers mask the zero bin)."""
    return tl.exp(c * tl.log(mag + 1e-8)) / mag


@triton.jit
def _compress(re, im, c, zero_val):
    zero = (re == 0.0) & (im == 0.0)
    mag = tl.where(zero, 1.0, _hypot(re, im))
    s = _scale(mag, c)
    return tl.where(zero, zero_val, re * s), tl.where(zero, 0.0, im * s)


@triton.jit
def _compress_vjp(re, im, gr, gi, c):
    """Gradient of a real loss w.r.t. X through C(X), torch's convention
    (g = dL/dRe + i dL/dIm):  s g + (s'/m) X Re(conj(X) g), 0 at X == 0,
    with s' = s (c/(m + 1e-8) - 1/m)."""
    zero = (re == 0.0) & (im == 0.0)
    mag = tl.where(zero, 1.0, _hypot(re, im))
    s = _scale(mag, c)
    k = s * (c / (mag + 1e-8) - 1.0 / mag) / mag * (re * gr + im * gi)
    return tl.where(zero, 0.0, s * gr + k * re), tl.where(zero, 0.0, s * gi + k * im)


@triton.jit
def compress_kernel(x_ptr, out_ptr, total, c, zero_val, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(x_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(x_ptr + 2 * offs + 1, mask=mask, other=0.0)
    cr, ci = _compress(re, im, c, zero_val)
    tl.store(out_ptr + 2 * offs, cr, mask=mask)
    tl.store(out_ptr + 2 * offs + 1, ci, mask=mask)


@triton.jit
def compress_bwd_kernel(x_ptr, g_ptr, out_ptr, total, c, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < total
    re = tl.load(x_ptr + 2 * offs, mask=mask, other=0.0)
    im = tl.load(x_ptr + 2 * offs + 1, mask=mask, other=0.0)
    gr = tl.load(g_ptr + 2 * offs, mask=mask, other=0.0)
    gi = tl.load(g_ptr + 2 * offs + 1, mask=mask, other=0.0)
    dr, di = _compress_vjp(re, im, gr, gi, c)
    tl.store(out_ptr + 2 * offs, dr, mask=mask)
    tl.store(out_ptr + 2 * offs + 1, di, mask=mask)
