"""K4 — power-law compressed STFT loss as Triton kernels.

Replaces the XLA-fused chains of ``buddy_tpu/losses.py`` (``_compress`` :51
and the ``l2_comp_stft_*`` reductions of ``loss_fn`` :120): the compression

    C(X) = (|X| + 1e-8)^c * X / |X|,    C(0) = (1e-8)^c + 0j  (gradient 0)

and the per-utterance squared error  sum_{f,t} |A - C(X)|^2  against an
already compressed reference A.

Layout: complex64 (B, N) rows viewed as interleaved float32 (B, N, 2), one
row per utterance, N = bins * frames.

What bounds it on the H100: memory.  A few tens of FLOPs per complex
element against 16 bytes read (forward) or 24-32 bytes moved (backward), so
the least time is the bytes over 3.35 TB/s.  The eager chain it replaces
makes about ten passes over the spectrum forward and as many backward; here
the forward is one pass that compresses, subtracts, squares and reduces a
block into one partial per program (a two-level reduction without atomics,
so the sum has a fixed order), and the backward is one pass that forms
dL/dA and dL/dX from A, X and the (B,) incoming gradient.
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


@triton.jit
def comp_loss_fwd_kernel(a_ptr, x_ptr, part_ptr, N, c, zero_val, scale, BLOCK: tl.constexpr):
    """part[b, blk] = scale * sum over the block of |A - C(X)|^2."""
    b = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    pos = 2 * (b * N + offs)
    ar = tl.load(a_ptr + pos, mask=mask, other=0.0)
    ai = tl.load(a_ptr + pos + 1, mask=mask, other=0.0)
    xr = tl.load(x_ptr + pos, mask=mask, other=0.0)
    xi = tl.load(x_ptr + pos + 1, mask=mask, other=0.0)
    cr, ci = _compress(xr, xi, c, zero_val)
    dr, di = ar - cr, ai - ci
    err = tl.where(mask, dr * dr + di * di, 0.0)
    tl.store(part_ptr + b * tl.num_programs(1) + blk, scale * tl.sum(err, axis=0))


@triton.jit
def comp_loss_bwd_kernel(a_ptr, x_ptr, coef_ptr, ga_ptr, gx_ptr, N, c, zero_val,
                         BLOCK: tl.constexpr, NEED_GA: tl.constexpr, NEED_GX: tl.constexpr):
    """With coef[b] = 2 * scale * g[b]:  dL/dA = coef (A - C(X)) and dL/dX
    the pull-back of -coef (A - C(X)) through C."""
    b = tl.program_id(0).to(tl.int64)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    pos = 2 * (b * N + offs)
    coef = tl.load(coef_ptr + b)
    ar = tl.load(a_ptr + pos, mask=mask, other=0.0)
    ai = tl.load(a_ptr + pos + 1, mask=mask, other=0.0)
    xr = tl.load(x_ptr + pos, mask=mask, other=0.0)
    xi = tl.load(x_ptr + pos + 1, mask=mask, other=0.0)
    cr, ci = _compress(xr, xi, c, zero_val)
    gr, gi = coef * (ar - cr), coef * (ai - ci)
    if NEED_GA:
        tl.store(ga_ptr + pos, gr, mask=mask)
        tl.store(ga_ptr + pos + 1, gi, mask=mask)
    if NEED_GX:
        dr, di = _compress_vjp(xr, xi, -gr, -gi, c)
        tl.store(gx_ptr + pos, dr, mask=mask)
        tl.store(gx_ptr + pos + 1, di, mask=mask)
