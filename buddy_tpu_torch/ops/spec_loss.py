"""Power-law compressed STFT loss, and kernel K4 (Triton, ``csrc/spec_loss.py``).

``spec_compress(X, c)`` is the compression of ``buddy_tpu/losses.py::_compress``,

    C(X) = (|X| + 1e-8)^c * X / |X|,    C(0) = (1e-8)^c + 0j  with gradient 0,

and ``comp_loss(A, X, c, scale)`` the per-utterance error against an already
compressed reference,

    L[b] = scale * sum_{f,t} |A[b] - C(X[b])|^2,

which covers the ``sum`` (scale = weight), ``mean`` (weight / (F T)) and
``summean`` (weight / T) reductions of the ``l2_comp_stft_*`` losses.

Each has a plain PyTorch version with its explicit backward formula beside
it (the formula the backward kernels implement; torch's convention for a
real loss of a complex tensor, g = dL/dRe + i dL/dIm).  Wrappers, each
counting its launches: ``spec_compress`` / ``spec_compress_backward`` and
``comp_loss`` / ``comp_loss_backward``.  CPU tensors take the plain versions
(autograd differentiates them); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

_BLOCK = 1024
_EPS = 1e-8


# --- plain versions ---------------------------------------------------------
def _zero(X):
    return (X.real == 0) & (X.imag == 0)


def compress_plain(X: torch.Tensor, factor: float) -> torch.Tensor:
    zero = _zero(X)
    safe = torch.where(zero, torch.ones_like(X), X)
    mag = torch.abs(safe)
    return torch.where(zero, torch.full_like(X, _EPS ** factor),
                       safe * ((mag + _EPS) ** factor / mag))


def compress_backward_plain(X: torch.Tensor, gC: torch.Tensor, factor: float) -> torch.Tensor:
    """dL/dX from dL/dC:  s g + (s'/m) X Re(conj(X) g),  s = (m+eps)^c / m,
    s' = s (c/(m+eps) - 1/m);  0 where X == 0."""
    zero = _zero(X)
    safe = torch.where(zero, torch.ones_like(X), X)
    m = torch.abs(safe)
    s = (m + _EPS) ** factor / m
    k = s * (factor / (m + _EPS) - 1.0 / m) / m * (safe.real * gC.real + safe.imag * gC.imag)
    return torch.where(zero, torch.zeros_like(X), s * gC + k * safe)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def comp_loss_plain(A: torch.Tensor, X: torch.Tensor, factor: float, scale: float) -> torch.Tensor:
    d = A - compress_plain(X, factor)
    return scale * _rows(d.real ** 2 + d.imag ** 2).sum(-1)


def comp_loss_backward_plain(A, X, g, factor: float, scale: float):
    """(dL/dA, dL/dX) from the (B,) gradient g of the per-utterance loss."""
    coef = (2.0 * scale * g).reshape((-1,) + (1,) * (A.dim() - 1))
    gA = coef * (A - compress_plain(X, factor))
    return gA, compress_backward_plain(X, -gA, factor)


# --- kernel launches ----------------------------------------------------------
def _real(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.device.type != "cuda" or t.dtype != torch.complex64:
        raise ValueError(f"{what}: expected a complex64 CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return torch.view_as_real(t.resolve_conj().contiguous())


def _launch_compress(X: torch.Tensor, factor: float) -> torch.Tensor:
    from buddy_tpu_torch.csrc import spec_loss as K
    xr = _real(X, "spec_compress")
    out = torch.empty_like(xr)
    total = X.numel()
    K.compress_kernel[((total + _BLOCK - 1) // _BLOCK,)](
        xr, out, total, float(factor), float(_EPS ** factor), BLOCK=_BLOCK, num_warps=4)
    spec_compress.launches += 1
    return torch.view_as_complex(out)


def spec_compress_backward(X: torch.Tensor, gC: torch.Tensor, factor: float) -> torch.Tensor:
    """K4 compression backward wrapper: dL/dX from dL/dC(X)."""
    if X.device.type == "cpu":
        return compress_backward_plain(X, gC, factor)
    from buddy_tpu_torch.csrc import spec_loss as K
    xr, gr = _real(X, "spec_compress_backward"), _real(gC, "spec_compress_backward")
    out = torch.empty_like(xr)
    total = X.numel()
    K.compress_bwd_kernel[((total + _BLOCK - 1) // _BLOCK,)](
        xr, gr, out, total, float(factor), BLOCK=_BLOCK, num_warps=4)
    spec_compress_backward.launches += 1
    return torch.view_as_complex(out)


def _launch_loss(A: torch.Tensor, X: torch.Tensor, factor: float, scale: float) -> torch.Tensor:
    from buddy_tpu_torch.csrc import spec_loss as K
    if A.shape != X.shape or X.dim() < 2:
        raise ValueError(f"comp_loss: A {tuple(A.shape)} and X {tuple(X.shape)} differ")
    ar, xr = _real(A, "comp_loss reference"), _real(X, "comp_loss estimate")
    B, N = X.shape[0], X[0].numel()
    n_blocks = (N + _BLOCK - 1) // _BLOCK
    part = torch.empty((B, n_blocks), device=X.device, dtype=torch.float32)
    K.comp_loss_fwd_kernel[(B, n_blocks)](ar, xr, part, N, float(factor), float(_EPS ** factor),
                                          float(scale), BLOCK=_BLOCK, num_warps=4)
    comp_loss.launches += 1
    return part.sum(1)


def comp_loss_backward(A, X, g, factor: float, scale: float, need_a: bool = True,
                       need_x: bool = True):
    """K4 loss backward wrapper: (dL/dA, dL/dX) in one pass from A, X and
    the (B,) gradient g; a gradient that is not needed is None."""
    if X.device.type == "cpu":
        gA, gX = comp_loss_backward_plain(A, X, g, factor, scale)
        return (gA if need_a else None), (gX if need_x else None)
    from buddy_tpu_torch.csrc import spec_loss as K
    ar, xr = _real(A, "comp_loss_backward reference"), _real(X, "comp_loss_backward estimate")
    B, N = X.shape[0], X[0].numel()
    coef = (2.0 * scale * g).to(torch.float32).contiguous()
    ga = torch.empty_like(ar) if need_a else ar          # unused pointers stay valid
    gx = torch.empty_like(xr) if need_x else xr
    K.comp_loss_bwd_kernel[(B, (N + _BLOCK - 1) // _BLOCK)](
        ar, xr, coef, ga, gx, N, float(factor), float(_EPS ** factor),
        BLOCK=_BLOCK, NEED_GA=need_a, NEED_GX=need_x, num_warps=4)
    comp_loss_backward.launches += 1
    return (torch.view_as_complex(ga) if need_a else None,
            torch.view_as_complex(gx) if need_x else None)


class _CompressFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, factor):
        ctx.save_for_backward(X)
        ctx.factor = factor
        return _launch_compress(X, factor)

    @staticmethod
    def backward(ctx, gC):
        (X,) = ctx.saved_tensors
        return spec_compress_backward(X, gC, ctx.factor), None


class _CompLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, X, factor, scale):
        ctx.save_for_backward(A, X)
        ctx.factor, ctx.scale = factor, scale
        return _launch_loss(A, X, factor, scale)

    @staticmethod
    def backward(ctx, g):
        A, X = ctx.saved_tensors
        gA, gX = comp_loss_backward(A, X, g, ctx.factor, ctx.scale,
                                    need_a=ctx.needs_input_grad[0],
                                    need_x=ctx.needs_input_grad[1])
        return gA, gX, None, None


def spec_compress(X: torch.Tensor, factor: float) -> torch.Tensor:
    """K4 compression wrapper: complex (..., F, T) -> C(X), same shape."""
    if X.device.type == "cpu":
        return compress_plain(X, factor)
    return _CompressFn.apply(X, factor)


def comp_loss(A: torch.Tensor, X: torch.Tensor, factor: float, scale: float) -> torch.Tensor:
    """K4 loss wrapper: compressed reference A and raw estimate X, complex
    (B, F, T) -> (B,) per-utterance  scale * sum |A - C(X)|^2."""
    if X.device.type == "cpu" and A.device.type == "cpu":
        return comp_loss_plain(A, X, factor, scale)
    return _CompLossFn.apply(A, X, factor, scale)


spec_compress.launches = 0
spec_compress_backward.launches = 0
comp_loss.launches = 0
comp_loss_backward.launches = 0
