"""Subband frame convolution, and kernel K3 (CUDA, ``csrc/subband_conv.cu``).

    Y[b, f, t] = sum_{j < Nf} H[b, f, j] * X[b, f, t + pre - j]

with zeros outside [0, T): one complex FIR along the STFT frame axis per
(utterance, frequency bin) — ``buddy_tpu/operators/subband.py::
SubbandFiltering.subband_filtering``, which the TPU computes with
overlap-save matmul DFTs.  Either operand may have batch 1 and is then
shared by every utterance.

Every entry point is a circular product of two rows of n = ``conv_fft_size(T,
Nf)`` points: the forward ifft(fft(H) fft(X)) read from offset pre, the
adjoint ifft(fft(G') conj(fft(H))) and the filter gradient ifft(fft(G')
conj(fft(X))) with G' = G placed at offset pre.  ``frame_spectrum`` is
fft(X) at that length, which the blind inner loop computes once per
diffusion step and hands to the forward and the filter gradient (``Xf``).

Wrappers, each counting its launches: ``subband_conv`` (forward),
``subband_conv_adjoint`` (dX), ``subband_conv_filter_grad`` (dH) and
``frame_spectrum``.  The two backward kernels follow torch's
complex-gradient convention.  CPU tensors take the plain FFT-route versions
(``*_fft_plain``, ``torch.fft``), which the kernels mirror; CUDA tensors
launch the kernels or raise.  The direct sums (``*_plain``) are the
reference both are held to.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build
from buddy_tpu_torch.ops.fft_plan import ConvFftPlan, conv_fft_size

_SIGNATURES = {
    "subband_fft_conv": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}
_plans: dict = {}


# ---------------------------------------------------------------------------
# plain versions: the direct sums (the reference) and the FFT route
# ---------------------------------------------------------------------------
def _frames(X: torch.Tensor, Nf: int, pre: int) -> torch.Tensor:
    """(B, F, T) -> (B, F, T, Nf) with [..., t, k] = X[..., t + pre - (Nf-1-k)]."""
    return F.pad(X, (Nf - 1 - pre, pre)).unfold(-1, Nf, 1)


def subband_conv_plain(X: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """Plain direct FIR: (Bx, F, T), (Bh, F, Nf) complex -> (B, F, T)."""
    return torch.einsum("bftk,bfk->bft", _frames(X, H.shape[-1], pre), H.flip(-1))


def subband_conv_adjoint_plain(G: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """dX[b, f, s] = sum_j conj(H[b, f, j]) G[b, f, s - pre + j] (per utterance)."""
    Nf = H.shape[-1]
    win = F.pad(G, (pre, Nf - 1 - pre)).unfold(-1, Nf, 1)          # [s, j] = G[s - pre + j]
    return torch.einsum("bfsj,bfj->bfs", win, H.conj())


def subband_conv_filter_grad_plain(G: torch.Tensor, X: torch.Tensor, Nf: int,
                                   pre: int) -> torch.Tensor:
    """dH[b, f, j] = sum_t G[b, f, t] conj(X[b, f, t + pre - j]) (per utterance)."""
    return torch.einsum("bft,bftk->bfk", G, _frames(X, Nf, pre).conj()).flip(-1)


def frame_spectrum_plain(X: torch.Tensor, Nf: int) -> torch.Tensor:
    """(B, F, T) -> (B, F, n): fft of each row zero-padded to n =
    conv_fft_size(T, Nf)."""
    return torch.fft.fft(X, n=conv_fft_size(X.shape[-1], Nf))


def _placed(G: torch.Tensor, pre: int, n: int) -> torch.Tensor:
    """G at offset pre of rows of n."""
    return F.pad(G, (pre, n - pre - G.shape[-1]))


def subband_conv_fft_plain(X: torch.Tensor, H: torch.Tensor, pre: int,
                           Xf: torch.Tensor | None = None) -> torch.Tensor:
    """The forward by the kernel's route: ifft(fft(H) * Xf)[pre : pre + T],
    Xf = fft(X) at n = conv_fft_size(T, Nf) unless given."""
    T, Nf = X.shape[-1], H.shape[-1]
    n = conv_fft_size(T, Nf)
    Xf = torch.fft.fft(X, n=n) if Xf is None else Xf
    return torch.fft.ifft(torch.fft.fft(H, n=n) * Xf)[..., pre:pre + T]


def subband_conv_adjoint_fft_plain(G: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """The adjoint by the kernel's route: ifft(fft(G') conj(fft(H)))[:T]."""
    T, Nf = G.shape[-1], H.shape[-1]
    n = conv_fft_size(T, Nf)
    return torch.fft.ifft(torch.fft.fft(_placed(G, pre, n)) * torch.fft.fft(H, n=n).conj())[..., :T]


def subband_conv_filter_grad_fft_plain(G: torch.Tensor, X: torch.Tensor, Nf: int, pre: int,
                                       Xf: torch.Tensor | None = None) -> torch.Tensor:
    """The filter gradient by the kernel's route: ifft(fft(G') conj(Xf))[:Nf]."""
    T = G.shape[-1]
    n = conv_fft_size(T, Nf)
    Xf = torch.fft.fft(X, n=n) if Xf is None else Xf
    return torch.fft.ifft(torch.fft.fft(_placed(G, pre, n)) * Xf.conj())[..., :Nf]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
def _plan(n: int, device) -> ConvFftPlan:
    key = (n, device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = ConvFftPlan(n, device)
    return plan


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.complex64 or t.dim() != 3:
        raise ValueError(f"{what}: expected a 3-D complex64 CUDA tensor, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t.resolve_conj().contiguous())


def _bstride(t: torch.Tensor, B: int, what: str) -> int:
    """Complex elements between utterances; 0 for a shared (batch-1) operand."""
    if t.shape[0] not in (1, B):
        raise ValueError(f"{what}: batch {t.shape[0]}, expected 1 or {B}")
    return 0 if t.shape[0] == 1 else t.shape[1] * t.shape[2]


def _launch(a, a_off: int, b, spec, conj_b: bool, out_off: int, out_len: int, B: int, n: int,
            what: str) -> torch.Tensor:
    """One launch of the kernel: out[r, i] = r_row[out_off + i] of the
    circular product of operand a (placed at a_off) and operand b (or its
    spectrum ``spec``), or fft(a) when neither is given; (B, F, out_len)."""
    _check(a, f"{what} first operand")
    F_ = a.shape[1]
    for t, name in ((b, "second operand"), (spec, "spectrum")):
        if t is not None:
            _check(t, f"{what} {name}")
            if t.shape[1] != F_:
                raise ValueError(f"{what}: {name} {tuple(t.shape)} has another bin count")
    if spec is not None and spec.shape[-1] != n:
        raise ValueError(f"{what}: spectrum of {spec.shape[-1]} points, the transform has {n}")
    plan = _plan(n, a.device)
    out = torch.empty((B, F_, out_len, 2), device=a.device, dtype=torch.float32)
    ar = _real(a)
    br = None if b is None else _real(b)
    sr = None if spec is None else _real(spec)
    opt = lambda t: None if t is None else _build.ptr(t)
    lib = _build.load("subband_conv", _SIGNATURES)
    err = lib.subband_fft_conv(
        _build.ptr(ar), _bstride(a, B, what), a.shape[-1], a_off,
        opt(br), 0 if b is None else _bstride(b, B, what), 0 if b is None else b.shape[-1],
        opt(sr), 0 if spec is None else _bstride(spec, B, what), int(conj_b),
        _build.ptr(out), out_off, out_len, B, F_, plan.header_ptr, _build.ptr(plan.table),
        _build.stream(a.device))
    _build.check(err, what)
    return torch.view_as_complex(out)


def frame_spectrum(X: torch.Tensor, Nf: int) -> torch.Tensor:
    """K3's frame spectrum: (B, F, T) -> (B, F, n) = fft of each row at
    n = conv_fft_size(T, Nf), for ``subband_conv(..., Xf=)`` and
    ``subband_conv_filter_grad(..., Xf=)``.  Not differentiable."""
    if X.device.type == "cpu":
        return frame_spectrum_plain(X, Nf)
    n = conv_fft_size(X.shape[-1], Nf)
    out = _launch(X, 0, None, None, False, 0, n, X.shape[0], n, "frame_spectrum")
    frame_spectrum.launches += 1
    return out


def _forward(X, H, pre: int, Xf):
    if X.device.type == "cpu":
        return subband_conv_fft_plain(X, H, pre, Xf)
    T, Nf = X.shape[-1], H.shape[-1]
    B = max(X.shape[0], H.shape[0])
    _check(X, "subband_conv signal")
    out = _launch(H, 0, X if Xf is None else None, Xf, False, pre, T, B,
                  conv_fft_size(T, Nf), "subband_conv")
    subband_conv.launches += 1
    return out


def subband_conv_adjoint(G: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """K3 adjoint wrapper: dX per utterance (B, F, T) from dY and H."""
    if G.device.type == "cpu":
        return subband_conv_adjoint_fft_plain(G, H, pre)
    T = G.shape[-1]
    out = _launch(G, pre, H, None, True, 0, T, G.shape[0], conv_fft_size(T, H.shape[-1]),
                  "subband_conv_adjoint")
    subband_conv_adjoint.launches += 1
    return out


def subband_conv_filter_grad(G: torch.Tensor, X: torch.Tensor, Nf: int, pre: int,
                             Xf: torch.Tensor | None = None) -> torch.Tensor:
    """K3 filter-gradient wrapper: dH per utterance (B, F, Nf) from dY and X
    (or its frame spectrum ``Xf``)."""
    if G.device.type == "cpu":
        return subband_conv_filter_grad_fft_plain(G, X, Nf, pre, Xf)
    T = G.shape[-1]
    if X.shape[-1] != T:
        raise ValueError(f"subband_conv_filter_grad: X {tuple(X.shape)} vs dY {tuple(G.shape)}")
    _check(X, "subband_conv_filter_grad signal")
    out = _launch(G, pre, X if Xf is None else None, Xf, True, 0, Nf, G.shape[0],
                  conv_fft_size(T, Nf), "subband_conv_filter_grad")
    subband_conv_filter_grad.launches += 1
    return out


class _SubbandConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, H, pre, Xf):
        ctx.save_for_backward(X, H, Xf)
        ctx.pre = pre
        return _forward(X, H, pre, Xf)

    @staticmethod
    def backward(ctx, gY):
        X, H, Xf = ctx.saved_tensors
        dX = dH = None
        if ctx.needs_input_grad[0]:
            dX = subband_conv_adjoint(gY, H, ctx.pre)
            if X.shape[0] == 1:
                dX = dX.sum(0, keepdim=True)
        if ctx.needs_input_grad[1]:
            dH = subband_conv_filter_grad(gY, X, H.shape[-1], ctx.pre, Xf)
            if H.shape[0] == 1:
                dH = dH.sum(0, keepdim=True)
        return dX, dH, None, None


def subband_conv(X: torch.Tensor, H: torch.Tensor, pre: int,
                 Xf: torch.Tensor | None = None) -> torch.Tensor:
    """K3 forward wrapper: (Bx, F, T) signal, (Bh, F, Nf) filter, complex64
    -> (max(Bx, Bh), F, T); ``Xf``, X's ``frame_spectrum``, saves its
    transform (X is still needed for its gradient)."""
    Bx, F_, T = X.shape
    Bh, F_h, Nf = H.shape
    B = max(Bx, Bh)
    if F_h != F_ or Bx not in (1, B) or Bh not in (1, B) or (
            Xf is not None and (Xf.shape[0] != Bx or Xf.shape[1] != F_)):
        raise ValueError(f"subband_conv: X {tuple(X.shape)}, H {tuple(H.shape)} and "
                         f"Xf {None if Xf is None else tuple(Xf.shape)} differ")
    if Xf is not None and Xf.requires_grad:
        raise ValueError("subband_conv: the frame spectrum Xf takes no gradient")
    return _SubbandConvFn.apply(X, H, pre, Xf)


subband_conv.launches = 0
subband_conv_adjoint.launches = 0
subband_conv_filter_grad.launches = 0
frame_spectrum.launches = 0
