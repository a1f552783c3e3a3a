"""Subband frame convolution, and kernel K3 (CUDA, ``csrc/subband_conv.cu``).

    Y[b, f, t] = sum_{j < Nf} H[b, f, j] * X[b, f, t + pre - j]

with zeros outside [0, T): one complex FIR along the STFT frame axis per
(utterance, frequency bin) — ``buddy_tpu/operators/subband.py::
SubbandFiltering.subband_filtering``, which the TPU computes with
overlap-save matmul DFTs.  Either operand may have batch 1 and is then
shared by every utterance.

Wrappers, each counting its launches: ``subband_conv`` (forward),
``subband_conv_adjoint`` (dX = transposed FIR with conj(H)) and
``subband_conv_filter_grad`` (dH, a correlation with conj(X)).  The two
backward kernels follow torch's complex-gradient convention.  CPU tensors
take the plain PyTorch versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build

_SIGNATURES = {
    "subband_fir": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "subband_fir_dh": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                      + [ctypes.c_longlong, ctypes.c_void_p],
}


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


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.complex64 or t.dim() != 3:
        raise ValueError(f"{what}: expected a 3-D complex64 CUDA tensor, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t.resolve_conj().contiguous())


def _launch_fir(X, H, pre: int, adjoint: bool) -> torch.Tensor:
    _check(X, "subband_conv signal")
    _check(H, "subband_conv filter")
    Bx, F_, T = X.shape
    Bh, F_h, Nf = H.shape
    B = max(Bx, Bh)
    if F_h != F_ or Bx not in (1, B) or Bh not in (1, B):
        raise ValueError(f"subband_conv: X {tuple(X.shape)} and H {tuple(H.shape)} differ")
    if (Nf + T) * 8 > 200 * 1024:
        raise ValueError(f"subband_conv: a row of {T} frames and {Nf} taps exceeds shared memory")
    xr, hr = _real(X), _real(H)
    Y = torch.empty((B, F_, T, 2), device=X.device, dtype=torch.float32)
    lib = _build.load("subband_conv", _SIGNATURES)
    err = lib.subband_fir(_build.ptr(xr), _build.ptr(hr), _build.ptr(Y), B, F_, T, Nf, pre,
                          0 if Bx == 1 else F_ * T, 0 if Bh == 1 else F_ * Nf,
                          int(adjoint), _build.stream(X.device))
    _build.check(err, "subband_fir")
    return torch.view_as_complex(Y)


def subband_conv_adjoint(G: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """K3 adjoint wrapper: dX per utterance (B, F, T) from dY and H."""
    if G.device.type == "cpu":
        return subband_conv_adjoint_plain(G, H, pre)
    out = _launch_fir(G, H, pre, adjoint=True)
    subband_conv_adjoint.launches += 1
    return out


def subband_conv_filter_grad(G: torch.Tensor, X: torch.Tensor, Nf: int, pre: int) -> torch.Tensor:
    """K3 filter-gradient wrapper: dH per utterance (B, F, Nf) from dY and X."""
    if G.device.type == "cpu":
        return subband_conv_filter_grad_plain(G, X, Nf, pre)
    _check(G, "subband_conv_filter_grad dY")
    _check(X, "subband_conv_filter_grad signal")
    B, F_, T = G.shape
    if X.shape[1:] != (F_, T) or X.shape[0] not in (1, B):
        raise ValueError(f"subband_conv_filter_grad: X {tuple(X.shape)} vs dY {tuple(G.shape)}")
    if 2 * T * 8 > 200 * 1024:
        raise ValueError(f"subband_conv_filter_grad: a row of {T} frames exceeds shared memory")
    gr, xr = _real(G), _real(X)
    dH = torch.empty((B, F_, Nf, 2), device=G.device, dtype=torch.float32)
    lib = _build.load("subband_conv", _SIGNATURES)
    err = lib.subband_fir_dh(_build.ptr(gr), _build.ptr(xr), _build.ptr(dH), B, F_, T, Nf, pre,
                             0 if X.shape[0] == 1 else F_ * T, _build.stream(G.device))
    _build.check(err, "subband_fir_dh")
    subband_conv_filter_grad.launches += 1
    return torch.view_as_complex(dH)


class _SubbandConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, H, pre):
        ctx.save_for_backward(X, H)
        ctx.pre = pre
        out = _launch_fir(X, H, pre, adjoint=False)
        subband_conv.launches += 1
        return out

    @staticmethod
    def backward(ctx, gY):
        X, H = ctx.saved_tensors
        dX = dH = None
        if ctx.needs_input_grad[0]:
            dX = subband_conv_adjoint(gY, H, ctx.pre)
            if X.shape[0] == 1:
                dX = dX.sum(0, keepdim=True)
        if ctx.needs_input_grad[1]:
            dH = subband_conv_filter_grad(gY, X, H.shape[-1], ctx.pre)
            if H.shape[0] == 1:
                dH = dH.sum(0, keepdim=True)
        return dX, dH, None


def subband_conv(X: torch.Tensor, H: torch.Tensor, pre: int) -> torch.Tensor:
    """K3 forward wrapper: (Bx, F, T) signal, (Bh, F, Nf) filter, complex64
    -> (max(Bx, Bh), F, T)."""
    if X.device.type == "cpu" and H.device.type == "cpu":
        return subband_conv_plain(X, H, pre)
    return _SubbandConvFn.apply(X, H, pre)


subband_conv.launches = 0
subband_conv_adjoint.launches = 0
subband_conv_filter_grad.launches = 0
