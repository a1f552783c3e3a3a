"""The WPE normal equations, and kernel K7 (CUDA, ``csrc/wpe_solve.cu``).

    (R + load I) G = P,    load = diag_rel * trace(R).real / n + eps

for a batch of small complex systems (one per utterance and frequency bin;
``buddy_tpu/sampling/wpe.py::_wpe_single_bin``).  The kernel factorises each
system by LU with partial pivoting in float64 (see the source for why);
``wpe_solve_plain`` is the plain PyTorch version, a complex64
``torch.linalg.solve``.  The two agree in the residual of the system, not in
G element by element: complex64 WPE is ill-conditioned.  No gradient: WPE
is a warm initialisation outside any autograd graph.

``wpe_solve`` counts its launches.  CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from buddy_tpu_torch.ops import _build

_SIGNATURES = {
    "wpe_solve": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
                 + [ctypes.c_void_p],
}
_MAX_N = 119        # n (n + 1) double2 within the 227 KB of a block's shared memory


def wpe_solve_plain(R: torch.Tensor, P: torch.Tensor, diag_rel: float = 1e-6,
                    eps: float = 1e-10) -> torch.Tensor:
    n = R.shape[-1]
    trace = torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1)
    load = diag_rel * (trace / n) + eps
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    return torch.linalg.solve(R + load[..., None, None] * eye, P)


def wpe_solve(R: torch.Tensor, P: torch.Tensor, diag_rel: float = 1e-6,
              eps: float = 1e-10) -> torch.Tensor:
    """K7 wrapper: R (..., n, n), P (..., n) complex64 -> G (..., n)."""
    if R.device.type == "cpu":
        return wpe_solve_plain(R, P, diag_rel, eps)
    n = R.shape[-1]
    if (R.device.type != "cuda" or R.dtype != torch.complex64 or P.dtype != torch.complex64
            or R.shape[-2] != n or P.shape != R.shape[:-1] or n > _MAX_N):
        raise ValueError(f"wpe_solve: expected complex64 CUDA R (..., n, n) and P (..., n) with "
                         f"n <= {_MAX_N}, got {R.dtype} {tuple(R.shape)}, {P.dtype} "
                         f"{tuple(P.shape)} on {R.device}")
    Rr = torch.view_as_real(R.resolve_conj().contiguous())
    Pr = torch.view_as_real(P.resolve_conj().contiguous())
    G = torch.empty_like(Pr)
    lib = _build.load("wpe_solve", _SIGNATURES)
    err = lib.wpe_solve(_build.ptr(Rr), _build.ptr(Pr), _build.ptr(G), P.numel() // n, n,
                        float(diag_rel), float(eps), _build.stream(R.device))
    _build.check(err, "wpe_solve")
    wpe_solve.launches += 1
    return torch.view_as_complex(G)


wpe_solve.launches = 0
