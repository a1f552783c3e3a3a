"""The WPE normal equations, and kernel K7 (CUDA, ``csrc/wpe_solve.cu``).

    (R + load I) G = P,    load = diag_rel * trace(R).real / n + eps

for a batch of small complex systems (one per utterance and frequency bin;
``buddy_tpu/sampling/wpe.py::_wpe_single_bin``).  The kernel factorises each
system by LU with partial pivoting in float64 (see the source for why and
for the schedule); ``wpe_solve_plain`` is the plain PyTorch version, a
complex64 ``torch.linalg.solve``.  The two agree in the residual of the
system, not in G element by element: complex64 WPE is ill-conditioned.  No
gradient: WPE is a warm initialisation outside any autograd graph.

``solve_route(n, batch, sms)`` is the kernel's plan: the matrix in
registers for n <= 64 (the smallest instance that holds n), else a
device-memory workspace, up to ``MAX_N``; above it ``wpe_solve`` raises a
ValueError that names the cap (on any device but the CPU).

``wpe_solve`` counts its launches (one a call).  CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from buddy_tpu_torch.ops import _build

_SIGNATURES = {
    "wpe_solve": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double] * 2
                 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p],
}
MAX_N = 1024        # the large route's cap (csrc/wpe_solve.cu's kMaxN)
WARP = 32
RING = 8            # csrc/wpe_solve.cu's kRing
# the register route's instances, in csrc/wpe_solve.cu's order: the largest n
# each holds, rows a lane (RS), warps (PC), column slots a thread (CS), and the
# CTAs an SM its __launch_bounds__ asks for
REG_INSTANCES = ((16, 1, 1, 17, 16), (32, 1, 2, 17, 8), (51, 2, 4, 13, 3), (64, 2, 4, 17, 2))
LARGE_THREADS = 512
SMEM_MAX = 227 * 1024       # shared memory a CTA may use on the H100
REGS_MAX = 255              # registers a thread
REGS_SM = 65536             # registers an SM


@dataclass(frozen=True)
class SolveRoute:
    """The kernel's plan for n unknowns and ``batch`` systems: route
    ("registers" or "large") and the index the C entry takes, threads a CTA,
    CTAs in the grid, dynamic shared memory a CTA, the registers a thread
    that hold the float64 matrix and the cap the launch bounds set (register
    route), and the workspace in bytes (large route)."""
    route: str
    index: int
    threads: int
    grid: int
    smem_bytes: int
    matrix_registers: int
    register_cap: int
    workspace_bytes: int


def _check_n(n: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"wpe_solve: n = {n} unknowns is outside the kernel's range "
                         f"1 <= n <= MAX_N = {MAX_N}")


def solve_route(n: int, batch: int = 1, sms: int = 132) -> SolveRoute:
    """The plan for ``batch`` systems of n unknowns on a card of ``sms`` SMs
    (mirrors csrc/wpe_solve.cu, which checks the shared memory it is given):
    the register route's grid is persistent, as many CTAs as fit the SMs by
    the launch bounds (or fewer, one a system); the large route's is one CTA
    an SM, and its workspace one matrix a CTA."""
    _check_n(n)
    for index, (max_n, rs, pc, cs, minb) in enumerate(REG_INSTANCES):
        if n <= max_n:
            m = pc * cs - 1                 # U's rows hold columns k+1 .. m
            smem = (16 * (pc + n * m - n * (n - 1) // 2 + n + RING * rs * WARP)
                    + 8 * n * (n + 1) + 4 * RING)
            threads = WARP * pc
            cap = min(REGS_MAX, REGS_SM // (threads * minb) // 8 * 8)
            return SolveRoute("registers", index, threads, min(batch, sms * minb), smem,
                              rs * cs * 4, cap, 0)
    smem = 16 * (5 * n + 1) + 4 * n + n + 12 * (LARGE_THREADS // WARP)
    grid = min(batch, sms)
    return SolveRoute("large", len(REG_INSTANCES), LARGE_THREADS, grid, smem, 0, REGS_MAX,
                      16 * grid * n * (n + 1))


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
    if n:
        _check_n(n)
    if (R.device.type != "cuda" or R.dtype != torch.complex64 or P.dtype != torch.complex64
            or R.shape[-2] != n or P.shape != R.shape[:-1]):
        raise ValueError(f"wpe_solve: expected complex64 CUDA R (..., n, n) and P (..., n), "
                         f"got {R.dtype} {tuple(R.shape)}, {P.dtype} {tuple(P.shape)} on "
                         f"{R.device}")
    batch = P.numel() // max(n, 1)
    Rr = torch.view_as_real(R.resolve_conj().contiguous())
    Pr = torch.view_as_real(P.resolve_conj().contiguous())
    G = torch.empty_like(Pr)
    if batch == 0:
        return torch.view_as_complex(G)
    plan = solve_route(n, batch, torch.cuda.get_device_properties(R.device).multi_processor_count)
    work = (torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=R.device)
            if plan.workspace_bytes else None)
    lib = _build.load("wpe_solve", _SIGNATURES)
    err = lib.wpe_solve(_build.ptr(Rr), _build.ptr(Pr), _build.ptr(G), batch, n,
                        float(diag_rel), float(eps), plan.index, plan.smem_bytes,
                        None if work is None else _build.ptr(work), plan.grid,
                        _build.stream(R.device))
    _build.check(err, "wpe_solve")
    wpe_solve.launches += 1
    return torch.view_as_complex(G)


wpe_solve.launches = 0
