"""The blind operator's filter design with its phasor, and kernel K6
(CUDA, ``csrc/filter_design.cu``).

    env   = sum_e weights[e] * exp(decay[e])^(-n)            (bands, Nf)
    full  = env, with a zero row at each EQ extreme when those are fixed
    A     = (exp(M @ log(full + 1e-6)) + 1e-6) * ola + dpc   (F, Nf)
    H     = A * exp(i * phases)

``buddy_tpu/operators/subband.py``: ``design_subband_filter``,
``design_filter`` and the phasor of ``compute_H``.  M is the piecewise-linear
interpolation from the EQ breakpoints to the STFT bins: two non-zeros per
row, kept here as each row's interval ``j`` and weight ``t``.

``filter_design_plain`` is the plain PyTorch version and
``filter_design_backward_plain`` its explicit backward formula (the one the
kernels implement).  Wrappers, each counting its launches: ``filter_design``
and ``filter_design_backward``.  CPU tensors take the plain versions
(autograd differentiates the forward); CUDA tensors launch the kernels or
raise.  Parameters are batch-first: decay and weights (B, E, bands), phases
and H (B, F, Nf).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "filter_design_fwd": [_P] * 8 + [_I] * 7 + [_P],
    "filter_design_bwd": [_P] * 13 + [_I] * 7 + [_P],
}


class FilterDesignGeometry:
    """The constants of one operator: the interpolation (as the dense matrix
    for the plain version and as per-row interval and weight for the kernel),
    the OLA factors (Nf,), the direct-path correction (F, Nf), and whether
    the EQ extremes are fixed zero rows."""

    def __init__(self, freqs: np.ndarray, eq_freqs: np.ndarray, ola: np.ndarray,
                 dpc: np.ndarray, fix_extremes: bool, device):
        x, xp = np.asarray(freqs, np.float32), np.asarray(eq_freqs, np.float32)
        j = np.clip(np.searchsorted(xp, x) - 1, 0, len(xp) - 2)
        t = np.clip((x - xp[j]) / (xp[j + 1] - xp[j]), 0.0, 1.0).astype(np.float32)
        if np.any(np.diff(j) < 0):
            raise ValueError("the STFT bin frequencies must ascend")
        M = np.zeros((len(x), len(xp)), np.float32)
        rows = np.arange(len(x))
        M[rows, j] = 1.0 - t
        M[rows, j + 1] = t
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt), device=device)
        self.interp_mat = as_t(M, np.float32)
        self.j, self.t = as_t(j, np.int32), as_t(t, np.float32)
        # row_start[q]: the first row whose interval index is >= q
        self.row_start = as_t(np.searchsorted(j, np.arange(len(xp))), np.int32)
        self.ola, self.dpc = as_t(ola, np.float32), as_t(dpc, np.float32)
        self.fix_extremes = bool(fix_extremes)
        self.n_eq = len(xp)


# --- plain versions ---------------------------------------------------------
def _envelope_terms(decay, weights, Nf: int):
    n = torch.arange(Nf, dtype=torch.float32, device=decay.device)
    decayed = torch.exp(decay)[..., None] ** (-n)                    # (B, E, bands, Nf)
    return n, decayed, (weights[..., None] * decayed).sum(-3)


def _interp_log(env, geom: FilterDesignGeometry):
    full = F.pad(env, (0, 0, 1, 1)) if geom.fix_extremes else env
    return full, torch.exp(geom.interp_mat @ torch.log(full + 1e-6))


def design_plain(decay, weights, geom: FilterDesignGeometry, Nf: int) -> torch.Tensor:
    """The magnitude A alone (no phasor): (..., E, bands) -> (..., F, Nf)."""
    _, _, env = _envelope_terms(decay, weights, Nf)
    return (_interp_log(env, geom)[1] + 1e-6) * geom.ola + geom.dpc


def filter_design_plain(decay, weights, phases, geom: FilterDesignGeometry) -> torch.Tensor:
    return design_plain(decay, weights, geom, phases.shape[-1]) * torch.exp(1j * phases)


def filter_design_backward_plain(decay, weights, phases, gH, geom: FilterDesignGeometry):
    """(dL/ddecay, dL/dweights, dL/dphases) from gH = dL/dRe H + i dL/dIm H."""
    n, decayed, env = _envelope_terms(decay, weights, phases.shape[-1])
    full, P = _interp_log(env, geom)
    A = (P + 1e-6) * geom.ola + geom.dpc
    c, s = torch.cos(phases), torch.sin(phases)
    g_phases = A * (gH.imag * c - gH.real * s)
    g_I = (gH.real * c + gH.imag * s) * geom.ola * P                 # (B, F, Nf)
    g_full = (geom.interp_mat.T @ g_I) / (full + 1e-6)               # (B, Q, Nf)
    if geom.fix_extremes:
        g_full = g_full[..., 1:-1, :]
    g_env = g_full[..., None, :, :]                                  # over the exponentials
    g_weights = (g_env * decayed).sum(-1)
    g_decay = (g_env * weights[..., None] * (-n) * decayed).sum(-1)
    return g_decay, g_weights, g_phases


# --- kernel launches ----------------------------------------------------------
def _check(decay, weights, phases, geom, what: str):
    for t in (decay, weights, phases):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{what}: expected 3-D float32 CUDA tensors, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, E, bands = decay.shape
    pad = 1 if geom.fix_extremes else 0
    if (weights.shape != decay.shape or phases.shape[0] != B
            or phases.shape[1:] != geom.dpc.shape or bands + 2 * pad != geom.n_eq):
        raise ValueError(f"{what}: decay {tuple(decay.shape)}, weights {tuple(weights.shape)}, "
                         f"phases {tuple(phases.shape)} do not fit the geometry "
                         f"({geom.n_eq} breakpoints, {tuple(geom.dpc.shape)})")
    return B, phases.shape[1], phases.shape[2], E, bands, geom.n_eq, pad


def _launch_forward(decay, weights, phases, geom) -> torch.Tensor:
    dims = _check(decay, weights, phases, geom, "filter_design")
    decay, weights, phases = decay.contiguous(), weights.contiguous(), phases.contiguous()
    H = torch.empty(phases.shape + (2,), device=phases.device, dtype=torch.float32)
    lib = _build.load("filter_design", _SIGNATURES)
    p = _build.ptr
    err = lib.filter_design_fwd(p(decay), p(weights), p(phases), p(geom.j), p(geom.t),
                                p(geom.ola), p(geom.dpc), p(H), *dims,
                                _build.stream(phases.device))
    _build.check(err, "filter_design_fwd")
    filter_design.launches += 1
    return torch.view_as_complex(H)


def filter_design_backward(decay, weights, phases, gH, geom):
    """K6 backward wrapper: (dL/ddecay, dL/dweights, dL/dphases)."""
    if phases.device.type == "cpu":
        return filter_design_backward_plain(decay, weights, phases, gH, geom)
    dims = _check(decay, weights, phases, geom, "filter_design_backward")
    if gH.dtype != torch.complex64 or gH.shape != phases.shape:
        raise ValueError(f"filter_design_backward: gH {gH.dtype} {tuple(gH.shape)}")
    decay, weights, phases = decay.contiguous(), weights.contiguous(), phases.contiguous()
    gr = torch.view_as_real(gH.resolve_conj().contiguous())
    g_phases, g_I = torch.empty_like(phases), torch.empty_like(phases)
    g_decay, g_weights = torch.empty_like(decay), torch.empty_like(weights)
    lib = _build.load("filter_design", _SIGNATURES)
    p = _build.ptr
    err = lib.filter_design_bwd(p(decay), p(weights), p(phases), p(gr), p(geom.j), p(geom.t),
                                p(geom.row_start), p(geom.ola), p(geom.dpc), p(g_phases),
                                p(g_I), p(g_decay), p(g_weights), *dims,
                                _build.stream(phases.device))
    _build.check(err, "filter_design_bwd")
    filter_design_backward.launches += 1
    return g_decay, g_weights, g_phases


class _FilterDesignFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, decay, weights, phases, geom):
        ctx.save_for_backward(decay, weights, phases)
        ctx.geom = geom
        return _launch_forward(decay, weights, phases, geom)

    @staticmethod
    def backward(ctx, gH):
        decay, weights, phases = ctx.saved_tensors
        return (*filter_design_backward(decay, weights, phases, gH, ctx.geom), None)


def filter_design(decay, weights, phases, geom: FilterDesignGeometry) -> torch.Tensor:
    """K6 forward wrapper: decay, weights (B, E, bands) and phases (B, F, Nf)
    float32 -> H (B, F, Nf) complex64."""
    if phases.device.type == "cpu":
        return filter_design_plain(decay, weights, phases, geom)
    return _FilterDesignFn.apply(decay, weights, phases, geom)


filter_design.launches = 0
filter_design_backward.launches = 0
