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
kernels implement).  Wrappers, each counting its launches (one a call):
``filter_design`` and ``filter_design_backward``; the backward kernel keeps
dL/dI in shared memory and sums the CTAs' partial rows in a fixed order
(``csrc/filter_design.cu``).  CPU tensors take the plain versions
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
    "filter_design_fwd": [_P] * 8 + [_I] * 10 + [_P],
    "filter_design_bwd": [_P] * 13 + [_I] * 10 + [_P],
}
_tickets: dict = {}
# dynamic shared memory a CTA may ask for (csrc/filter_design.cu's kSmemMax)
SMEM_MAX = 223 * 1024


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
        self.j_host = j.astype(np.int32)
        self.j, self.t = as_t(j, np.int32), as_t(t, np.float32)
        self.ola, self.dpc = as_t(ola, np.float32), as_t(dpc, np.float32)
        self.fix_extremes = bool(fix_extremes)
        self.n_eq = len(xp)
        self.schedules: dict = {}


# --- plain versions ---------------------------------------------------------
def _envelope_terms(decay, weights, Nf: int):
    n = torch.arange(Nf, dtype=torch.float32, device=decay.device)
    decayed = torch.exp(decay)[..., None] ** (-n)                    # (B, E, bands, Nf)
    return n, decayed, (weights[..., None] * decayed).sum(-3)


def _interp_log(env, geom: FilterDesignGeometry):
    full = F.pad(env, (0, 0, 1, 1)) if geom.fix_extremes else env
    return full, torch.exp(geom.interp_mat @ torch.log(full + 1e-6))


def design_plain(decay, weights, geom: FilterDesignGeometry, Nf: int,
                 correct_ola: bool = True) -> torch.Tensor:
    """The magnitude A alone (no phasor): (..., E, bands) -> (..., F, Nf);
    without the OLA factors where ``correct_ola`` is False."""
    _, _, env = _envelope_terms(decay, weights, Nf)
    A = _interp_log(env, geom)[1] + 1e-6
    return (A * geom.ola if correct_ola else A) + geom.dpc


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


# --- the kernels' row schedule ---------------------------------------------------
def smem_bytes(F: int, Nf: int, E: int, bands: int, R: int, qmax: int, bwd: bool) -> int:
    """A CTA's dynamic shared memory in ``csrc/filter_design.cu``: the staged
    arrays (``staged_floats``: qmax log-envelope rows, and as many of
    full + 1e-6 for the backward, the OLA row, the b's parameters, the rows'
    j and t, the row ranges) and, for the backward, its rows of dL/dI or the
    last CTA's pairs, whichever is larger."""
    staged = (2 if bwd else 1) * qmax * Nf + Nf + 2 * E * bands + 2 * R + qmax + 1
    staged += staged & 1
    nb = -(-F // R)
    return 4 * (staged + (max(R * Nf, 2 * bands * E * nb) if bwd else 0))


def schedule(j: np.ndarray, Nf: int, E: int, bands: int, B: int, sms: int, bwd: bool):
    """(R, nb, qmax): R consecutive frequency rows a CTA, nb CTAs a b and the
    most breakpoints the rows of one CTA touch.  R starts at about one wave
    (F / (sms / B), rounded up) and is halved until a CTA's shared memory
    fits; where one row a CTA does not fit, ValueError names the cap."""
    F = len(j)
    R = -(-F // max(1, sms // B))
    while True:
        starts = np.arange(0, F, R)
        qmax = int((j[np.minimum(starts + R, F) - 1] + 2 - j[starts]).max())
        need = smem_bytes(F, Nf, E, bands, R, qmax, bwd)
        if need <= SMEM_MAX:
            return R, len(starts), qmax
        if R == 1:
            raise ValueError(
                f"filter_design{'_backward' if bwd else ''}: F={F}, Nf={Nf}, {E} x {bands} "
                f"envelope terms need {need} bytes of shared memory a CTA even at one row a "
                f"CTA, above the cap of {SMEM_MAX} bytes")
        R = (R + 1) // 2


def _schedule(geom: FilterDesignGeometry, dims, bwd: bool):
    """``schedule`` of the geometry at these dims, once per (B, E, direction)."""
    B, _, Nf, E, bands, _, _ = dims
    key = (B, E, bwd)
    s = geom.schedules.get(key)
    if s is None:
        sms = torch.cuda.get_device_properties(geom.j.device).multi_processor_count
        s = geom.schedules[key] = schedule(geom.j_host, Nf, E, bands, B, sms, bwd)
    return s


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, copied only where it is not or where its data does not
    start on 16 bytes (the kernels load four values at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _backward_scratch(dims, nb: int, device):
    """The backward's partial sums (B, nb CTAs a b, bands, E) of (d weights,
    d decay) and its B zeroed tickets (each launch leaves them zero, so they
    are allocated once)."""
    B, _, _, E, bands, _, _ = dims
    tickets = _tickets.get(device)
    if tickets is None or tickets.numel() < B:
        tickets = _tickets[device] = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
    return torch.empty((B, nb, bands, E, 2), device=device, dtype=torch.float32), tickets


def _launch_forward(decay, weights, phases, geom) -> torch.Tensor:
    dims = _check(decay, weights, phases, geom, "filter_design")
    sched = _schedule(geom, dims, False)
    decay, weights, phases = decay.contiguous(), weights.contiguous(), _aligned(phases)
    H = torch.empty(phases.shape + (2,), device=phases.device, dtype=torch.float32)
    lib = _build.load("filter_design", _SIGNATURES)
    p = _build.ptr
    err = lib.filter_design_fwd(p(decay), p(weights), p(phases), p(geom.j), p(geom.t),
                                p(geom.ola), p(geom.dpc), p(H), *dims, *sched,
                                _build.stream(phases.device))
    _build.check(err, "filter_design_fwd")
    filter_design.launches += 1
    return torch.view_as_complex(H)


def filter_design_backward(decay, weights, phases, gH, geom):
    """K6 backward wrapper: (dL/ddecay, dL/dweights, dL/dphases)."""
    if phases.device.type == "cpu":
        return filter_design_backward_plain(decay, weights, phases, gH, geom)
    dims = _check(decay, weights, phases, geom, "filter_design_backward")
    sched = _schedule(geom, dims, True)
    if gH.dtype != torch.complex64 or gH.shape != phases.shape:
        raise ValueError(f"filter_design_backward: gH {gH.dtype} {tuple(gH.shape)}")
    decay, weights, phases = decay.contiguous(), weights.contiguous(), _aligned(phases)
    gr = _aligned(torch.view_as_real(gH.resolve_conj()))
    g_phases = torch.empty_like(phases)
    g_decay, g_weights = torch.empty_like(decay), torch.empty_like(weights)
    part, tickets = _backward_scratch(dims, sched[1], phases.device)
    lib = _build.load("filter_design", _SIGNATURES)
    p = _build.ptr
    err = lib.filter_design_bwd(p(decay), p(weights), p(phases), p(gr), p(geom.j), p(geom.t),
                                p(geom.ola), p(geom.dpc), p(g_phases), p(part), p(tickets),
                                p(g_decay), p(g_weights), *dims, *sched,
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
