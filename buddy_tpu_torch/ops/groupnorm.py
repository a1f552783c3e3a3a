"""GroupNorm with an optional fused SiLU, and kernel K1 (CUDA, ``csrc/groupnorm.cu``).

Semantics (``buddy_tpu/models/layers.py::GroupNormAct``): groups over
contiguous channel blocks, statistics in float32 from per-channel first and
second moments (var = E[x^2] - E[x]^2), eps inside the rsqrt, affine, then
SiLU when asked.  Input is NCHW; the kernels want it in channels_last memory
format, which is how the U-Net keeps its activations.

K1 is one C call a pass, forward (``group_norm_act``) and backward
(``group_norm_act_backward``), each counting its calls: two launches, the
statistics of row slabs, then the coefficients formed in the second
kernel's prologue and the normalise or dx pass.  Nothing runs between the
launches.  The plain functions below
spell out the kernels' algebra on their partial sums; CPU tensors take the
plain version (autograd differentiates it), CUDA tensors launch the kernels
or raise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build

SLABS_PER_SM = 4        # statistics CTAs an SM over the batch
MIN_SLAB_ROWS = 64      # fewest rows a statistics CTA reduces

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "gn_forward": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    "gn_backward": [_P] * 10 + [_I] * 8 + [_P],
}


# ---------------------------------------------------------------------------
# the plain version and the kernels' algebra
# ---------------------------------------------------------------------------
def _group_stats(s1, s2, num_groups, count, eps):
    """Per-channel sums (B, C) -> per-group mean and rstd (B, G)."""
    B, C = s1.shape
    m = s1.view(B, num_groups, C // num_groups).sum(-1) / count
    m2 = s2.view(B, num_groups, C // num_groups).sum(-1) / count
    return m, torch.rsqrt(m2 - m * m + eps)


def _affine(mean, rstd, weight, bias, C):
    """Per-(b, c) scale a and shift sh with y = x * a + sh."""
    rep = C // mean.shape[1]
    a = rstd.repeat_interleave(rep, 1) * weight.float()[None, :]
    return a, bias.float()[None, :] - mean.repeat_interleave(rep, 1) * a


def group_norm_act_plain(x, weight, bias, num_groups: int, eps: float = 1e-6,
                         silu: bool = False):
    """Plain PyTorch GroupNorm(+SiLU) with float32 statistics."""
    B, C = x.shape[:2]
    xf = x.float()
    count = xf[0, 0].numel() * (C // num_groups)
    mean, rstd = _group_stats(xf.sum((2, 3)), (xf * xf).sum((2, 3)), num_groups, count, eps)
    a, sh = _affine(mean, rstd, weight, bias, C)
    y = xf * a[:, :, None, None] + sh[:, :, None, None]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def slab_schedule(B: int, HW: int, sms: int):
    """(S, RS): the statistics pass's slabs an utterance and rows a slab,
    about SLABS_PER_SM CTAs an SM over the batch, at least MIN_SLAB_ROWS
    rows a slab, no empty slab (the last may be shorter)."""
    S = max(1, min(-(-HW // MIN_SLAB_ROWS), -(-SLABS_PER_SM * sms // B)))
    RS = -(-HW // S)
    return -(-HW // RS), RS


def _slabs(t: torch.Tensor, S: int, RS: int) -> torch.Tensor:
    """(B, HW, C) -> (B, S, RS, C), the last slab zero-padded."""
    B, HW, C = t.shape
    return F.pad(t, (0, 0, 0, S * RS - HW)).view(B, S, RS, C)


def slab_sums_plain(xv: torch.Tensor, S: int, RS: int) -> torch.Tensor:
    """The statistics kernel's per-channel sums: (B, HW, C) -> (B, S, 2, C)
    of (sum x, sum x^2) over each slab's rows."""
    xs = _slabs(xv.float(), S, RS)
    return torch.stack([xs.sum(2), (xs * xs).sum(2)], 2)


def group_partials_plain(ch: torch.Tensor, G: int, weight=None) -> torch.Tensor:
    """(..., 2, C) per-channel sums (times weight[c] when given) -> (..., G, 2)
    per-group sums, as the kernels store their partials."""
    if weight is not None:
        ch = ch * weight.float()
    C = ch.shape[-1]
    return ch.reshape(ch.shape[:-1] + (G, C // G)).sum(-1).transpose(-1, -2)


def forward_coefficients_plain(part: torch.Tensor, weight, bias, count: float, eps: float):
    """The normalise kernel's prologue: partials (B, S, G, 2) -> mean, rstd
    (B, G) and the per-channel a, sh (B, C) with y = x a + sh."""
    s = part.sum(1)
    mean = s[..., 0] / count
    rstd = torch.rsqrt(s[..., 1] / count - mean * mean + eps)
    return (mean, rstd) + _affine(mean, rstd, weight, bias, weight.shape[0])


def _du(xf, dyf, a, sh, silu: bool):
    """The gradient at the pre-activation u = x a + sh (rows (B, ..., C))."""
    if not silu:
        return dyf
    u = xf * a + sh
    s = torch.sigmoid(u)
    return dyf * (s * (1.0 + u * (1.0 - s)))


def backward_slab_sums_plain(xv, dyv, a, sh, silu: bool, S: int, RS: int) -> torch.Tensor:
    """The backward statistics kernel's per-channel sums: (B, S, 2, C) of
    (sum du, sum du x) over each slab's rows; a, sh (B, C)."""
    xs, gs = _slabs(xv.float(), S, RS), _slabs(dyv.float(), S, RS)
    du = _du(xs, gs, a[:, None, None], sh[:, None, None], silu)
    return torch.stack([du.sum(2), (du * xs).sum(2)], 2)


def backward_coefficients_plain(pg: torch.Tensor, mean, rstd, count: float):
    """The dx kernel's prologue: weighted partials (B, S, G, 2) of (sum w du,
    sum w du x) -> c2, c3 (B, G) with dx = a du + c2 x + c3."""
    s = pg.sum(1)
    m1 = s[..., 0] / count
    m2 = rstd * (s[..., 1] - mean * s[..., 0]) / count
    return -rstd * rstd * m2, -rstd * m1 + mean * rstd * rstd * m2


def weight_grads_plain(pc: torch.Tensor, mean, rstd):
    """d weight, d bias (C,) from per-channel partials (B, S, 2, C)."""
    s = pc.sum(1)
    rep = s.shape[-1] // mean.shape[1]
    m, r = mean.repeat_interleave(rep, 1), rstd.repeat_interleave(rep, 1)
    return (r * (s[:, 1] - m * s[:, 0])).sum(0), s[:, 0].sum(0)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _as_bhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> its channels_last storage viewed as (B, HW, C)."""
    t = t.contiguous(memory_format=torch.channels_last)
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"group_norm_act: expected a 4-D float32/bfloat16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_forward(x, weight, bias, num_groups: int, eps: float, silu: bool):
    """K1 forward: (y NCHW in channels_last memory, mr (B, G, 2) = mean, rstd)."""
    _check(x)
    B, C, H, W = x.shape
    G = num_groups
    S, RS = slab_schedule(B, H * W, _sm_count(x.device))
    xv = _as_bhwc(x)
    w, b = weight.float().contiguous(), bias.float().contiguous()
    mr = torch.empty((B, G, 2), device=x.device, dtype=torch.float32)
    part = torch.empty(B * S * G * 2, device=x.device, dtype=torch.float32)
    y = torch.empty_like(xv)
    lib = _build.load("groupnorm", _SIGNATURES)
    err = lib.gn_forward(_build.ptr(xv), _build.ptr(y), _build.ptr(w), _build.ptr(b),
                         _build.ptr(mr), _build.ptr(part), B, H * W, C, G, S, RS, eps,
                         int(x.dtype == torch.bfloat16), int(silu), _build.stream(x.device))
    _build.check(err, "gn_forward")
    group_norm_act.launches += 1
    return y.view(B, H, W, C).permute(0, 3, 1, 2), mr


def group_norm_act_backward(x, dy, weight, bias, mr, silu: bool, need_weight_grads: bool = True):
    """K1 backward: (dx, d weight, d bias) of y = act(GN(x)) given dy and
    the forward's mean and rstd ``mr``; the weight gradients are None when
    not asked for."""
    _check(x)
    _check(dy)
    B, C, H, W = x.shape
    G = mr.shape[1]
    S, RS = slab_schedule(B, H * W, _sm_count(x.device))
    if not dy.is_contiguous(memory_format=torch.channels_last) or dy.dtype != x.dtype:
        group_norm_act_backward.dy_copies += 1
    xv, dyv = _as_bhwc(x), _as_bhwc(dy.to(x.dtype))
    w, b = weight.float().contiguous(), bias.float().contiguous()
    f32 = dict(device=x.device, dtype=torch.float32)
    pg = torch.empty(B * S * G * 2, **f32)
    pc = torch.empty(B * S * 2 * C, **f32) if need_weight_grads else None
    dw = torch.empty(C, **f32) if need_weight_grads else None
    db = torch.empty(C, **f32) if need_weight_grads else None
    dx = torch.empty_like(xv)
    opt = lambda t: None if t is None else _build.ptr(t)
    lib = _build.load("groupnorm", _SIGNATURES)
    err = lib.gn_backward(_build.ptr(xv), _build.ptr(dyv), _build.ptr(dx), _build.ptr(w),
                          _build.ptr(b), _build.ptr(mr), _build.ptr(pg), opt(pc), opt(dw), opt(db),
                          B, H * W, C, G, S, RS, int(x.dtype == torch.bfloat16), int(silu),
                          _build.stream(x.device))
    _build.check(err, "gn_backward")
    group_norm_act_backward.launches += 1
    return dx.view(B, H, W, C).permute(0, 3, 1, 2), dw, db


class _GroupNormActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        y, mr = _launch_forward(x, weight, bias, num_groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mr)
        ctx.silu = silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mr = ctx.saved_tensors
        need = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dw, db = group_norm_act_backward(x, dy, weight, bias, mr, ctx.silu, need)
        return (dx, dw.to(weight.dtype) if ctx.needs_input_grad[1] else None,
                db.to(bias.dtype) if ctx.needs_input_grad[2] else None, None, None, None)


def group_norm_act(x, weight, bias, num_groups: int, eps: float = 1e-6, silu: bool = False):
    """K1 forward wrapper: GroupNorm(num_groups, eps) with affine, then SiLU
    when ``silu``.  x is (B, C, H, W) float32 or bfloat16."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, num_groups, eps, silu)
    return _GroupNormActFn.apply(x, weight, bias, num_groups, eps, silu)


group_norm_act.launches = 0
group_norm_act_backward.launches = 0
group_norm_act_backward.dy_copies = 0     # calls whose dy came in another layout or dtype
