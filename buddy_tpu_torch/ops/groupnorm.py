"""GroupNorm with an optional fused SiLU, and kernel K1 (Triton).

Semantics (``buddy_tpu/models/layers.py::GroupNormAct``): groups over
contiguous channel blocks, statistics in float32 from per-channel first and
second moments (var = E[x^2] - E[x]^2), eps inside the rsqrt, affine, then
SiLU when asked.  Input is NCHW; the kernel wants it in channels_last memory
format, which is how the U-Net keeps its activations.

K1 (``csrc/groupnorm.py``) is a statistics pass plus a normalise pass
forward, and the same two passes backward.  ``group_norm_act`` is the
forward wrapper and ``group_norm_act_backward`` the backward one; each counts
its launches, one per launch of its pair of kernels.  CPU tensors take the
plain PyTorch version (autograd differentiates it); CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ROW_SLABS = 64  # statistics partials per utterance (two-level reduction)


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


def _as_bhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> its channels_last storage viewed as (B, HW, C)."""
    t = t.contiguous(memory_format=torch.channels_last)
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _launch_config(HW: int, C: int):
    import triton
    block_c = triton.next_power_of_2(C)
    block_hw = max(16, 8192 // block_c)
    rows = triton.cdiv(triton.cdiv(HW, _ROW_SLABS), block_hw) * block_hw
    return block_c, block_hw, rows, triton.cdiv(HW, rows)


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"group_norm_act: expected a 4-D float32/bfloat16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_forward(x, weight, bias, num_groups, eps, silu):
    from buddy_tpu_torch.csrc import groupnorm as K
    _check(x)
    B, C, H, W = x.shape
    xv = _as_bhwc(x)
    HW = H * W
    block_c, block_hw, rows, n_slabs = _launch_config(HW, C)
    part = torch.empty((B, n_slabs, 2, C), device=x.device, dtype=torch.float32)
    K.gn_stats_kernel[(B, n_slabs)](xv, part, HW, C, rows,
                                   BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4)
    s = part.sum(1)
    mean, rstd = _group_stats(s[:, 0], s[:, 1], num_groups, HW * (C // num_groups), eps)
    a, sh = _affine(mean, rstd, weight, bias, C)
    a, sh = a.contiguous(), sh.contiguous()
    y = torch.empty_like(xv)
    K.gn_apply_kernel[(B, (HW + block_hw - 1) // block_hw)](
        xv, y, a, sh, HW, C, BLOCK_HW=block_hw, BLOCK_C=block_c, SILU=silu, num_warps=4)
    group_norm_act.launches += 1
    return y.view(B, H, W, C).permute(0, 3, 1, 2), mean, rstd, a, sh


def group_norm_act_backward(x, dy, weight, mean, rstd, a, sh, silu: bool):
    """K1 backward: (dx, d weight, d bias) of y = act(GN(x)) given dy."""
    from buddy_tpu_torch.csrc import groupnorm as K
    _check(dy)
    B, C, H, W = x.shape
    G = mean.shape[1]
    HW = H * W
    xv, dyv = _as_bhwc(x), _as_bhwc(dy.to(x.dtype))
    block_c, block_hw, rows, n_slabs = _launch_config(HW, C)
    part = torch.empty((B, n_slabs, 2, C), device=x.device, dtype=torch.float32)
    K.gn_bwd_stats_kernel[(B, n_slabs)](xv, dyv, a, sh, part, HW, C, rows,
                                       BLOCK_HW=block_hw, BLOCK_C=block_c, SILU=silu,
                                       num_warps=4)
    s = part.sum(1)
    s_du, s_dux = s[:, 0], s[:, 1]                                  # (B, C)
    count = HW * (C // G)
    w = weight.float()[None, :]
    rep = lambda t: t.repeat_interleave(C // G, 1)                   # (B, G) -> (B, C)
    grp = lambda t: t.view(B, G, C // G).sum(-1)                     # (B, C) -> (B, G)
    m1 = grp(w * s_du) / count
    m2 = rstd * grp(w * (s_dux - rep(mean) * s_du)) / count
    c2 = rep(-rstd * rstd * m2).contiguous()
    c3 = rep(-rstd * m1 + mean * rstd * rstd * m2).contiguous()
    dx = torch.empty_like(xv)
    K.gn_bwd_apply_kernel[(B, (HW + block_hw - 1) // block_hw)](
        xv, dyv, dx, a, sh, c2, c3, HW, C,
        BLOCK_HW=block_hw, BLOCK_C=block_c, SILU=silu, num_warps=4)
    group_norm_act_backward.launches += 1
    d_weight = (rep(rstd) * (s_dux - rep(mean) * s_du)).sum(0)
    d_bias = s_du.sum(0)
    return dx.view(B, H, W, C).permute(0, 3, 1, 2), d_weight, d_bias


class _GroupNormActFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        y, mean, rstd, a, sh = _launch_forward(x, weight, bias, num_groups, eps, silu)
        ctx.save_for_backward(x, weight, mean, rstd, a, sh)
        ctx.silu = silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd, a, sh = ctx.saved_tensors
        dx, dw, db = group_norm_act_backward(x, dy, weight, mean, rstd, a, sh, ctx.silu)
        return (dx, dw.to(weight.dtype) if ctx.needs_input_grad[1] else None,
                db.to(weight.dtype) if ctx.needs_input_grad[2] else None, None, None, None)


def group_norm_act(x, weight, bias, num_groups: int, eps: float = 1e-6, silu: bool = False):
    """K1 forward wrapper: GroupNorm(num_groups, eps) with affine, then SiLU
    when ``silu``.  x is (B, C, H, W) float32 or bfloat16."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, num_groups, eps, silu)
    return _GroupNormActFn.apply(x, weight, bias, num_groups, eps, silu)


group_norm_act.launches = 0
group_norm_act_backward.launches = 0
