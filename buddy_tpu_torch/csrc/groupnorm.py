"""K1 — GroupNorm(+SiLU) forward and backward as Triton kernels.

Replaces the Pallas pair of ``scripts/tpu_pallas_gn_probe.py`` (``pallas_gn``:
``_stats_kernel`` :39, ``_norm_kernel`` :55), which computes what
``buddy_tpu/models/layers.py::GroupNormAct`` computes on the main path.

Layout: x is (B, HW, C) contiguous — an NCHW tensor in channels_last memory
format — in bfloat16 or float32; statistics are float32.

What bounds it on the H100: memory.  Each pass does a handful of FLOPs per
element, far below the ridge, so the least time is the bytes over 3.35 TB/s.
The forward reads x twice (statistics, then normalise) and writes y once;
the backward reads x and dy twice and writes dx once.  The TPU kernel carried
its sums across a sequential grid; here blocks run in parallel with no order,
so each program reduces a slab of rows into registers and writes one partial
row per (b, slab) — a two-level reduction without atomics, deterministic.
The (B, G) group statistics from those partials are a few thousand numbers
and are formed in PyTorch between the passes.
"""

import triton
import triton.language as tl


@triton.jit
def gn_stats_kernel(x_ptr, part_ptr, HW, C, ROWS,
                    BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
    """part[b, slab, 0, c] = sum x, part[b, slab, 1, c] = sum x^2 over the
    slab's rows."""
    b = tl.program_id(0).to(tl.int64)
    slab = tl.program_id(1)
    n_slabs = tl.num_programs(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    s1 = tl.zeros((BLOCK_C,), tl.float32)
    s2 = tl.zeros((BLOCK_C,), tl.float32)
    base = x_ptr + b * HW * C
    for start in range(0, ROWS, BLOCK_HW):
        rows = slab * ROWS + start + tl.arange(0, BLOCK_HW)
        mask = (rows[:, None] < HW) & cmask[None, :]
        x = tl.load(base + rows[:, None].to(tl.int64) * C + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        s1 += tl.sum(x, axis=0)
        s2 += tl.sum(x * x, axis=0)
    out = part_ptr + (b * n_slabs + slab) * 2 * C
    tl.store(out + cols, s1, mask=cmask)
    tl.store(out + C + cols, s2, mask=cmask)


@triton.jit
def gn_apply_kernel(x_ptr, y_ptr, a_ptr, sh_ptr, HW, C,
                    BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr, SILU: tl.constexpr):
    """y = x * a[b, c] + sh[b, c], then SiLU when asked."""
    b = tl.program_id(0).to(tl.int64)
    rows = tl.program_id(1) * BLOCK_HW + tl.arange(0, BLOCK_HW)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
    sh = tl.load(sh_ptr + b * C + cols, mask=cmask, other=0.0)
    mask = (rows[:, None] < HW) & cmask[None, :]
    offs = b * HW * C + rows[:, None].to(tl.int64) * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * a[None, :] + sh[None, :]
    if SILU:
        y = y * tl.sigmoid(y)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def _pre_activation_grad(x, dy, a, sh, SILU: tl.constexpr):
    if SILU:
        u = x * a[None, :] + sh[None, :]
        s = tl.sigmoid(u)
        dy = dy * (s * (1.0 + u * (1.0 - s)))
    return dy


@triton.jit
def gn_bwd_stats_kernel(x_ptr, dy_ptr, a_ptr, sh_ptr, part_ptr, HW, C, ROWS,
                        BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr, SILU: tl.constexpr):
    """part[b, slab, 0, c] = sum du, part[b, slab, 1, c] = sum du * x, with
    du the gradient at the pre-activation."""
    b = tl.program_id(0).to(tl.int64)
    slab = tl.program_id(1)
    n_slabs = tl.num_programs(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
    sh = tl.load(sh_ptr + b * C + cols, mask=cmask, other=0.0)
    s1 = tl.zeros((BLOCK_C,), tl.float32)
    s2 = tl.zeros((BLOCK_C,), tl.float32)
    for start in range(0, ROWS, BLOCK_HW):
        rows = slab * ROWS + start + tl.arange(0, BLOCK_HW)
        mask = (rows[:, None] < HW) & cmask[None, :]
        offs = b * HW * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        du = _pre_activation_grad(x, dy, a, sh, SILU)
        s1 += tl.sum(du, axis=0)
        s2 += tl.sum(du * x, axis=0)
    out = part_ptr + (b * n_slabs + slab) * 2 * C
    tl.store(out + cols, s1, mask=cmask)
    tl.store(out + C + cols, s2, mask=cmask)


@triton.jit
def gn_bwd_apply_kernel(x_ptr, dy_ptr, dx_ptr, a_ptr, sh_ptr, c2_ptr, c3_ptr, HW, C,
                        BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr, SILU: tl.constexpr):
    """dx = a * du + c2 * x + c3 (per-(b, c) coefficients from the group sums)."""
    b = tl.program_id(0).to(tl.int64)
    rows = tl.program_id(1) * BLOCK_HW + tl.arange(0, BLOCK_HW)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0)
    sh = tl.load(sh_ptr + b * C + cols, mask=cmask, other=0.0)
    c2 = tl.load(c2_ptr + b * C + cols, mask=cmask, other=0.0)
    c3 = tl.load(c3_ptr + b * C + cols, mask=cmask, other=0.0)
    mask = (rows[:, None] < HW) & cmask[None, :]
    offs = b * HW * C + rows[:, None].to(tl.int64) * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    du = _pre_activation_grad(x, dy, a, sh, SILU)
    dx = a[None, :] * du + c2[None, :] * x + c3[None, :]
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
