"""int8 convolution with straight-through gradients, and kernel K10 (CUDA,
``csrc/qconv.cu``): the counterpart of ``buddy_tpu/ops/qconv.py``.

Scheme (the JAX package's): activations quantized symmetrically to
[-127, 127] with one scale a tensor, computed per call from max|x|
(dynamic) or calibrated (static; a per-input-channel calibration is
balanced, smooth-quant style, between the activations and the weights);
weights with one scale an output channel; the int8 x int8 convolution
summed exactly in int32; a dequant epilogue in the input's dtype.  The
backward is straight-through: the adjoints of the unquantized float
convolution on x and the original weight.  With ``bwd_quant`` the input
adjoint of the unfused convolutions (stride 1, no lhs dilation) runs int8
as well.

Kinds of convolution (weights OIHW; activations NCHW in channels_last
memory, which is the NHWC storage the kernels read):

    "3x3"    3x3, pad 1            "1x1"    1x1
    "up3x3"  3x3 after nearest-up2: the derived 4x4 over the lhs-dilated
             input, pads 2 (ops/resample.py), as four output phases of 2x2
    "up1x1"  1x1 after nearest-up2: the derived 2x2, pads 1, as one 1x1 of
             the half-resolution input written to each 2x2 output block

The arithmetic follows the JAX package's functions as XLA compiles them
under jit on the CPU, bit for bit (tests/test_torch_int8.py):

* ``v / 127.0 + eps`` is a multiply by the float32 reciprocal of 127 fused
  with the add (``scale_from_max``);
* ``inv_x = (1 / s_x)`` is rounded to x's dtype, ``x * inv_x`` is computed
  and rounded in x's dtype, ``round`` is half to even;
* weights are quantized in float32 by a true division, ``round(w32 / s_w)``;
* the epilogue rounds the exact int32 sum once to x's dtype, whatever the
  accumulation dtype: XLA sums int8 products exactly whatever
  ``preferred_element_type`` says, and with float32 activations it drops
  the "bfloat16" mode's rounding of the sum (excess precision), so the
  three modes give the same bits; it then multiplies by the scale and
  adds the bias with a rounding after each in bfloat16, in one FMA in
  float32.

CPU tensors take the plain versions below; CUDA tensors launch the kernels
or raise.  Each wrapper counts its C calls in ``.launches``.  Quantized
weights depend on the weight (and on the calibrated scales) only, so a
conv module computes them once per version of those tensors and keeps
them (``cached``), as the JAX package's weight quantization is hoisted out
of the sampling loop.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.ops import _build
from buddy_tpu_torch.ops.resample import lhs_dilated_conv, up2_derived

EPS = 1e-12
R127 = float(np.float32(1.0) / np.float32(127.0))     # XLA's constant for "/ 127.0"
ACCUM = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}
KINDS = ("3x3", "1x1", "up3x3", "up1x1")

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "qc_absmax_parts": [_L],
    "qc_quantize": [_P, _P, _L, _I, _I, _P, _I, _P, _P, _P],
    "qc_weight": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qc_conv": [_P] * 6 + [_I] * 9 + [_P, _I, _I, _P],
}


# ---------------------------------------------------------------------------
# scales
# ---------------------------------------------------------------------------
def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Fused multiply-add of float32 tensors, rounded once, as XLA's fused
    ``a * b + c``: the exact product in float64, the sum rounded to odd in
    float64 (TwoSum), then to float32, which rounds it correctly."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32, device=a.device).double()
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def scale_from_max(m: torch.Tensor) -> torch.Tensor:
    """max / 127 + 1e-12 in float32, as XLA computes it."""
    return fma_f32(m.float(), R127, EPS)


def balanced_scales(a_scale: torch.Tensor) -> torch.Tensor:
    """Calibrated per-channel maxima -> the activations' share of their
    spread, sqrt(max(a, 1e-12) * max(a)) (the weights absorb the rest)."""
    a = a_scale.float()
    return torch.sqrt(torch.clamp(a, min=1e-12) * a.max())


def static_scale(a_scale: torch.Tensor) -> torch.Tensor:
    """s_x of a calibrated scale: a scalar as it is, a (C,) vector
    balanced first."""
    return scale_from_max(a_scale if a_scale.dim() == 0 else balanced_scales(a_scale))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def quantize_act_plain(x: torch.Tensor, s_x: torch.Tensor | None = None):
    """x (B, C, H, W) -> (x_q (B, H, W, C) int8, s_x float32): one scale
    from max|x| when ``s_x`` is None, else the given scalar or (C,) scales."""
    if s_x is None:
        s_x = scale_from_max(x.abs().max())
    inv = (1.0 / s_x.float()).to(x.dtype)
    q = torch.round(_nhwc(x) * inv).clamp_(-127, 127).to(torch.int8)
    return q.contiguous(), s_x


def quantize_weight_plain(w: torch.Tensor, in_scale: torch.Tensor | None = None):
    """w (O, I, kh, kw) float32 [times in_scale (I,) on its input channels]
    -> (w_q (kh * kw, O, I) int8, s_w (O,) float32)."""
    w32 = w.float()
    if in_scale is not None:
        w32 = w32 * in_scale.float()[None, :, None, None]
    s_w = scale_from_max(w32.abs().amax(dim=(1, 2, 3)))
    q = torch.round(w32 / s_w[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return q.permute(2, 3, 0, 1).reshape(-1, w.shape[0], w.shape[1]).contiguous(), s_w


_KSIZE = {"3x3": 3, "1x1": 1, "up3x3": 4, "up1x1": 2}


def unpack_weight(w_q: torch.Tensor, kind: str) -> torch.Tensor:
    """(kh * kw, O, I) -> (O, I, kh, kw)."""
    k = _KSIZE[kind]
    return w_q.reshape(k, k, w_q.shape[1], w_q.shape[2]).permute(2, 3, 0, 1)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, kind: str) -> torch.Tensor:
    """The int8 convolution's exact int32 sums, (B, Ho, Wo, O): a float64
    convolution (every partial sum is an integer below 2^53, so it is
    exact) on the library's direct route, cast to int32."""
    x = x_q.permute(0, 3, 1, 2).double()
    w = unpack_weight(w_q, kind).double()
    with torch.backends.cudnn.flags(enabled=False):
        if kind.startswith("up"):
            y = lhs_dilated_conv(x, w)
        else:
            y = F.conv2d(x, w, padding=_KSIZE[kind] // 2)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def dequant_plain(acc: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """int32 sums -> ``dtype`` (rounded once, in every accumulation mode:
    see the module's docstring), times the per-C_out ``scale``, plus
    ``bias``; the last axis is C_out."""
    y = acc.float().to(dtype)
    if dtype == torch.float32 and bias is not None:
        return fma_f32(y, scale, bias.float())
    y = y * scale.to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _lib():
    return _build.load("qconv", _SIGNATURES)


def _check_float(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"{what}: expected a 4-D float32/bfloat16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def quantize_act(x: torch.Tensor, s_x: torch.Tensor | None = None):
    """K10's activation quantization: x (B, C, H, W) -> (x_q (B, H, W, C)
    int8, s_x).  Dynamic when ``s_x`` is None (s_x comes back as a 0-d
    float32 tensor on the device), else the given scalar or (C,) scales."""
    if x.device.type == "cpu":
        return quantize_act_plain(x, s_x)
    _check_float(x, "quantize_act")
    B, C, H, W = x.shape
    xv = _nhwc(x.contiguous(memory_format=torch.channels_last))
    xq = torch.empty((B, H, W, C), dtype=torch.int8, device=x.device)
    lib = _lib()
    n = xv.numel()
    per_channel = 0
    part = out = None
    if s_x is None:
        part = torch.empty(lib.qc_absmax_parts(n), dtype=torch.float32, device=x.device)
        out = s_x = torch.empty((), dtype=torch.float32, device=x.device)
        sx_ptr = None
    else:
        s_x = s_x.float().contiguous()
        if s_x.dim() == 1:
            if s_x.numel() != C:
                raise ValueError(f"quantize_act: {s_x.numel()} scales for {C} channels")
            per_channel = 1
        sx_ptr = _build.ptr(s_x)
    err = lib.qc_quantize(_build.ptr(xv), _build.ptr(xq), n, C, int(x.dtype == torch.bfloat16),
                          sx_ptr, per_channel, None if part is None else _build.ptr(part),
                          None if out is None else _build.ptr(out), _build.stream(x.device))
    _build.check(err, "qc_quantize")
    quantize_act.launches += 1
    return xq, s_x


def quantize_weight(w: torch.Tensor, in_scale: torch.Tensor | None = None):
    """K10's weight quantization: w (O, I, kh, kw) float32 [times in_scale
    (I,)] -> (w_q (kh * kw, O, I) int8, s_w (O,) float32)."""
    if w.device.type == "cpu":
        return quantize_weight_plain(w, in_scale)
    if w.dim() != 4 or w.device.type != "cuda":
        raise ValueError(f"quantize_weight: expected a 4-D CUDA tensor, got {tuple(w.shape)} "
                         f"on {w.device}")
    O, I, kh, kw = w.shape
    if in_scale is not None and in_scale.numel() != I:
        raise ValueError(f"quantize_weight: {in_scale.numel()} input scales for {I} channels")
    w32 = w.float().contiguous()
    s = None if in_scale is None else in_scale.float().contiguous()
    wq = torch.empty((kh * kw, O, I), dtype=torch.int8, device=w.device)
    sw = torch.empty(O, dtype=torch.float32, device=w.device)
    err = _lib().qc_weight(_build.ptr(w32), None if s is None else _build.ptr(s), _build.ptr(wq),
                           _build.ptr(sw), O, I, kh * kw, _build.stream(w.device))
    _build.check(err, "qc_weight")
    quantize_weight.launches += 1
    return wq, sw


def tap_table(kind: str) -> tuple[int, int, bool, list]:
    """(phases, taps a phase, replicate, [(dy, dx, packed index)] phase-major):
    each output phase of the kind as a stride-1 convolution of the input."""
    if kind == "3x3":
        return 1, 9, False, [(ky - 1, kx - 1, ky * 3 + kx) for ky in range(3) for kx in range(3)]
    if kind == "1x1":
        return 1, 1, False, [(0, 0, 0)]
    if kind == "up1x1":
        # every tap of the derived 2x2 is the 1x1 kernel: the phases' sums are equal
        return 1, 1, True, [(0, 0, 3)]
    if kind == "up3x3":
        # output row 2p + r reads input rows p + (r + a - 2) / 2 through K4[a] for a = r, r + 2
        taps = []
        for r in (0, 1):
            for s in (0, 1):
                for a in (r, r + 2):
                    for b in (s, s + 2):
                        taps.append(((r + a - 2) // 2, (s + b - 2) // 2, a * 4 + b))
        return 4, 4, False, taps
    raise ValueError(f"unknown convolution kind {kind!r}")


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, kind: str, *,
              out_dtype: torch.dtype = torch.bfloat16,
              s_x: torch.Tensor | None = None, bias: torch.Tensor | None = None,
              raw: bool = False) -> torch.Tensor:
    """K10's convolution: x_q (B, H, W, C_in) int8, w_q (kh * kw, C_out,
    C_in) int8 -> y (B, C_out, Ho, Wo) in ``out_dtype`` (channels_last
    memory), dequantized with s_x * s_w (or s_w alone when ``s_x`` is None)
    and ``bias``; with ``raw`` the exact int32 sums (B, Ho, Wo, C_out)."""
    if x_q.device.type == "cpu":
        acc = int8_conv_plain(x_q, w_q, kind)
        if raw:
            return acc
        scale = s_w if s_x is None else s_x.float() * s_w
        return dequant_plain(acc, out_dtype, scale, bias).permute(0, 3, 1, 2)
    if x_q.device.type != "cuda" or x_q.dtype != torch.int8 or x_q.dim() != 4 or \
            w_q.dtype != torch.int8 or w_q.shape[2] != x_q.shape[3]:
        raise ValueError(f"int8_conv: expected int8 CUDA tensors (B, H, W, C) and (KK, O, C), "
                         f"got {x_q.dtype} {tuple(x_q.shape)}, {w_q.dtype} {tuple(w_q.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv: out_dtype {out_dtype}")
    phases, ntaps, replicate, taps = tap_table(kind)
    if w_q.shape[0] != _KSIZE[kind] ** 2:
        raise ValueError(f"int8_conv: {w_q.shape[0]} packed taps for a {kind} convolution")
    B, H, W, Cin = x_q.shape
    Cout = w_q.shape[1]
    if s_w.numel() != Cout or (bias is not None and bias.numel() != Cout) or \
            (s_x is not None and s_x.numel() != 1):
        raise ValueError(f"int8_conv: s_w {tuple(s_w.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)} and s_x for {Cout} "
                         "output channels and one activation scale")
    up = kind.startswith("up")
    Ho, Wo = (2 * H, 2 * W) if up else (H, W)
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    y = torch.empty((B, Ho, Wo, Cout), device=x_q.device,
                    dtype=torch.int32 if raw else out_dtype)
    sw = s_w.float().contiguous()
    sx = None if s_x is None else s_x.float().reshape(()).contiguous()
    b = None if bias is None else bias.float().contiguous()
    table = (ctypes.c_int * (3 * len(taps)))(*[v for t in taps for v in t])
    mode = 0 if raw else (1 if out_dtype == torch.bfloat16 else 2)
    round_bf16 = int(out_dtype == torch.bfloat16)
    opt = lambda t: None if t is None else _build.ptr(t)
    err = _lib().qc_conv(_build.ptr(x_q), _build.ptr(w_q), _build.ptr(y), _build.ptr(sw), opt(sx),
                         opt(b), B, H, W, Cin, Cout, int(up), int(replicate), phases, ntaps,
                         ctypes.cast(table, ctypes.c_void_p), mode, round_bf16,
                         _build.stream(x_q.device))
    _build.check(err, "qc_conv")
    int8_conv.launches += 1
    return y if raw else y.permute(0, 3, 1, 2)


quantize_act.launches = 0
quantize_weight.launches = 0
int8_conv.launches = 0


# ---------------------------------------------------------------------------
# tensors derived from the weights, once per version
# ---------------------------------------------------------------------------
def cached(cache: dict | None, key: tuple, deps, make):
    """``make()``, kept in ``cache`` (a dict its owner, a conv module, holds)
    while each tensor of ``deps`` is the same tensor at the same
    ``_version``; without a cache, computed anew."""
    if cache is None:
        return make()
    entry = cache.get(key)
    if entry is not None and all(r() is t and v == t._version
                                 for (r, v), t in zip(entry[0], deps)):
        return entry[1]
    value = make()
    cache[key] = ([(weakref.ref(t), t._version) for t in deps], value)
    return value


def _derived(w: torch.Tensor, kind: str) -> torch.Tensor:
    """The float32 kernel a kind applies: the original, or the derived
    lhs-dilated kernel of the fused kinds."""
    w = w.float()
    return up2_derived(w) if kind.startswith("up") else w


def float_weight(weight: torch.Tensor, kind: str, dtype: torch.dtype, cache=None):
    """The kernel a kind applies, cast to ``dtype`` (cached while the
    weight needs no gradient)."""
    make = lambda: _derived(weight, kind).to(dtype)
    if torch.is_grad_enabled() and weight.requires_grad:
        return make()
    return cached(cache, ("float", kind, dtype), [weight], lambda: make().detach())


def static_sx(a_scale: torch.Tensor, cache=None) -> torch.Tensor:
    return cached(cache, ("sx",), [a_scale], lambda: static_scale(a_scale.detach()))


def quantized_weight(weight: torch.Tensor, kind: str, a_scale: torch.Tensor | None = None,
                     adjoint: bool = False, cache=None):
    """(w_q, s_w) of a kind's kernel, the balanced calibrated scales folded
    in when ``a_scale`` is a (C_in,) vector; ``adjoint``: the input
    adjoint's kernel, flipped with its in/out axes swapped."""
    fold = a_scale is not None and a_scale.dim() == 1

    def make():
        w = weight.detach().float()
        if adjoint:
            w = w.transpose(0, 1).flip(2, 3)
        return quantize_weight(_derived(w, kind).contiguous(),
                               static_sx(a_scale, cache) if fold else None)

    deps = [weight] + ([a_scale] if fold else [])
    return cached(cache, ("w", kind, adjoint, fold), deps, make)


# ---------------------------------------------------------------------------
# the quantized convolution with its straight-through vjp
# ---------------------------------------------------------------------------
def _qconv_forward(x, weight, bias, kind, a_scale, cache):
    if a_scale is not None and a_scale.dim() == 1:
        # per-channel calibrated scales: x sees the balanced share, the
        # weights absorb the rest, the epilogue keeps the per-C_out s_w
        s_x = static_sx(a_scale, cache)
        w_q, s_w = quantized_weight(weight, kind, a_scale, cache=cache)
        x_q, _ = quantize_act(x, s_x)
        return int8_conv(x_q, w_q, s_w, kind, out_dtype=x.dtype, bias=bias)
    x_q, s_x = quantize_act(x, None if a_scale is None else static_sx(a_scale, cache))
    w_q, s_w = quantized_weight(weight, kind, cache=cache)
    return int8_conv(x_q, w_q, s_w, kind, out_dtype=x.dtype, s_x=s_x, bias=bias)


def float_conv(x, weight, bias, kind):
    """The unquantized convolution the straight-through gradients are of."""
    w = _derived(weight, kind).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if kind.startswith("up"):
        return lhs_dilated_conv(x, w, b)
    return F.conv2d(x, w, b, padding=_KSIZE[kind] // 2)


def float_input_grad(g, x, w, kind):
    """dL/dx of ``float_conv`` with the kind's kernel ``w`` in x's dtype: the
    library's input adjoint with the saved x, as autograd calls it (x gives
    the result its memory format)."""
    if kind.startswith("up"):
        k = w.shape[-1]
        return torch.ops.aten.convolution_backward(
            g, x, w.flip(2, 3).transpose(0, 1), None, [2, 2], [k // 2 - 1] * 2, [1, 1], True,
            [0, 0], 1, [True, False, False])[0]
    p = _KSIZE[kind] // 2
    return torch.ops.aten.convolution_backward(g, x, w, None, [1, 1], [p, p], [1, 1], False,
                                               [0, 0], 1, [True, False, False])[0]


class _QConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, a_scale, kind, bwd_quant, cache):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (kind, bwd_quant, cache)
        return _qconv_forward(x, weight, bias, kind, a_scale, cache)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        kind, bwd_quant, cache = ctx.cfg
        g = g.to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if bwd_quant and not kind.startswith("up"):
                # dL/dx = g conv w (flipped, in/out swapped): a stride-1
                # convolution of the same kind, int8
                g_q, s_g = quantize_act(g)
                w_q, s_w = quantized_weight(weight, kind, adjoint=True, cache=cache)
                dx = int8_conv(g_q, w_q, s_w, kind, out_dtype=x.dtype, s_x=s_g)
            else:
                dx = float_input_grad(g, x, float_weight(weight, kind, x.dtype, cache), kind)
        want = [ctx.needs_input_grad[1], bias is not None and ctx.needs_input_grad[2]]
        if any(want):
            with torch.enable_grad():
                w_ = weight.detach().requires_grad_(True)
                b_ = None if bias is None else bias.detach().requires_grad_(True)
                y = float_conv(x.detach(), w_, b_, kind)
                leaves = [t for t, on in zip((w_, b_), want) if on]
                grads = iter(torch.autograd.grad(y, leaves, g))
            dw = next(grads) if want[0] else None
            db = next(grads) if want[1] else None
        return dx, dw, db, None, None, None, None


def quantized_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, kind: str,
                   accum: str = "int32", bwd_quant: bool = False,
                   a_scale: torch.Tensor | None = None, cache: dict | None = None) -> torch.Tensor:
    """The int8 convolution of x (B, C_in, H, W) with the float32 weight
    (C_out, C_in, k, k) of ``kind``, in x's dtype; ``a_scale``: None
    (dynamic), or calibrated maxima (a scalar, or one per input channel);
    ``cache``: a dict of the caller's that keeps the quantized weights
    between calls (see ``cached``).  ``accum`` is checked and changes no bit
    (the module's docstring says why)."""
    if kind not in KINDS:
        raise ValueError(f"unknown convolution kind {kind!r}")
    if accum not in ACCUM:
        raise ValueError(f"accum must be one of {sorted(ACCUM)}, got {accum!r}")
    return _QConvFn.apply(x, weight, bias, a_scale, kind, bwd_quant, cache)


def observe_(a_scale: torch.Tensor, x: torch.Tensor) -> None:
    """Calibration: the running maximum of |x| per input channel (float32)."""
    with torch.no_grad():
        a_scale.copy_(torch.maximum(a_scale, x.detach().abs().amax(dim=(0, 2, 3)).float()))
