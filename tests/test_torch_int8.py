"""Parity of the port's int8 convolutions (``buddy_tpu_torch/ops/qconv.py``,
kernel K10) with the JAX package's ``buddy_tpu/ops/qconv.py`` on the CPU.

The JAX functions run under ``jax.jit``, as the networks run them: XLA then
turns ``v / 127.0 + eps`` into an FMA with the float32 reciprocal of 127
and fuses the float32 dequant multiply and bias add, and the port's plain
versions reproduce that.  Quantized activations and weights, the int32
sums and the dequantized outputs are compared bit for bit; the
straight-through gradients of the float convolution at float32
tolerances; whole networks at the tolerances their tests state.  The CUDA
source itself runs here under a g++ emulation of the card's built-ins
(``tests/cuda_emu/``) against the plain versions, bit for bit.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import TINY_NET, jax_compose, randomize_tree, rel_err, torch_compose

from buddy_tpu.ops import qconv as J
from buddy_tpu_torch.ops import qconv as Q

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# kind -> (JAX kernel size, padding, lhs_dilation)
KINDS = {"3x3": (3, ((1, 1), (1, 1)), (1, 1)), "1x1": (1, ((0, 0), (0, 0)), (1, 1)),
         "up3x3": (4, ((2, 2), (2, 2)), (2, 2)), "up1x1": (2, ((1, 1), (1, 1)), (2, 2))}


def _hwio(w_q, k):
    """The port's packed (k * k, O, I) -> the JAX package's HWIO."""
    w = np.asarray(w_q)
    return w.reshape(k, k, w.shape[1], w.shape[2]).transpose(0, 1, 3, 2)


def _x(rng, shape, scale=3.0):
    """A float32 NHWC array and its port tensor (NCHW view) in ``dtype``."""
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td).permute(0, 3, 1, 2)


def _eq(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return np.array_equal(a, np.asarray(b).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dynamic", "static", "balanced"])
def test_quantize_act_matches_jax(dtype, form):
    """``_quantize_act`` bit for bit: dynamic (one scale from max|x|),
    static per tensor (a calibrated scalar), and per channel with the
    balanced scales quantized_conv forms from calibrated maxima (a dead
    channel included)."""
    rng = np.random.default_rng(1)
    xj, xt = _pair(_x(rng, (2, 6, 7, 16)), dtype)
    a = (np.abs(rng.standard_normal(16)) * 4).astype(np.float32)
    a[3] = 0.0
    if form == "dynamic":
        qj, sj = jax.jit(lambda v: J._quantize_act(v, None))(xj)
        qt, st = Q.quantize_act_plain(xt)
    elif form == "static":
        qj, sj = jax.jit(J._quantize_act)(xj, jnp.float32(2.5))
        qt, st = Q.quantize_act_plain(xt, Q.static_scale(torch.tensor(2.5)))
    else:
        bal = jax.jit(lambda v: jnp.sqrt(jnp.maximum(v, 1e-12) * jnp.max(v)))(jnp.asarray(a))
        assert _eq(Q.balanced_scales(torch.from_numpy(a)), bal)
        qj, sj = jax.jit(J._quantize_act)(xj, bal)
        qt, st = Q.quantize_act_plain(xt, Q.static_scale(torch.from_numpy(a)))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert _eq(st, sj)


@pytest.mark.parametrize("form", ["plain", "folded", "derived"])
def test_quantize_weight_matches_jax(form):
    """``_quantize_w`` bit for bit (w_q and s_w): a 3x3 kernel, the same with
    per-input-channel activation scales folded in, and the derived 4x4
    kernel of the fused up-convolution (derived in float32 on both
    sides)."""
    from buddy_tpu.ops.resample import up2_kernel3x3 as jup
    from buddy_tpu_torch.ops.resample import up2_kernel3x3 as tup
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    s = (np.abs(rng.standard_normal(16)) + 0.1).astype(np.float32) if form == "folded" else None
    if form == "derived":
        wj = jax.jit(jup)(jnp.asarray(w))
        wt = tup(wt)
        assert np.array_equal(wt.permute(2, 3, 1, 0).numpy(), np.asarray(wj))
    else:
        wj = jnp.asarray(w)
    qj, sj = jax.jit(J._quantize_w)(wj, None if s is None else jnp.asarray(s))
    qt, st = Q.quantize_weight_plain(wt, None if s is None else torch.from_numpy(s))
    assert np.array_equal(_hwio(qt, wt.shape[-1]), np.asarray(qj))
    assert _eq(st, sj)


@pytest.mark.parametrize("cin", [8, 256])
@pytest.mark.parametrize("kind", list(KINDS))
def test_int8_conv_int32_matches_jax(kind, cin):
    """The int8 convolution's int32 sums equal ``_int8_conv``'s (int32
    accumulation) at 1x1, 3x3 and the lhs-dilated 4x4 (pads 2) and 2x2
    (pads 1) of the fused forms.  At C_in = 256 the data are near +127,
    so the sums pass 2^24 where float32 would round (shown at 3x3)."""
    k, pads, ld = KINDS[kind]
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=(2, 5, 6, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k * k, 12, cin)).astype(np.int8)
    if cin == 256:
        xq, wq = np.where(np.abs(xq) < 100, 127, np.abs(xq)), np.where(np.abs(wq) < 100, 127,
                                                                        np.abs(wq))
        xq, wq = xq.astype(np.int8), wq.astype(np.int8)
    one = jnp.ones((), jnp.int32)
    yj = np.asarray(jax.jit(lambda a, b: J._int8_conv(a, b, (1, 1), pads, "int32", jnp.int32, one,
                                                      ld))(jnp.asarray(xq),
                                                           jnp.asarray(_hwio(wq, k))))
    yt = Q.int8_conv_plain(torch.from_numpy(xq), torch.from_numpy(wq), kind).numpy()
    assert np.array_equal(yt, yj)
    if cin == 256 and kind == "3x3":
        assert yj.max() > 2 ** 24
        y32 = torch.nn.functional.conv2d(
            torch.from_numpy(xq).permute(0, 3, 1, 2).float(),
            Q.unpack_weight(torch.from_numpy(wq), kind).float(), padding=1)
        assert not np.array_equal(y32.permute(0, 2, 3, 1).numpy(), yj)


def _jax_qconv(kind, accum, bwd_quant, x, w, b, a):
    k, pads, ld = KINDS[kind]
    if kind == "up3x3":
        from buddy_tpu.ops.resample import up2_kernel3x3
        w = up2_kernel3x3(w)
    elif kind == "up1x1":
        from buddy_tpu.ops.resample import up2_kernel1x1
        w = up2_kernel1x1(w)
    return J.quantized_conv((1, 1), pads, accum, bwd_quant, ld, x, w, b, a)


def _weights(rng, kind, cin, cout):
    k = 3 if kind.endswith("3x3") else 1
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", ["int32", "bfloat16", "float32"])
def test_quantized_conv_matches_jax(accum, dtype):
    """``quantized_conv`` (quantize, int8 conv, dequant epilogue, bias) bit
    for bit against the JAX package's, for every kind, dynamic and with
    calibrated per-channel scales (balanced and folded into the weights)."""
    rng = np.random.default_rng(4)
    x = _x(rng, (2, 5, 6, 16), 2.0)
    xj, xt = _pair(x, dtype)
    a = (np.abs(x).max(axis=(0, 1, 2)) * rng.uniform(0.5, 1.5, 16)).astype(np.float32)
    for kind in KINDS:
        w, b = _weights(rng, kind, 16, 8)
        wt, bt = torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b)
        for static in (False, True):
            aj = jnp.asarray(a) if static else None
            yj = jax.jit(lambda v, ww, bb, aa: _jax_qconv(kind, accum, False, v, ww, bb, aa))(
                xj, jnp.asarray(w), jnp.asarray(b), aj)
            yt = Q.quantized_conv(xt, wt, bt, kind, accum,
                                  a_scale=torch.from_numpy(a) if static else None)
            assert yt.dtype == DTYPES[dtype][1]
            assert _eq(yt.permute(0, 2, 3, 1), yj), (kind, static)


@pytest.mark.parametrize("bwd_quant", [False, True])
def test_ste_gradients_match_jax(bwd_quant):
    """The straight-through vjp, float32: dx, dw and db are the adjoints of
    the unquantized convolution on x and the original weight (1e-5 of the
    peak: float32 convolutions summed in other orders), for every kind;
    with ``bwd_quant`` the unfused kinds' dx is the int8 adjoint (the
    quantized cotangent through the flipped, transposed kernel), bit for
    bit, and the fused kinds keep the float dx."""
    rng = np.random.default_rng(5)
    x = _x(rng, (2, 5, 6, 16), 1.0)
    for kind in KINDS:
        w, b = _weights(rng, kind, 16, 8)
        up = kind.startswith("up")
        g = rng.standard_normal((2, 10 if up else 5, 12 if up else 6, 8)).astype(np.float32)
        f = lambda v, ww, bb: _jax_qconv(kind, "int32", bwd_quant, v, ww, bb, None)
        dj = jax.jit(lambda v, ww, bb, gg: jax.vjp(f, v, ww, bb)[1](gg))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(g))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        y = Q.quantized_conv(xt, wt, bt, kind, bwd_quant=bwd_quant)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        dx, dw, db = (xt.grad.permute(0, 2, 3, 1).numpy(), wt.grad.permute(2, 3, 1, 0).numpy(),
                      bt.grad.numpy())
        if bwd_quant and not up:
            assert np.array_equal(dx, np.asarray(dj[0])), kind
        else:
            assert rel_err(dx, np.asarray(dj[0])) < 1e-5, kind
        assert rel_err(dw, np.asarray(dj[1])) < 1e-5, kind
        assert rel_err(db, np.asarray(dj[2])) < 1e-5, kind


# ---------------------------------------------------------------------------
# the CUDA source under the CPU emulation
# ---------------------------------------------------------------------------
def _emulated_library(tmp_path):
    """csrc/qconv.cu compiled by g++ onto tests/cuda_emu, as a ctypes CDLL:
    the PTX primitives come from qconv_emu.h, static shared variables become
    per-block storage, launches the emulated launch."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be emulated")
    src = open(os.path.join(os.path.dirname(Q.__file__), "..", "csrc", "qconv.cu")).read()
    src = src.replace("#include <cuda_bf16.h>\n", "").replace(
        "#include <cuda_runtime.h>",
        '#define QCONV_EMULATION\n#include "cuda_emu.h"\n#include "qconv_emu.h"')
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::smem());", src)
    ids = iter(range(1000))
    src = re.sub(r"__shared__ (\w+) (\w+)\[(\w+)\];",
                 lambda m: f"{m[1]}* {m[2]} = emu::static_shared<{m[1]}>({next(ids)}, {m[3]});",
                 src)
    src = re.sub(r"__shared__ (\w+) (\w+);",
                 lambda m: f"{m[1]}& {m[2]} = *emu::static_shared<{m[1]}>({next(ids)}, 1);", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(([^;]*)\);",
                 lambda m: (f"emu::launch(dim3({m.group(2)}), dim3({m.group(3)}), {m.group(4)}, "
                            f"[&] {{ {m.group(1)}({m.group(6)}); }});"), src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src
    cpp, lib = tmp_path / "qconv_emu.cpp", tmp_path / "libqconv_emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                    "-ffp-contract=off", "-I", EMU_DIR, "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    for fn, argtypes in Q._SIGNATURES.items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = ctypes.c_int
    return so


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _emu_quantize(so, x, s_x=None):
    B, C, H, W = x.shape
    xv = x.permute(0, 2, 3, 1).contiguous()
    xq = torch.empty((B, H, W, C), dtype=torch.int8)
    part, out = torch.empty(so.qc_absmax_parts(xv.numel())), torch.empty(())
    dyn = s_x is None
    err = so.qc_quantize(_ptr(xv), _ptr(xq), xv.numel(), C, int(x.dtype == torch.bfloat16),
                         None if dyn else _ptr(s_x), int(not dyn and s_x.dim() == 1),
                         _ptr(part) if dyn else None, _ptr(out) if dyn else None, None)
    assert err == 0
    return xq, out if dyn else s_x


def _emu_weight(so, w, in_scale=None):
    O, I, kh, kw = w.shape
    wq, sw = torch.empty((kh * kw, O, I), dtype=torch.int8), torch.empty(O)
    assert so.qc_weight(_ptr(w), None if in_scale is None else _ptr(in_scale), _ptr(wq), _ptr(sw),
                        O, I, kh * kw, None) == 0
    return wq, sw


def _emu_conv(so, xq, wq, sw, kind, dtype, s_x=None, bias=None, raw=False):
    phases, ntaps, replicate, taps = Q.tap_table(kind)
    B, H, W, Cin = xq.shape
    Cout, up = wq.shape[1], kind.startswith("up")
    y = torch.empty((B, 2 * H if up else H, 2 * W if up else W, Cout),
                    dtype=torch.int32 if raw else dtype)
    table = (ctypes.c_int * (3 * len(taps)))(*[v for t in taps for v in t])
    sx = None if s_x is None else s_x.reshape(()).contiguous()
    err = so.qc_conv(_ptr(xq), _ptr(wq), _ptr(y), _ptr(sw), None if sx is None else _ptr(sx),
                     None if bias is None else _ptr(bias), B, H, W, Cin, Cout, int(up),
                     int(replicate), phases, ntaps, ctypes.cast(table, ctypes.c_void_p),
                     0 if raw else (1 if dtype == torch.bfloat16 else 2),
                     int(dtype == torch.bfloat16), None)
    assert err == 0
    return y


def test_cuda_source_under_emulation(tmp_path):
    """csrc/qconv.cu under the g++ emulation against the plain versions, bit
    for bit: quantized activations (dynamic and per channel), weights (plain
    and folded), int32 sums, and the dequantized outputs with and without a
    bias, at each kind; C_in = 8 and 24 take the bytewise
    loads, 48 the 16-byte copies; 144 pixels (two M tiles) and C_out = 136
    (two N tiles) reach the edges of the tiles.  (The emulation runs a
    thread per CUDA thread, so the grids stay at 1024 threads.)"""
    so = _emulated_library(tmp_path)
    rng = np.random.default_rng(6)
    cases = [("3x3", torch.bfloat16, 8, 16, (2, 8, 9)), ("up3x3", torch.bfloat16, 48, 24, (2, 5, 7)),
             ("1x1", torch.float32, 24, 136, (1, 4, 5)), ("up1x1", torch.float32, 16, 8, (2, 3, 5))]
    for kind, dtype, cin, cout, (B, H, W) in cases:
        x = torch.from_numpy(_x(rng, (B, cin, H, W), 2.0)).to(dtype)
        w, b = _weights(rng, kind, cin, cout)
        wd = Q._derived(torch.from_numpy(w).permute(3, 2, 0, 1), kind).contiguous()
        bias = torch.from_numpy(b)
        sxc = Q.static_scale(x.float().abs().amax(dim=(0, 2, 3)) * 0.7)
        xq, sx = _emu_quantize(so, x)
        xq0, sx0 = Q.quantize_act_plain(x)
        xqc, _ = _emu_quantize(so, x, sxc)
        assert torch.equal(xq, xq0) and torch.equal(sx, sx0), kind
        assert torch.equal(xqc, Q.quantize_act_plain(x, sxc)[0]), kind
        wq, sw = _emu_weight(so, wd)
        wqf, swf = _emu_weight(so, wd, sxc)
        for got, want in zip((wq, sw, wqf, swf),
                             Q.quantize_weight_plain(wd) + Q.quantize_weight_plain(wd, sxc)):
            assert torch.equal(got, want), kind
        acc = Q.int8_conv_plain(xq, wq, kind)
        assert torch.equal(_emu_conv(so, xq, wq, sw, kind, dtype, raw=True), acc), kind
        y = _emu_conv(so, xq, wq, sw, kind, dtype, s_x=sx, bias=bias)
        assert torch.equal(y, Q.dequant_plain(acc, dtype, sx * sw, bias)), kind
        y = _emu_conv(so, xq, wq, sw, kind, dtype, s_x=sx)
        assert torch.equal(y, Q.dequant_plain(acc, dtype, sx * sw)), kind
        y = _emu_conv(so, xqc, wqf, swf, kind, dtype, bias=bias)
        want = Q.dequant_plain(Q.int8_conv_plain(xqc, wqf, kind), dtype, swf, bias)
        assert torch.equal(y, want), kind


def test_cuda_source_refuses_what_it_cannot_run(tmp_path):
    """The C entry points refuse before any launch: an odd C_out, more taps
    than the table holds, four phases without up, and a dynamic
    quantization without its partials."""
    so = _emulated_library(tmp_path)
    xq = torch.zeros((1, 2, 2, 8), dtype=torch.int8)
    wq = torch.zeros((9, 8, 8), dtype=torch.int8)
    y, sw = torch.zeros((1, 2, 2, 8), dtype=torch.int32), torch.ones(8)
    table = (ctypes.c_int * 30)()
    call = lambda cout, ntaps, phases, up: so.qc_conv(
        _ptr(xq), _ptr(wq), _ptr(y), _ptr(sw), None, None, 1, 2, 2, 8, cout, up, 0, phases, ntaps,
        ctypes.cast(table, ctypes.c_void_p), 0, 0, None)
    assert call(8, 9, 1, 0) == 0
    assert call(7, 9, 1, 0) != 0
    assert call(8, 10, 1, 0) != 0
    assert call(8, 1, 4, 0) != 0
    x = torch.zeros((1, 2, 2, 8))
    assert so.qc_quantize(_ptr(x), _ptr(xq), x.numel(), 8, 0, None, 0, None, None, None) != 0


def test_wrappers_take_the_plain_versions_only_on_the_cpu():
    """A tensor that is not on the CPU goes to the kernels, which check it
    and raise for what they do not take; the launch counters move only
    there."""
    before = (Q.quantize_act.launches, Q.int8_conv.launches)
    x = torch.randn(1, 8, 2, 2)
    Q.int8_conv(*Q.quantize_act(x)[:1], *Q.quantize_weight(torch.randn(8, 8, 3, 3)), "3x3")
    assert (Q.quantize_act.launches, Q.int8_conv.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        Q.quantize_act(torch.empty((1, 8, 2, 2), device="meta"))
    with pytest.raises(ValueError, match="int8"):
        Q.int8_conv(torch.empty((1, 2, 2, 8), device="meta"), torch.zeros(9, 8, 8, dtype=torch.int8),
                    torch.ones(8), "3x3")


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
N = 2048


def _nets(over, seed=11):
    """The JAX package's TINY_NET with ``over`` (parameters from a seed, the
    "quant" collection zeros as its init gives) and the port's, loaded from
    the same variables."""
    import buddy_tpu.config as jc
    import buddy_tpu_torch.config as tc
    from buddy_tpu.models import NetworkBundle as JBundle
    from buddy_tpu_torch.models import NetworkBundle
    module = jc.instantiate(jax_compose(TINY_NET + over)["network"])
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, N)),
                            jnp.zeros((1,)))
    struct = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), struct)
    tree = {"params": randomize_tree(struct["params"], seed)}
    if "quant" in struct:
        tree["quant"] = struct["quant"]
    tnet = NetworkBundle(tc.instantiate(torch_compose(TINY_NET + over)["network"], device="cpu"))
    tnet.load_jax_params(tree)
    return JBundle(module, jax.tree.map(jnp.asarray, tree)), tnet, tree


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 1, N)) * 0.5).astype(np.float32), \
        np.asarray([-1.0, 0.3], np.float32)


def _forward(jnet, tnet, x, cnoise):
    yj = np.asarray(jax.jit(jnet.module.apply)(jnet.params, jnp.asarray(x), jnp.asarray(cnoise)))
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x), torch.from_numpy(cnoise)).numpy()
    return yt, yj


@pytest.mark.parametrize("over", [
    ["network.quantize_int8=true"],
    ["network.quantize_int8=true", "network.quantize_accum=float32", "network.quantize_bwd=true"],
    ["network.quantize_int8=true", "network.quantize_accum=bfloat16",
     "network.fuse_resample=true"]], ids=["int32", "float32-bwd", "bfloat16-fused"])
def test_tiny_net_dynamic_int8_matches_jax(over):
    """TINY_NET in float32 with dynamic int8 ResBlock convs (every accum
    mode, with fuse_resample) against the JAX package's.  Each conv is bit
    for bit on equal inputs (above); across the network, the float parts
    (STFT, GroupNorm, attention) differ in their last bits, which flips a
    few quantization roundings by one step: 2e-3 of the peak.  A float
    network of the same weights is at least 5x further away (the int8
    error itself)."""
    jnet, tnet, tree = _nets(over)
    x, cnoise = _inputs(1)
    yt, yj = _forward(jnet, tnet, x, cnoise)
    assert np.isfinite(yt).all()
    assert rel_err(yt, yj) < 2e-3
    jflt, _, _ = _nets([])
    yf = np.asarray(jax.jit(jflt.module.apply)(jnet.params, jnp.asarray(x), jnp.asarray(cnoise)))
    assert rel_err(yf, yj) > 5 * rel_err(yt, yj)


def test_tiny_net_static_int8_after_calibration_matches_jax():
    """quantize_static with fuse_resample: ``calibrate_quant`` on both
    sides with the same inputs (bench.py's recipe at test size: a 0.05-std
    signal at sigmas on a geometric grid, cin * x and cnoise), then the
    calibrated trees, then the outputs.  The first ResBlock's scales see
    only float layers before them (1e-5 of each leaf's peak); deeper ones
    see convs that quantized dynamically, whose one-step flips (see the
    dynamic test) move a maximum by up to 3e-2.  The outputs, on an input of
    the calibration's kind, with the port's own scales and with the JAX
    package's loaded into the port: 2e-2 of the peak (7.5e-3 measured
    either way; each up-ResBlock alone is bit for bit, test_torch_fused_up,
    so the spread comes from the float layers' last bits flipping the
    static quantization's roundings across the network)."""
    from buddy_tpu.diffusion.edm import EDM
    from buddy_tpu_torch.models.convert import to_jax_params
    over = ["network.quantize_int8=true", "network.quantize_static=true",
            "network.fuse_resample=true"]
    jnet, tnet, tree = _nets(over)
    edm = EDM(sde_hp=dict(jax_compose(TINY_NET)["diff_params"]["sde_hp"]))
    rng = np.random.default_rng(7)
    clean = rng.standard_normal((1, 1, N)).astype(np.float32) * 0.05
    xs, cs = [], []
    for s in np.geomspace(0.5, 1e-4, 4).astype(np.float32):
        sig = jnp.full((1,), s, jnp.float32)
        xn = clean + s * rng.standard_normal(clean.shape).astype(np.float32)
        xs.append(np.asarray(edm.cin(sig)[:, None, None] * xn))
        cs.append(np.asarray(edm.cnoise(sig)))
    jnet.calibrate_quant([jnp.asarray(v) for v in xs], [jnp.asarray(v) for v in cs])
    tnet.calibrate_quant([torch.from_numpy(v) for v in xs], [torch.from_numpy(v) for v in cs])
    jq = jax.tree.map(np.asarray, jnet.params["quant"])["unet"]
    tq = to_jax_params(tnet.module.state_dict())["quant"]["unet"]
    assert sorted(jq) == sorted(tq)
    first = min(jq, key=lambda k: int(k.split("_")[-1]))
    for block in jq:
        for conv, leaf in jq[block].items():
            a, b = tq[block][conv]["a_scale"], leaf["a_scale"]
            assert (b > 0).any()
            tol = 1e-5 if block == first else 3e-2
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), (block, conv)
    # an input of the calibration's kind (another signal, two sigmas)
    sig = np.asarray([0.05, 0.002], np.float32)
    xn = (rng.standard_normal((2, 1, N)) * 0.05
          + sig[:, None, None] * rng.standard_normal((2, 1, N))).astype(np.float32)
    x = np.asarray(edm.cin(jnp.asarray(sig))[:, None, None] * xn)
    cnoise = np.asarray(edm.cnoise(jnp.asarray(sig)))
    yt, yj = _forward(jnet, tnet, x, cnoise)
    assert rel_err(yt, yj) < 2e-2
    own = {k: v.clone() for k, v in tnet.module.state_dict().items()}
    tnet.load_jax_params(jax.tree.map(np.asarray, jnet.params))
    yt2, _ = _forward(jnet, tnet, x, cnoise)
    assert rel_err(yt2, yj) < 2e-2
    tnet.module.load_state_dict(own)


def test_calibrate_quant_needs_static_convs():
    """calibrate_quant raises on a network without static int8 convs."""
    _, tnet, _ = _nets(["network.quantize_int8=true"])
    with pytest.raises(ValueError, match="static"):
        tnet.calibrate_quant([torch.zeros(1, 1, N)], [torch.zeros(1)])


def test_variables_with_quant_convert_both_ways():
    """from_jax_params / to_jax_params carry the "quant" collection: the JAX
    variables' a_scale leaves land on the port's buffers and come back, the
    parameters as before; a tree without "quant" loads as zeros (the JAX
    init's); a non-static network ignores a tree's scales."""
    from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
    over = ["network.quantize_int8=true", "network.quantize_static=true"]
    _, tnet, tree = _nets(over)
    rng = np.random.default_rng(8)
    tree["quant"] = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
                                 tree["quant"])
    state = from_jax_params(tree)
    n_scales = len(jax.tree.leaves(tree["quant"]))
    assert sum(k.endswith("a_scale") for k in state) == n_scales > 0
    tnet.load_jax_params(tree)
    back = to_jax_params(tnet.module.state_dict())
    assert sorted(back) == ["params", "quant"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"params": tree["params"],
                                                            "quant": tree["quant"]})):
        assert np.array_equal(a, b)
    tnet.load_jax_params({"params": tree["params"]})
    assert all((b == 0).all() for n, b in tnet.module.named_buffers() if n.endswith("a_scale"))
    _, plain, _ = _nets(["network.quantize_int8=true"])
    plain.load_jax_params(tree)
    assert sorted(to_jax_params(plain.module.state_dict())) == ["params"]


def test_checkpoints_carry_quant_as_the_jax_package_does(tmp_path):
    """The JAX package's save_checkpoint stores whatever variables it is
    given, "quant" included (its trainer's are the network's variables), and
    its loader returns them; the port does the same both ways: a JAX .ckpt
    with scales loads into the port's buffers, and the port's
    save_checkpoint, given ``to_jax_params`` of a static network's state (as
    its trainer, whose parameters include the scales, gives it), stores
    them under params/quant/..., which the JAX package reads back."""
    import buddy_tpu.training.checkpoint as jck
    import buddy_tpu_torch.training.checkpoint as tck
    from buddy_tpu_torch.models.convert import to_jax_params
    over = ["network.quantize_int8=true", "network.quantize_static=true"]
    _, tnet, tree = _nets(over)
    tree["quant"] = jax.tree.map(lambda a: np.full(a.shape, 0.5, np.float32), tree["quant"])
    path = jck.save_checkpoint(str(tmp_path / "jax"), params=tree, ema_params=tree, it=3)
    loaded, it = tck.load_any_checkpoint(path)
    assert it == 3 and "quant" in loaded
    tnet.load_jax_params(loaded)
    scales = [b for n, b in tnet.module.named_buffers() if n.endswith("a_scale")]
    assert scales and all((b == 0.5).all() for b in scales)
    state = to_jax_params(dict(tnet.module.state_dict()))
    path = tck.save_checkpoint(str(tmp_path / "torch"), params=state, ema_params=state, it=4)
    back, it = jck.load_any_checkpoint(path, prefer_ema=False)
    assert it == 4 and sorted(back) == ["params", "quant"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert np.array_equal(a, b)
