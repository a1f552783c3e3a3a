"""Kernel K11 (FIR resampling, ``csrc/upfirdn.cu``) and its autograd
function (``ops/resample.py``) on the CPU.

- ``upfirdn2d`` / ``upfirdn1d`` (the ``autograd.Function`` on its CPU
  route), forward and input vjp, against the JAX package's functions and
  their ``jax.vjp``: the up/down/pad cases of ``test_torch_resample.py``
  with the asymmetric kernel (1, 2, 4, 1) and a non-square 2-D kernel, C in
  {1, 3, 8}, NCHW and channels_last inputs;
- the derived pads of the input vjp (``adjoint_axis``) written out through
  the plain route, against JAX's vjp;
- the CUDA source itself, compiled by g++ against ``tests/cuda_emu/`` and
  run through the wrapper's own launch (``_launch``) on CPU tensors,
  forward and input vjp, against the plain version at the same cases: the
  16-byte path (channels_last, C = 8), the scalar path (channels_last,
  C = 3) and the one-channel images of an NCHW tensor (C = 1, 3, 8); bit
  for bit between two calls; the output in the input's memory format; the
  launch counts and the record of a run;
- the refusals: a dtype other than float32, a factor or tap count above the
  kernel's caps, a gradient for the FIR kernel, shapes the C entry does not
  take.

Tolerances: 1e-6 of the peak in float32 (sums in other orders), as
``tests/test_torch_resample.py``.
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

from test_torch_common import rel_err

from buddy_tpu.ops import resample as JR
from buddy_tpu_torch.ops import resample as R

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
CASES = [(1, 1, (1, 1)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 1, (5, -1)), (3, 2, (0, 2))]
CASE_IDS = ["same", "up2", "down2", "up2-crop", "up3-down2"]


def _kernel(which: str) -> np.ndarray:
    """The asymmetric (1, 2, 4, 1) made 2-D as the FIR entry points make it,
    or a non-square, non-separable 3 x 5 kernel."""
    if which == "asym":
        return R._setup_kernel((1, 2, 4, 1))
    k = np.random.default_rng(11).uniform(0.1, 1.0, (3, 5)).astype(np.float32)
    return k / k.sum()


def _nchw(a, channels_last: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t


def _nhwc(t) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_case(x, k, up, down, pad, seed):
    """JAX's output, a seeded cotangent and JAX's input vjp, NHWC."""
    f = lambda v: JR.upfirdn2d(v, jnp.asarray(k), up=up, down=down, pad=pad)
    yj, vjp = jax.vjp(f, jnp.asarray(x))
    g = np.random.default_rng(seed).standard_normal(yj.shape).astype(np.float32)
    return np.asarray(yj), g, np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("kern", ["asym", "3x5"])
@pytest.mark.parametrize("up,down,pad", CASES, ids=CASE_IDS)
def test_function_matches_jax(up, down, pad, kern):
    """The autograd function on the CPU route, forward and input vjp,
    against ``JR.upfirdn2d`` and its ``jax.vjp``, at C = 1, 3, 8 in NCHW and
    in channels_last."""
    k = _kernel(kern)
    for C in (1, 3, 8):
        x = np.random.default_rng(C).standard_normal((2, 8, 10, C)).astype(np.float32)
        yj, g, gj = _jax_case(x, k, up, down, pad, C + 1)
        for cl in (False, True):
            xt = _nchw(x, cl).requires_grad_(True)
            yt = R.upfirdn2d(xt, torch.from_numpy(k), up=up, down=down, pad=pad)
            yt.backward(_nchw(g, cl))
            assert _nhwc(yt).shape == yj.shape, (C, cl)
            assert rel_err(_nhwc(yt), yj) < 1e-6, (C, cl)
            assert rel_err(_nhwc(xt.grad), gj) < 1e-6, (C, cl)


@pytest.mark.parametrize("up,down,pad", CASES, ids=CASE_IDS)
def test_upfirdn1d_matches_jax(up, down, pad):
    """``upfirdn1d`` (the same function with a one-tap axis), forward and
    input vjp, against ``JR.upfirdn1d``, with the asymmetric 1-D kernel,
    C = 1, 3, 8; (B, C, T) here, (B, T, C) in the JAX package."""
    k = np.asarray([1, 2, 4, 1], np.float32) / 8
    for C in (1, 3, 8):
        x = np.random.default_rng(C).standard_normal((2, 12, C)).astype(np.float32)
        f = lambda v: JR.upfirdn1d(v, jnp.asarray(k), up=up, down=down, pad=pad)
        yj, vjp = jax.vjp(f, jnp.asarray(x))
        g = np.random.default_rng(C + 1).standard_normal(yj.shape).astype(np.float32)
        xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_(True)
        yt = R.upfirdn1d(xt, torch.from_numpy(k), up=up, down=down, pad=pad)
        yt.backward(torch.from_numpy(g.transpose(0, 2, 1).copy()))
        assert rel_err(yt.detach().numpy().transpose(0, 2, 1), np.asarray(yj)) < 1e-6, C
        assert rel_err(xt.grad.numpy().transpose(0, 2, 1),
                       np.asarray(vjp(jnp.asarray(g))[0])) < 1e-6, C


@pytest.mark.parametrize("kern", ["asym", "3x5"])
@pytest.mark.parametrize("up,down,pad", CASES, ids=CASE_IDS)
def test_adjoint_pads_match_jax_vjp(up, down, pad, kern):
    """The input vjp written out: upfirdn(up=down, down=up) of the cotangent
    with the kernel flipped and the pads of ``adjoint_axis`` (through the
    plain route, and through ``upfirdn2d`` with those pads where they are
    the same on both axes) is JAX's vjp; the adjoint of the adjoint is the
    axis itself, up to high padding that the striding leaves unread."""
    k = _kernel(kern)
    kh, kw = k.shape
    x = np.random.default_rng(0).standard_normal((2, 8, 10, 3)).astype(np.float32)
    yj, g, gj = _jax_case(x, k, up, down, pad, 1)
    ay, ax = R.make_axis(8, kh, up, down, pad), R.make_axis(10, kw, up, down, pad)
    assert (ay.out, ax.out) == yj.shape[1:3]
    by, bx = R.adjoint_axis(ay), R.adjoint_axis(ax)
    assert (by.up, by.down, by.pad0) == (down, up, kh - 1 - pad[0])
    assert (bx.up, bx.down, bx.pad0) == (down, up, kw - 1 - pad[0])
    for a, b in ((ay, by), (ax, bx)):
        assert (b.n, b.out) == (a.out, a.n)
        assert b.out == (b.n * b.up + b.pad0 + b.pad1 - b.taps) // b.down + 1
        aa = R.adjoint_axis(b)          # a again, but for high padding no output reaches
        assert aa._replace(pad1=a.pad1) == a and 0 <= a.pad1 - aa.pad1 < a.down
    kf = torch.from_numpy(k).flip(0, 1)
    dx = R.upfirdn_conv(_nchw(g), kf, by, bx)
    assert rel_err(_nhwc(dx), gj) < 1e-6
    if kh == kw:
        dx2 = R.upfirdn2d_plain(_nchw(g), kf, up=down, down=up, pad=(by.pad0, by.pad1))
        assert rel_err(_nhwc(dx2), gj) < 1e-6


# ---------------------------------------------------------------------------
# the CUDA source under the CPU emulation
# ---------------------------------------------------------------------------
def _emulated_library(tmp_path):
    """csrc/upfirdn.cu compiled by g++ onto tests/cuda_emu, as a ctypes CDLL
    (blocks one at a time; cp.async a copy)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be emulated")
    src = open(os.path.join(os.path.dirname(R.__file__), "..", "csrc", "upfirdn.cu")).read()
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "cuda_emu.h"\n'
                      "static const bool emu_serial = (emu::serial_blocks = true);")
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::smem());", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(([^;]*)\);",
                 lambda m: (f"emu::launch(dim3({m.group(2)}), dim3({m.group(3)}), {m.group(4)}, "
                            f"[&] {{ {m.group(1)}({m.group(6)}); }});"), src, flags=re.S)
    assert "<<<" not in src and "__shared__" not in src
    cpp, lib = tmp_path / "upfirdn_emu.cpp", tmp_path / "libupfirdn_emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                    "-ffp-contract=off", "-I", EMU_DIR, "-o", str(lib), str(cpp)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.upfirdn.argtypes = R._SIGNATURES["upfirdn"]
    so.upfirdn.restype = ctypes.c_int
    return so


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated library, compiled once for the module's tests."""
    return _emulated_library(tmp_path_factory.mktemp("emu"))


@pytest.fixture
def on_emulated_card(emulated, monkeypatch):
    """Every K11 launch of ``ops/resample.py`` goes to the emulated source
    on CPU tensors: ``_build.load`` gives the emulated library, the stream
    is the default one, and the dispatch launches whatever the device."""
    monkeypatch.setattr(R._build, "load", lambda name, sigs: emulated)
    monkeypatch.setattr(R._build, "stream", lambda device: ctypes.c_void_p(None))
    monkeypatch.setattr(R, "_run", R._launch)
    monkeypatch.setattr(R.upfirdn2d, "launches", 0)
    monkeypatch.setattr(R.upfirdn2d_backward, "launches", 0)
    monkeypatch.setattr(R.upfirdn2d, "record", None)
    return emulated


def _plain_fwd_vjp(x, k, up, down, pad, g):
    xp = x.detach().contiguous().requires_grad_(True)
    yp = R.upfirdn2d_plain(xp, k, up=up, down=down, pad=pad)
    (dxp,) = torch.autograd.grad(yp, xp, g)
    return yp.detach(), dxp


@pytest.mark.parametrize("kern", ["asym", "3x5"])
@pytest.mark.parametrize("up,down,pad", CASES, ids=CASE_IDS)
def test_emulated_kernel_matches_plain(on_emulated_card, up, down, pad, kern):
    """The CUDA source through ``upfirdn2d`` (forward launch, and the input
    vjp's launch from autograd) against the zero-stuffing definition and its
    autograd vjp: the 16-byte path (channels_last, C = 8), the scalar path
    (channels_last, C = 3) and NCHW as one-channel images (C = 1, 3, 8); the
    output keeps the input's memory format; two calls bit for bit; one launch
    a direction a call."""
    k = torch.from_numpy(_kernel(kern))
    for C, cl in ((8, True), (3, True), (1, False), (3, False), (8, False)):
        x = torch.from_numpy(np.random.default_rng(C).standard_normal((2, C, 8, 10))
                             .astype(np.float32))
        x = x.contiguous(memory_format=torch.channels_last) if cl else x
        xr = x.clone().requires_grad_(True)
        before = R.upfirdn2d.launches, R.upfirdn2d_backward.launches
        y = R.upfirdn2d(xr, k, up=up, down=down, pad=pad)
        g = torch.from_numpy(np.random.default_rng(C + 1).standard_normal(tuple(y.shape))
                             .astype(np.float32))
        g = g.contiguous(memory_format=torch.channels_last) if cl else g
        (dx,) = torch.autograd.grad(y, xr, g)
        assert (R.upfirdn2d.launches - before[0], R.upfirdn2d_backward.launches - before[1]) \
            == (1, 1)
        yp, dxp = _plain_fwd_vjp(x, k, up, down, pad, g)
        what = (C, "channels_last" if cl else "NCHW")
        assert y.shape == yp.shape and dx.shape == x.shape, what
        fmt = torch.channels_last if cl and C > 1 else torch.contiguous_format
        assert y.is_contiguous(memory_format=fmt) and dx.is_contiguous(memory_format=fmt), what
        assert rel_err(y.detach().numpy(), yp.numpy()) < 1e-6, what
        assert rel_err(dx.numpy(), dxp.numpy()) < 1e-6, what
        with torch.no_grad():
            assert torch.equal(y.detach(), R.upfirdn2d(x, k, up=up, down=down, pad=pad)), what


@pytest.mark.parametrize("C,hw,up,down,pad,taps", [
    (40, 8, 2, 1, (2, 1), 4), (33, 8, 1, 2, (1, 1), 4), (8, 64, 1, 4, (6, 6), 12),
    (12, 16, 4, 1, (9, 6), 12)], ids=["chunks-vec", "chunks-scalar", "halved-tile", "up4"])
def test_emulated_kernel_chunks_and_tiles(on_emulated_card, C, hw, up, down, pad, taps):
    """Channels_last activations whose channels take two chunks, the last
    one partly (40 on the 16-byte path, 33 on the scalar one), a down x4
    with 12 x 12 taps whose staged tile has to be halved to fit the shared
    memory budget, and an up x4: forward and input vjp against the plain
    version."""
    k = torch.from_numpy(np.random.default_rng(taps).uniform(0.1, 1, (taps, taps))
                         .astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(C).standard_normal((1, C, hw, hw))
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    xr = x.clone().requires_grad_(True)
    y = R.upfirdn2d(xr, k, up=up, down=down, pad=pad)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(tuple(y.shape))
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    (dx,) = torch.autograd.grad(y, xr, g)
    yp, dxp = _plain_fwd_vjp(x, k, up, down, pad, g)
    assert rel_err(y.detach().numpy(), yp.numpy()) < 1e-6
    assert rel_err(dx.numpy(), dxp.numpy()) < 1e-6


def test_emulated_upfirdn1d_and_entry_points(on_emulated_card, monkeypatch):
    """``upfirdn1d`` and the U-Net's FIR entry points (up x2 and down x2
    with the shipped kernel, and the 3 x 3 convolution around them) through
    the emulated source, values and input vjp against the plain route, on a
    channels_last activation of 16 channels; ``record`` counts each launch
    by direction, shape, layout, axes and taps."""
    rng = np.random.default_rng(3)
    k1 = torch.tensor([1.0, 2.0, 4.0, 1.0]) / 8
    x1 = torch.from_numpy(rng.standard_normal((2, 3, 20)).astype(np.float32))
    for up, down, pad in CASES:
        xr = x1.clone().requires_grad_(True)
        y = R.upfirdn1d(xr, k1, up=up, down=down, pad=pad)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
        (dx,) = torch.autograd.grad(y, xr, g)
        xp = x1.clone().requires_grad_(True)
        yp = R.upfirdn1d_plain(xp, k1, up=up, down=down, pad=pad)
        (dxp,) = torch.autograd.grad(yp, xp, g)
        assert rel_err(y.detach().numpy(), yp.detach().numpy()) < 1e-6, (up, down, pad)
        assert rel_err(dx.numpy(), dxp.numpy()) < 1e-6, (up, down, pad)
    R.upfirdn2d.record = {}
    x = torch.from_numpy(rng.standard_normal((2, 16, 6, 10)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy((rng.standard_normal((16, 16, 3, 3)) / 12).astype(np.float32))
    calls = {"upsample_2d": lambda v: R.upsample_2d(v),
             "downsample_2d": lambda v: R.downsample_2d(v),
             "upsample_conv_2d": lambda v: R.upsample_conv_2d(v, w, (1, 3, 3, 1)),
             "conv_downsample_2d": lambda v: R.conv_downsample_2d(v, w, (1, 3, 3, 1))}
    outs = {}
    for name, call in calls.items():
        xr = x.clone().requires_grad_(True)
        y = call(xr)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
        outs[name] = (y.detach(), torch.autograd.grad(y, xr, g)[0], g)
    monkeypatch.setattr(R, "_run", lambda v, kk, ay, ax, c: R.upfirdn_conv(v, kk, ay, ax))
    for name, call in calls.items():
        xr = x.clone().requires_grad_(True)
        y = call(xr)
        (dx,) = torch.autograd.grad(y, xr, outs[name][2])
        assert rel_err(outs[name][0].numpy(), y.detach().numpy()) < 1e-6, name
        assert rel_err(outs[name][1].numpy(), dx.numpy()) < 1e-6, name
    rec = R.upfirdn2d.record
    fwd = {key[1:5]: n for key, n in rec.items() if key[0] == "upfirdn2d"}
    vjp = {key[1:5]: n for key, n in rec.items() if key[0] == "upfirdn2d_backward"}
    up_ax, down_ax = R.make_axis(10, 4, 2, 1, (2, 1)), R.make_axis(10, 4, 1, 2, (1, 1))
    assert fwd[((2, 16, 6, 10), True, R.make_axis(6, 4, 2, 1, (2, 1)), up_ax)] == 2
    assert fwd[((2, 16, 6, 10), True, R.make_axis(6, 4, 1, 2, (1, 1)), down_ax)] == 2
    assert sum(vjp.values()) == 4 and sum(fwd.values()) == 4
    assert all(key[1] for key in fwd)                       # read in channels_last


def test_emulated_entry_refuses_what_it_does_not_take(emulated):
    """The C entry returns an error, and launches nothing, for a factor
    above kMaxFactor, a kernel above kMaxTaps, or an empty size."""
    x, y = torch.ones(1, 4, 4, 4), torch.zeros(1, 4, 4, 4)
    taps = torch.ones(17 * 17)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    call = lambda kh, kw, up, down, oh: emulated.upfirdn(p(x), p(y), p(taps), kh, kw, 1, 4, 4, 4,
                                                         oh, 4, up, up, down, down, 0, 0, None)
    assert call(1, 1, 1, 1, 4) == 0 and y.eq(1).all()
    y.zero_()
    for args in ((17, 1, 1, 1, 4), (1, 17, 1, 1, 4), (1, 1, 9, 1, 4), (1, 1, 1, 9, 4),
                 (0, 1, 1, 1, 4), (1, 1, 1, 1, 0)):
        assert call(*args) != 0, args
    assert not y.any()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_non_float32_raises(dtype):
    """FIR resampling runs in float32 only (the JAX package has no FIR path
    under a bfloat16 body): every entry point raises a TypeError naming the
    dtype, as the plain route did."""
    x = torch.ones(1, 4, 8, 8, dtype=dtype)
    k = R.fir_kernel((1, 3, 3, 1), 1.0)
    for call in (lambda: R.upfirdn2d(x, k, up=2, pad=(2, 1)), lambda: R.upsample_2d(x),
                 lambda: R.downsample_2d(x), lambda: R.upfirdn1d(x[:, :, 0], k[0], down=2)):
        with pytest.raises(TypeError, match=str(dtype).split(".")[1]):
            call()
    with pytest.raises(TypeError, match="float64"):
        R.upfirdn2d(torch.ones(1, 4, 8, 8), k.double())


def test_caps_raise_on_every_device():
    """A factor above MAX_FACTOR or more than MAX_TAPS taps on an axis is
    refused before any launch, on the CPU as on the card (meta tensors here:
    the check comes before the device)."""
    for dev in ("cpu", "meta"):
        x = torch.ones(1, 2, 8, 8, device=dev)
        with pytest.raises(ValueError, match="MAX_FACTOR"):
            R.upfirdn2d(x, torch.ones(4, 4), up=R.MAX_FACTOR + 1)
        with pytest.raises(ValueError, match="MAX_TAPS"):
            R.upfirdn2d(x, torch.ones(R.MAX_TAPS + 1, 2))
        with pytest.raises(ValueError, match="no output"):
            R.upfirdn2d(x, torch.ones(4, 4), pad=(-4, -4))
    with pytest.raises(ValueError, match="CUDA"):
        R.upfirdn2d(torch.ones(1, 2, 8, 8, device="meta"), torch.ones(4, 4), up=2, pad=(2, 1))


def test_kernel_gradient_raises():
    """The FIR kernel is a constant of the model: a gradient asked for it
    raises; the input's gradient alone is served."""
    x = torch.ones(1, 2, 8, 8, requires_grad=True)
    k = R.fir_kernel((1, 3, 3, 1), 4.0).requires_grad_(True)
    y = R.upfirdn2d(x, k, up=2, pad=(2, 1))
    with pytest.raises(RuntimeError, match="FIR kernel"):
        y.sum().backward()
    y = R.upfirdn2d(x, k.detach(), up=2, pad=(2, 1))
    y.sum().backward()
    assert x.grad.shape == x.shape
