"""(c) The kernel-name classifiers of ``conv_ms_per_step``,
``operator_ms_per_step`` and the K1 / K11 rooflines, against the device
tables of the port's profiled runs on an H100 (``data/profile_*.txt``,
from ``chip_smoke.py``: ms, launches and kernel name a row, summed over
each run's 2 steps)."""

from __future__ import annotations

import os
import re

import pytest

from portbench.roofline.kernels import K1, K11, OPERATOR, conv_us, is_conv, named_us
from portbench.trace import short_name

DATA = os.path.join(os.path.dirname(__file__), "data")
PORT = ("gn_", "stft_", "subband_", "compress", "comp_loss", "minphase", "design_", "wpe_solve",
        "upfirdn", "qc_")


def table(name):
    rows = []
    for line in open(os.path.join(DATA, f"profile_{name}.txt")):
        m = re.match(r"\s*([\d.]+) ms\s+(\d+)x\s+(.*)$", line.rstrip("\n"))
        rows.append((m.group(3).strip(), float(m.group(1)), int(m.group(2))))
    return rows


def conv_ms(rows):
    return sum(ms for name, ms, _ in rows if is_conv(name))


@pytest.mark.parametrize("name", ["serving", "serving_identity", "fir_residual", "train_step"])
def test_classes_do_not_overlap(name):
    for kname, _, _ in table(name):
        s = short_name(kname)
        if s.startswith(PORT):
            assert not is_conv(kname), kname
        if s.startswith(("at::native", "Memcpy", "Memset", "nvjet", "std::enable_if")):
            assert not is_conv(kname), kname
        if any(m in s for m in ("fprop", "dgrad", "wgrad", "fft2d_r2c", "fft2d_c2r")):
            assert is_conv(kname), kname


def test_serving_convolutions():
    # PERF.md: cuDNN's convolutions 27.3 ms a step of the main path; the
    # serving run profiled 2 steps
    assert conv_ms(table("serving")) / 2 == pytest.approx(26.6, abs=0.1)
    assert conv_ms(table("serving_identity")) / 2 == pytest.approx(13.35, abs=0.1)


def test_fft_route_gemms_are_convolutions_only_in_place():
    rows = table("fir_residual")
    cgemm = [r for r in rows if "gemm_cf32" in r[0]]
    assert cgemm and not any(is_conv(name) for name, _, _ in cgemm)
    r2c = next(n for n, _, _ in rows if short_name(n) == "fft2d_r2c_32x32")
    c2r = next(n for n, _, _ in rows if short_name(n) == "fft2d_c2r_32x32")
    fft_gemm = next(n for n, _, c in cgemm if c == 4038)
    wpe_gemm = next(n for n, _, c in cgemm if c == 5)
    events = [(r2c, 0, 10.0), (fft_gemm, 10, 20.0), (c2r, 30, 5.0),
              (wpe_gemm, 40, 7.0), ("void (anonymous namespace)::wpe_solve_kernel<2>()", 50, 3.0)]
    assert conv_us(events) == 35.0
    # PERF.md: run (a) 393.5 ms a step of implicit-GEMM and dgrad kernels and
    # 347.3 of the FFT route; the table holds 2 steps
    fft_route = sum(ms for n, ms, c in cgemm if c == 4038)
    assert (conv_ms(rows) + fft_route) / 2 == pytest.approx(734.2, abs=0.5)


def test_train_convolutions():
    rows = table("train_step")
    fft_route = sum(ms for n, ms, c in rows if "gemm_cf32" in n and c == 1881)
    # PERF.md: cuDNN's convs 1273.6 ms of the train step (1 step profiled)
    assert conv_ms(rows) + fft_route == pytest.approx(1281.3, abs=0.5)


def _events(rows):
    return [(name, i, ms * 1e3) for i, (name, ms, _) in enumerate(rows)]


def test_port_kernels_by_name():
    serving = _events(table("serving"))
    assert named_us(serving, K1) * 1e-3 == pytest.approx(12.615 + 10.656 + 8.565 + 4.153)
    ops = {short_name(n) for n, _, _ in serving} & set(OPERATOR)
    assert ops == set(OPERATOR)
    identity = _events(table("serving_identity"))
    assert {short_name(n) for n, _, _ in identity} & set(K1) == {"gn_stats_kernel",
                                                                   "gn_apply_kernel"}
    fir = _events(table("fir_residual"))
    assert named_us(fir, K11) * 1e-3 == pytest.approx(13.497)
    assert named_us(serving, K11) == 0
