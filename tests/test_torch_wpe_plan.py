"""K7's plan and schedule on the CPU (``buddy_tpu_torch/ops/wpe_solve.py``,
``buddy_tpu_torch/csrc/wpe_solve.cu``).

- ``solve_route`` gives every n from 1 to the cap a route whose registers,
  shared memory and workspace fit the H100 by the plan's own arithmetic, and
  refuses n above the cap with a ValueError that names it.
- ``_schedule`` is the kernel's schedule in numpy float64: the register
  route's padded layout (rows past n zero and dead from the start, columns
  past n zero), the trace as four partial sums, implicit pivoting (rows never
  move; the live row with the largest |a|^2, the lowest row on a tie),
  multipliers a * (1 / pivot), the back substitution through the pivot
  sequence.  On seeded WPE systems it is held to ``np.linalg.solve`` in
  complex128 (1e-9 of max|G|: float64 arithmetic on the exact complex64
  input), to the JAX formula (residual of the loaded system < 1e-3 for both,
  as ``tests/test_torch_fused.py`` holds the plain solve) and to a textbook
  LU with row swaps (the same pivot sequence).
- The CUDA source itself runs under g++ against ``tests/cuda_emu/cuda_emu.h``
  (a thread per CUDA thread; the launches, the dynamic shared memory and the
  inline PTX rewritten onto the emulation), on both routes, with fewer CTAs
  than systems so that each CTA loops: G within 1e-6 of the complex128 solve
  of max|G| (G is complex64), bit-identical between two runs.
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

from test_torch_fused import _wpe_systems
from buddy_tpu_torch.ops import wpe_solve as K7

H100_SMS = 132
H100_MEMORY = 80 * 2 ** 30
EMU_DIR = os.path.join(os.path.dirname(__file__), "cuda_emu")
SCHEDULE_NS = (1, 2, 10, 50, 64, 120, 200)


def _systems(n, batch=3, seed=None):
    """Seeded WPE systems of n taps (T = 4 n + 16 frames, so R has full rank)."""
    return _wpe_systems(n if seed is None else seed, batch=batch, taps=n, T=4 * n + 16)


def _loaded(R, diag_rel=1e-6, eps=1e-10):
    """R + load I in complex128, the trace summed in float64 as the kernel
    sums it (a complex64 trace would move the load by ~1e-7 of itself, which
    at the condition numbers of n = 200, ~1e7, moves G by ~1e-9)."""
    n = R.shape[-1]
    trace = np.diagonal(R, axis1=-2, axis2=-1).real.astype(np.float64).sum(-1)
    load = diag_rel * trace / n + eps
    return R.astype(np.complex128) + load[..., None, None] * np.eye(n)


def _solve128(R, P):
    return np.linalg.solve(_loaded(R), P.astype(np.complex128)[..., None])[..., 0]


# --- the plan -----------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(1, 16), (17, 32), (33, 51), (52, 64), (65, 256),
                                   (257, 1024)])
def test_every_n_has_a_route_that_fits(lo, hi):
    """Every n of [lo, hi] plans: the smallest register instance that holds
    n rows and n + 1 columns up to n = 64, else the workspace route; the
    register budget (the launch bounds' cap covers the matrix with room for
    the rest), the shared memory and the workspace fit the H100."""
    for n in range(lo, hi + 1):
        plan = K7.solve_route(n, batch=2056, sms=H100_SMS)
        assert plan.smem_bytes <= K7.SMEM_MAX
        if n <= K7.REG_INSTANCES[-1][0]:
            assert plan.route == "registers"
            max_n, rs, pc, cs, minb = K7.REG_INSTANCES[plan.index]
            smaller = K7.REG_INSTANCES[plan.index - 1][0] if plan.index else 0
            assert smaller < n <= max_n and n <= K7.WARP * rs and n + 1 <= pc * cs
            assert plan.threads == K7.WARP * pc and plan.grid == min(2056, H100_SMS * minb)
            assert plan.matrix_registers == 4 * rs * cs
            assert plan.matrix_registers + 24 <= plan.register_cap <= K7.REGS_MAX
            assert plan.threads * plan.register_cap * minb <= K7.REGS_SM
            assert minb * plan.smem_bytes <= 228 * 1024 and plan.workspace_bytes == 0
        else:
            assert plan.route == "large" and plan.index == len(K7.REG_INSTANCES)
            assert plan.grid == H100_SMS and plan.threads == K7.LARGE_THREADS
            assert plan.workspace_bytes == 16 * H100_SMS * n * (n + 1)
            assert plan.workspace_bytes <= H100_MEMORY // 16


def test_the_plan_sizes_the_grid_and_workspace_by_the_batch():
    """A persistent grid: never more CTAs than systems, and the workspace
    follows the grid, not the batch (n = 512 x 2056 systems would be 8.6 GB)."""
    assert K7.solve_route(50, batch=5).grid == 5
    assert K7.solve_route(50, batch=10 ** 5, sms=H100_SMS).grid == 3 * H100_SMS
    big = K7.solve_route(512, batch=2056, sms=H100_SMS)
    assert big.grid == H100_SMS and big.workspace_bytes == 16 * H100_SMS * 512 * 513
    assert K7.solve_route(512, batch=3).workspace_bytes == 16 * 3 * 512 * 513


@pytest.mark.parametrize("n", [0, K7.MAX_N + 1, 4096])
def test_the_plan_refuses_n_outside_the_cap(n):
    with pytest.raises(ValueError, match=f"MAX_N = {K7.MAX_N}"):
        K7.solve_route(n)


# --- the schedule in numpy float64 ----------------------------------------------
def _layout(n):
    """Rows and columns the kernel's route holds for n unknowns."""
    plan = K7.solve_route(n)
    if plan.route == "registers":
        _, rs, pc, cs, _ = K7.REG_INSTANCES[plan.index]
        return K7.WARP * rs, pc * cs
    return n, n + 1


def _schedule(R, P, diag_rel=1e-6, eps=1e-10):
    """One system through the kernel's schedule in float64: (G, pivot rows,
    the matrix after elimination)."""
    n = R.shape[-1]
    rows, cols = _layout(n)
    d = np.diagonal(R).real.astype(np.float64)
    tr = [np.cumsum(d[j::4])[-1] if len(d[j::4]) else 0.0 for j in range(4)]
    load = diag_rel * (((tr[0] + tr[1]) + (tr[2] + tr[3])) / n) + eps
    a = np.zeros((rows, cols), np.complex128)
    a[:n, :n] = R
    a[:n, n] = P
    a[np.arange(n), np.arange(n)] += load
    dead = np.arange(rows) >= n
    U = np.zeros((n, cols), np.complex128)
    inv = np.zeros(n, np.complex128)
    pivots = []
    for k in range(n):
        col = a[:, k]
        key = col.real * col.real + col.imag * col.imag
        key = np.where(np.isnan(key), 0.0, key)
        p = int(np.argmax(np.where(dead, -1.0, key)))     # first of the largest
        s = 1.0 / (col[p].real * col[p].real + col[p].imag * col[p].imag)
        inv[k] = complex(col[p].real * s, -col[p].imag * s)
        U[k] = a[p]
        l = np.where(dead, 0.0, col * inv[k])
        l[p] = 0.0
        dead[p] = True
        a[:, k + 1:] -= l[:, None] * a[p, k + 1:][None, :]
        pivots.append(p)
    x = U[:, n].copy()                                      # column by column
    for k in range(n - 1, -1, -1):
        x[k] = x[k] * inv[k]
        x[:k] -= U[:k, k] * x[k]
    return x, pivots, a


def _textbook(A, b):
    """LU with partial pivoting and row swaps (complex division), the pivot
    rows as original row indices."""
    A, b = A.copy(), b.copy()
    n = len(b)
    orig = np.arange(n)
    for k in range(n):
        key = A[k:, k].real ** 2 + A[k:, k].imag ** 2
        cand = np.flatnonzero(key == key.max())
        r = k + cand[np.argmin(orig[k + cand])]
        A[[k, r]], b[[k, r]], orig[[k, r]] = A[[r, k]], b[[r, k]], orig[[r, k]]
        m = A[k + 1:, k] / A[k, k]
        A[k + 1:, k:] -= m[:, None] * A[k, k:][None, :]
        b[k + 1:] -= m * b[k]
    x = np.zeros(n, np.complex128)
    for k in range(n - 1, -1, -1):
        x[k] = (b[k] - A[k, k + 1:] @ x[k + 1:]) / A[k, k]
    return x, list(orig)


@pytest.mark.parametrize("n", SCHEDULE_NS)
def test_schedule_against_complex128_jax_and_textbook(n):
    R, P = _systems(n)
    G128 = _solve128(R, P)
    A = _loaded(R)
    jsolve = jax.vmap(lambda r, p: jnp.linalg.solve(
        r + (1e-6 * (jnp.trace(r).real / n) + 1e-10) * jnp.eye(n, dtype=r.dtype), p))
    Gj = np.asarray(jsolve(jnp.asarray(R), jnp.asarray(P)))
    resid = lambda g, b: np.linalg.norm((A[b] @ g) - P[b]) / np.linalg.norm(P[b])
    for b in range(R.shape[0]):
        x, pivots, a = _schedule(R[b], P[b])
        assert np.abs(x - G128[b]).max() <= 1e-9 * np.abs(G128[b]).max()
        assert resid(x, b) < 1e-3 and resid(Gj[b], b) < 1e-3
        xt, orig = _textbook(A[b], P[b].astype(np.complex128))
        assert pivots == orig
        assert np.abs(x - xt).max() <= 1e-9 * np.abs(xt).max()
        rows, cols = a.shape
        assert not a[n:].any() and not a[:, n + 1:].any()   # the padding stays zero
        assert sorted(pivots) == list(range(n))             # padded rows never pivot


def test_schedule_breaks_ties_by_the_lowest_row():
    """Equal |a|^2 in the pivot column: the lowest live row wins, as in the
    kernel (a key of |a|^2's bits, reduced by max, then the row by min)."""
    A = np.array([[1, 2, 0], [-1, 1, 1], [1j, 0, 3]], np.complex64)
    x, pivots, _ = _schedule(A, np.array([1, 2, 3], np.complex64), diag_rel=0.0, eps=0.0)
    assert pivots[0] == 0
    assert np.abs(x - np.linalg.solve(A.astype(np.complex128), [1, 2, 3])).max() < 1e-12


# --- the CUDA source under the g++ emulation ---------------------------------------
def _emulated_library(tmp_path):
    """csrc/wpe_solve.cu compiled by g++ onto tests/cuda_emu, as a ctypes CDLL."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be emulated")
    src = open(os.path.join(os.path.dirname(K7.__file__), "..", "csrc", "wpe_solve.cu")).read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::smem());", src)
    src = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(([^;]*)\);",
                 lambda m: (f"emu::launch(dim3({m.group(2)}), dim3({m.group(3)}), {m.group(4)}, "
                            f"[&] {{ {m.group(1)}({m.group(6)}); }});"), src, flags=re.S)
    src = re.sub(r'asm\("rcp\.approx\.ftz\.f64 %0, %1;".*?\);', "r = emu_rcp_approx(d);", src,
                 flags=re.S)
    src = re.sub(r'asm volatile\("bar\.arrive %0, %1;".*?\);',
                 "emu::named_bar(id, 2 * kWarp, false);", src, flags=re.S)
    src = re.sub(r'asm volatile\("bar\.sync %0, %1;".*?\);',
                 "emu::named_bar(id, 2 * kWarp, true);", src, flags=re.S)
    assert "asm" not in src and "<<<" not in src
    cpp, lib = tmp_path / "wpe_solve_emu.cpp", tmp_path / "libwpe_solve_emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread", "-I",
                    EMU_DIR, "-o", str(lib), str(cpp)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.wpe_solve.argtypes = K7._SIGNATURES["wpe_solve"]
    so.wpe_solve.restype = ctypes.c_int
    return so


def _emulated_solve(so, R, P, sms):
    batch, n = P.shape
    plan = K7.solve_route(n, batch, sms=sms)
    G = np.zeros_like(P)
    work = np.zeros(max(plan.workspace_bytes, 16), np.uint8)
    err = so.wpe_solve(R.ctypes.data, P.ctypes.data, G.ctypes.data, batch, n, 1e-6, 1e-10,
                       plan.index, plan.smem_bytes,
                       work.ctypes.data if plan.workspace_bytes else None, plan.grid, None)
    assert err == 0
    return G, plan


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated library, compiled once for the module's tests."""
    return _emulated_library(tmp_path_factory.mktemp("emu"))


def test_cuda_source_under_emulation(emulated):
    so = emulated
    for n, batch, sms in ((1, 3, 1), (2, 3, 1), (10, 40, 1), (33, 4, 1), (50, 7, 2), (64, 3, 1),
                          (65, 3, 2), (120, 2, 1)):
        R, P = _systems(n, batch)
        G, plan = _emulated_solve(so, R, P, sms)
        assert plan.grid < batch or n <= 2          # CTAs loop over systems
        G128 = _solve128(R, P)
        err = np.abs(G - G128).max(-1) / np.abs(G128).max(-1)
        assert (err <= 1e-6).all(), (n, plan.route, err)
        if n in (10, 50, 65):
            assert np.array_equal(G, _emulated_solve(so, R, P, sms)[0])


def test_cuda_source_refuses_what_the_plan_refuses(emulated):
    """The C entry checks the plan: a route that does not hold n, or shared
    memory other than the plan's, is refused before any launch."""
    so = emulated
    R, P = _systems(50, 2)
    G = np.zeros_like(P)
    plan = K7.solve_route(50, 2)
    call = lambda index, smem: so.wpe_solve(R.ctypes.data, P.ctypes.data, G.ctypes.data, 2, 50,
                                            1e-6, 1e-10, index, smem, None, plan.grid, None)
    assert call(plan.index, plan.smem_bytes + 16) != 0
    assert call(plan.index - 1, plan.smem_bytes) != 0
    assert call(plan.index + 1, plan.smem_bytes) != 0
    assert call(len(K7.REG_INSTANCES), plan.smem_bytes) != 0   # large route, no workspace
    assert not G.any()


def test_wrapper_refuses_n_above_the_cap_before_the_card():
    """On a tensor that is not on the CPU the wrapper checks the plan first:
    n above the cap raises the plan's ValueError, whatever the device."""
    n = K7.MAX_N + 1
    R = torch.empty((1, n, n), dtype=torch.complex64, device="meta")
    P = torch.empty((1, n), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match=f"MAX_N = {K7.MAX_N}"):
        K7.wpe_solve(R, P)
