#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``buddy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card

Phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. building the CUDA kernels (K1, K2, K3, K4's loss pair, K5, K6, K7) from
   ``buddy_tpu_torch/csrc`` with nvcc, one process per source, all at once
   (K4's Triton compression compiles at its first launch, in phase 3);
3. each kernel at the main path's shapes and dtypes (K1 at the U-Net's four
   GroupNorm shapes, through its autograd wrapper and its C calls; K2 at its four geometries:
   operator, model, WPE and the operator's short `cons` spectra, with its
   synthesis compared bit for bit between two calls; K3's entry points with
   and without the hoisted frame spectrum, against the direct sums and the
   FFT-route plain versions; K4 at the loss's and the RIR regulariser's
   shape and in its three reductions; K5 at the shipped Nf and at Nf = 99,
   one launch a direction with no other kernel inside, its errors beside a
   float64 chain's, and the refusal of a row length it cannot plan), forward
   and backward, against its
   plain PyTorch version on the same inputs, with the stated tolerance, and
   timed beside its plain version and a PyTorch library call where one
   computes the same function (the yardstick; the port never calls it).
   Every timed call comes after an L2 flush (a write of twice the L2, left
   out of the profiler's tables by its kernel's name), so that inputs come
   from device memory as on the main path; K2, K3 and K4 are also timed
   warm (back to back) beside it.  Device us per launch come from the
   profiler;
4. the main path, through the tester: a paired test set (the 8 in-repo clean
   utterances of 65536 samples, 8 RIRs made from a seed) is written under
   chiprun_out/, and ``Tester.do_test()`` runs blind BUDDy dereverberation
   of it as one batch with the full-width network of
   conf/network/ncsnpp.yaml (random weights from a seed, bf16 body), full
   guidance, 10 operator updates per step, WPE warm init, T cut to 4 steps;
   every kernel's launch count must be > 0 (K2's are also logged by
   n_fft) and the five output directories must hold 8 finite WAVs each;
   then one more run under torch.profiler:
   device time of each of the port's kernels and of the rest, the count of
   kernel launches, and the device's idle share (the per-kernel table goes
   to chiprun_out/);
5. the tester's other paths: informed dereverberation (serial, time-domain
   RIR operator, 2 items) and unconditional sampling (2 samples of 65536)
   at full width with T=2; one item of 196608 samples through the chunked
   path at a small network; and the CLI, ``python -m
   buddy_tpu_torch.testing``, as a subprocess with a checkpoint that the
   JAX package wrote;
6. the blind program at a small size on the card (kernels) and on the CPU
   (plain versions) with the same weights and noise: the outputs must agree.

A JSON line of the kernels' results precedes the last line, which is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero without that line.  It imports nothing of JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_STEPS = 4                     # diffusion steps of the main-path run (T=201 in the tester)
OUT_DIR = os.path.join(REPO, "chiprun_out")
TINY_CKPT = os.path.join(REPO, "tests", "goldens", "torch_tiny.ckpt.npz")
TINY_CKPT_NET = ["network.nf=8", "network.ch_mult=[1,2,2,2]", "network.num_res_blocks=1"]
# the U-Net's four GroupNorm shapes (B, C, H, W) at full width, bf16
GN_SHAPES = [(8, 128, 256, 528), (8, 256, 128, 264), (8, 256, 64, 132), (8, 256, 32, 66)]
# K3 on the main path: utterances, bins, frames of the operator geometry, taps, pre
K3_SHAPE = (8, 513, 517, 100, 1)


def log(msg: str) -> None:
    print(msg, flush=True)


_FLUSH = {}


def l2_flush() -> None:
    """Overwrite a buffer of twice the L2 (in-place bitwise_not), so that the
    next call finds its inputs in device memory and not in the cache."""
    import torch
    if "buf" not in _FLUSH:
        l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
        _FLUSH["buf"] = torch.zeros(2 * l2, dtype=torch.uint8, device="cuda")
    _FLUSH["buf"].bitwise_not_()


def flush_keys() -> set:
    """The profiler's keys of the flush's kernels (profiled once alone), so
    that the per-launch tables leave them out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if "keys" not in _FLUSH:
        l2_flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            l2_flush()
            torch.cuda.synchronize()
        _FLUSH["keys"] = {e.key for e in prof.key_averages() if e.self_device_time_total > 0}
        if not _FLUSH["keys"]:
            raise AssertionError("the profiler shows no kernel of the L2 flush")
    return _FLUSH["keys"]


def cuda_ms(fn, reps: int = 20, repeats: int = 5, warmup: int = 3, cold: bool = True) -> float:
    """Device time of fn() in ms (CUDA events).  Cold (the default): the
    median over ``reps`` calls, each after an L2 flush that lies outside its
    events; warm: the median over ``repeats`` of the mean over ``reps``
    back-to-back calls on the same tensors."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if cold:
        times = []
        for _ in range(reps):
            l2_flush()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]
    means = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[len(means) // 2]


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err:.3e} exceeds tolerance {tol:.3e}")


def kernel_name(key: str) -> str:
    """A profiler key reduced to the kernel's function name (no return
    type, namespace, template arguments or parameters)."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0]


def profile_device_us(fn, reps: int = 20, cold: bool = True) -> dict:
    """{kernel name: [device us, launches]} over ``reps`` calls of fn()
    under torch.profiler (after one call outside it), each call after an L2
    flush when ``cold``; the flush's kernel is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    skip = flush_keys() if cold else set()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                l2_flush()
            fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and e.key not in skip:
            f = found.setdefault(kernel_name(e.key), [0.0, 0])
            f[0] += e.self_device_time_total
            f[1] += e.count
    return found


def device_us_per_launch(fn, names, reps: int = 20, cold: bool = True) -> dict:
    """Device us per launch of each kernel in ``names`` over ``reps`` calls of
    fn().  A profile that records no launch of a kernel is taken again, up
    to twice: the profiler now and then returns a window without the
    device's activity."""
    for _ in range(3):
        found = profile_device_us(fn, reps, cold)
        missing = [k for k in names if k not in found]
        if not missing:
            return {k: found[k][0] / found[k][1] for k in names}
    raise AssertionError(f"profile shows no launch of {missing} in three windows")


def device_us_per_call(fn, reps: int = 20, cold: bool = True) -> float:
    """Device us of all the kernels of one call of fn()."""
    return sum(t for t, _ in profile_device_us(fn, reps, cold).values()) / reps


def synthesis_basis(plan):
    """The window-folded inverse-DFT basis of an STFT plan as a
    conv_transpose1d weight (2F, 1, taps * hop): row f (f + F) holds
    w[s] * c_f * cos (-sin) (2 pi f s / n) with the ISTFT's weights c_f."""
    import numpy as np
    import torch
    n, F_ = plan.n_fft, plan.n_bins
    rows = plan.taps * plan.hop
    s = np.arange(rows)
    w = np.zeros(rows)
    w[:plan.support] = plan.window.cpu().numpy()
    c = plan.istft_weights.cpu().numpy().astype(np.float64)
    ang = 2.0 * np.pi * np.arange(F_)[:, None] * s[None, :] / n
    basis = np.concatenate([np.cos(ang), -np.sin(ang)]) * np.concatenate([c, c])[:, None] * w
    return torch.as_tensor(basis[:, None, :].astype(np.float32))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_checks(dev):
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.ops import groupnorm as K1, stft as K2, subband_conv as K3
    from buddy_tpu_torch.ops.fft_plan import conv_fft_size
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, dtype=torch.float32: torch.randn(s, generator=g, device=dev, dtype=dtype)
    crand = lambda *s: torch.complex(rand(*s), rand(*s))
    entries = {}

    # --- K1 GroupNorm + SiLU, the U-Net's four GN shapes, bf16 ----------------
    # forward and backward with d weight and d bias, through the autograd
    # wrapper (group_norm_act(...).backward, which picks the weight gradients
    # and casts them to the parameters' dtype) and through the two C calls,
    # against the plain version; device us per call from the profiler
    gn_table = []
    for i, (B, C, H, W) in enumerate(GN_SHAPES):
        x = (rand(B, C, H, W) * 2 + 0.3).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = 1 + 0.1 * rand(C), 0.1 * rand(C)
        G = min(C // 4, 32)
        dy = rand(B, C, H, W).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        y_p = K1.group_norm_act_plain(x, w, b, G, 1e-6, silu=True)
        xp = x.detach().requires_grad_(True)
        wp, bp = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        yp_graph = K1.group_norm_act_plain(xp, wp, bp, G, 1e-6, silu=True)
        yp_graph.backward(dy, retain_graph=True)
        # both normalise in float32 and round once to bf16: <= 1 bf16 ulp
        # (2^-7 relative) at the largest output; dx: float32 inside both,
        # rounded to bf16, 2 ulps of the largest; d weight, d bias: float32
        # sums of 1e5-1e7 terms in another order, 1e-3 of the largest
        tol = 2.0 ** -7 * float(y_p.abs().max())
        tol_b = 2.0 ** -6 * float(xp.grad.abs().max())
        tol_w = 1e-3 * float(wp.grad.abs().max())
        tol_db = 1e-3 * float(bp.grad.abs().max())
        where = f"{list(x.shape)}"
        # the public path, with and without the weight gradients asked for
        xa = x.detach().requires_grad_(True)
        wa, ba = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        ya = K1.group_norm_act(xa, wa, ba, G, 1e-6, silu=True)
        ya.backward(dy)
        check(f"groupnorm autograd y {where}", max_err(ya.detach().float(), y_p.float()), tol)
        check(f"groupnorm autograd dx {where}", max_err(xa.grad.float(), xp.grad.float()), tol_b)
        check(f"groupnorm autograd dweight {where}", max_err(wa.grad, wp.grad), tol_w)
        check(f"groupnorm autograd dbias {where}", max_err(ba.grad, bp.grad), tol_db)
        if (wa.grad.dtype, ba.grad.dtype) != (w.dtype, b.dtype):
            raise AssertionError(f"groupnorm autograd {where}: weight gradients of dtype "
                                 f"{wa.grad.dtype}, {ba.grad.dtype}")
        xo = x.detach().requires_grad_(True)
        K1.group_norm_act(xo, w, b, G, 1e-6, silu=True).backward(dy)
        if not torch.equal(xo.grad, xa.grad):
            raise AssertionError(f"groupnorm autograd {where}: dx differs without the weight "
                                 f"gradients")
        # the two C calls
        y_k, mr = K1._launch_forward(x, w, b, G, 1e-6, True)
        err_f = max_err(y_k.float(), y_p.float())
        check(f"groupnorm fwd {where}", err_f, tol)
        dx, dw, db = K1.group_norm_act_backward(x, dy, w, b, mr, True, True)
        err_b = max_err(dx.float(), xp.grad.float())
        check(f"groupnorm bwd dx {where}", err_b, tol_b)
        check(f"groupnorm bwd dweight {where}", max_err(dw, wp.grad), tol_w)
        check(f"groupnorm bwd dbias {where}", max_err(db, bp.grad), tol_db)
        again = K1.group_norm_act_backward(x, dy, w, b, mr, True, True)
        if not (torch.equal(y_k, K1._launch_forward(x, w, b, G, 1e-6, True)[0])
                and all(torch.equal(u, v) for u, v in zip((dx, dw, db), again))):
            raise AssertionError(f"groupnorm {where}: two calls differ")
        with torch.no_grad():
            reps = 20
            per_f = profile_device_us(lambda: K1._launch_forward(x, w, b, G, 1e-6, True), reps)
            per_b = profile_device_us(
                lambda: K1.group_norm_act_backward(x, dy, w, b, mr, True, False), reps)
        us_f = sum(t for t, _ in per_f.values()) / reps
        us_b = sum(t for t, _ in per_b.values()) / reps
        n = x.numel()
        gn_table.append(dict(shape=[B, C, H, W], us=(round(us_f, 1), round(us_b, 1)),
                             kernels={k: round(t / reps, 1) for k, (t, _) in
                                      {**per_f, **per_b}.items()},
                             bound_ms=(bound_ms(4 * n, 10 * n)[0], bound_ms(6 * n, 20 * n)[0])))
        if i == 0:
            _, mr = K1._launch_forward(x, w, b, G, 1e-6, True)
            xl = x.detach().requires_grad_(True)
            wl, bl = w.to(x.dtype), b.to(x.dtype)      # F.group_norm wants one dtype
            yl = F.silu(F.group_norm(xl, G, wl, bl, 1e-6))
            with torch.no_grad():
                t_fwd = (cuda_ms(lambda: K1.group_norm_act(x, w, b, G, 1e-6, silu=True)),
                         cuda_ms(lambda: K1.group_norm_act_plain(x, w, b, G, 1e-6, silu=True)),
                         cuda_ms(lambda: F.silu(F.group_norm(x, G, wl, bl, 1e-6))))
                t_bwd = (cuda_ms(lambda: K1.group_norm_act_backward(x, dy, w, b, mr, True, False)),
                         cuda_ms(lambda: torch.autograd.grad(yp_graph, xp, dy, retain_graph=True)),
                         cuda_ms(lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True)))
            shape = list(x.shape)
            entries["groupnorm_silu_fwd"] = dict(err=err_f, tol=tol, times=t_fwd, shape=shape,
                                                 bound=bound_ms(4 * n, 10 * n),
                                                 extra={"device_us": us_f})
            entries["groupnorm_silu_bwd"] = dict(err=err_b, tol=tol_b, times=t_bwd, shape=shape,
                                                 bound=bound_ms(6 * n, 20 * n),
                                                 extra={"device_us": us_b})
    log(f"kernel K1 groupnorm+silu: fwd/bwd (y, dx, dweight, dbias) through the autograd "
        f"wrapper and the C calls match the plain version, and are bit-identical between two "
        f"calls, at {GN_SHAPES}; device us per call (cold) [fwd, bwd] and bound ms [fwd, bwd]: "
        + json.dumps(gn_table))

    # --- K2 STFT / ISTFT at the main path's geometries -------------------------
    # operator: 1024/128, hann(512) right-padded, constant, on apply_stft's
    # win_length-right-padded signal; model: 510/128 reflect, the synthesis
    # at the 528 frames of pad_spec_frames; WPE warm init: 512/128 constant;
    # cons: the operator geometry on the 12928-sample RIR, 102 frames, where
    # the kernels cut their tiles smaller to fill the card
    op_window = np.pad(hann_window(512), (0, 512))
    geometries = {
        "operator": (1024, op_window, "constant", 65536 + 512, None),
        "model": (510, hann_window(510), "reflect", 65536, 528),
        "wpe": (512, hann_window(512), "constant", 65536, None),
        "cons": (1024, op_window, "constant", 12928, None),
    }
    k2_names = ("stft_analysis_kernel", "stft_synthesis_kernel")
    for gname, (n_fft, window, pad_mode, length, frames) in geometries.items():
        geom = STFT(n_fft, 128, window, pad_mode=pad_mode, device=dev)
        plan = geom.plan
        wt = torch.as_tensor(window, device=dev)
        x = rand(8, length)
        blocks, T = geom.frame_blocks(x)
        spec_k = K2.stft_analysis(blocks, plan, T)
        spec_a = K2.analysis_plain(blocks, plan, T, plan.ones).contiguous()
        tol_a = 1e-4 * float(spec_a.abs().max())   # float32 FFTs of n_fft points, two orders
        err_a = max_err(torch.view_as_real(spec_k), torch.view_as_real(spec_a))
        check(f"stft_analysis {gname}", err_a, tol_a)
        spec = F.pad(spec_a, (0, frames - T)) if frames else spec_a
        y_k = K2.stft_synthesis(spec, plan)
        y_p = K2.synthesis_plain(spec, plan, plan.istft_weights)
        tol_s = 1e-4 * float(y_p.abs().max())
        err_s = max_err(y_k, y_p)
        check(f"stft_synthesis {gname}", err_s, tol_s)
        if not torch.equal(y_k, K2.stft_synthesis(spec, plan)):
            raise AssertionError(f"stft_synthesis {gname}: two calls differ")
        # backward: each kernel's adjoint is the other kernel, against autograd
        # through the plain version's torch.fft ops
        gspec = crand(*spec_a.shape)
        bk, bp = blocks.detach().requires_grad_(True), blocks.detach().requires_grad_(True)
        K2.stft_analysis(bk, plan, T).backward(gspec)
        K2.analysis_plain(bp, plan, T, plan.ones).backward(gspec)
        err_ab = max_err(bk.grad, bp.grad)
        check(f"stft_analysis bwd {gname}", err_ab, 1e-4 * float(bp.grad.abs().max()))
        gy = rand(*y_p.shape)
        sk, sp = spec.detach().requires_grad_(True), spec.detach().requires_grad_(True)
        K2.stft_synthesis(sk, plan).backward(gy)
        K2.synthesis_plain(sp, plan, plan.istft_weights).backward(gy)
        err_sb = max_err(torch.view_as_real(sk.grad), torch.view_as_real(sp.grad))
        check(f"stft_synthesis bwd {gname}", err_sb, 1e-4 * float(sp.grad.abs().max()))
        # the synthesis's library call: the transposed conv over hop-blocks
        # that the TPU's _istft_conv is built on, with the window-folded
        # inverse-DFT basis as its weight
        z = torch.cat([spec.real, spec.imag], 1).contiguous()            # (N, 2F, T)
        wct = synthesis_basis(plan).to(dev)
        conv_t = lambda: F.conv_transpose1d(z, wct, stride=plan.hop)
        check(f"stft_synthesis {gname} (library)", max_err(conv_t()[:, 0], y_p),
              1e-3 * float(y_p.abs().max()))
        with torch.no_grad():
            t_a = (cuda_ms(lambda: K2.stft_analysis(blocks, plan, T)),
                   cuda_ms(lambda: K2.analysis_plain(blocks, plan, T, plan.ones)),
                   cuda_ms(lambda: torch.stft(x, n_fft, 128, window=wt, center=True,
                                              pad_mode=pad_mode, return_complex=True)))
            t_s = (cuda_ms(lambda: K2.stft_synthesis(spec, plan)),
                   cuda_ms(lambda: K2.synthesis_plain(spec, plan, plan.istft_weights)),
                   cuda_ms(conv_t))
            # torch.istft refuses the operator's half-zero window (its
            # overlap-add check), so it is timed at the model and WPE geometries
            t_istft = None if n_fft == 1024 else cuda_ms(
                lambda: torch.istft(spec, n_fft, 128, window=wt, center=True, length=length))
            pair = lambda: (K2.stft_analysis(blocks, plan, T), K2.stft_synthesis(spec, plan))
            lib_a = lambda: torch.stft(x, n_fft, 128, window=wt, center=True, pad_mode=pad_mode,
                                       return_complex=True)
            dev_us = device_us_per_launch(pair, k2_names)
            lib_us = (device_us_per_call(lib_a), device_us_per_call(conv_t))
            # the same back to back, inputs warm in the L2 (for comparison with
            # the numbers recorded before the flush)
            dev_us_warm = device_us_per_launch(pair, k2_names, cold=False)
            lib_us_warm = (device_us_per_call(lib_a, cold=False),
                           device_us_per_call(conv_t, cold=False))
        # the least time for the same work: the signal read and the spectrum
        # written once, against a real FFT's 2.5 n log2 n operations per frame
        fft_flops = 2.5 * n_fft * np.log2(n_fft) * blocks.shape[0]
        b_a = bound_ms(4 * blocks.numel() + 8 * spec_a.numel(), fft_flops * T)
        b_s = bound_ms(8 * spec.numel() + 4 * y_p.numel(), fft_flops * spec.shape[-1])
        us_a, us_s = dev_us["stft_analysis_kernel"], dev_us["stft_synthesis_kernel"]
        log(f"kernel K2 stft, {gname} geometry ({n_fft}/128, {pad_mode}): blocks "
            f"{list(blocks.shape)} -> spec {list(spec.shape)}; max abs err fwd {err_a:.3e}/{err_s:.3e} "
            f"bwd {err_ab:.3e}/{err_sb:.3e} (analysis/synthesis; tolerance 1e-4 of the peak); "
            f"synthesis bit-identical between two calls; ms kernel/plain/library: analysis "
            f"{[round(t, 4) for t in t_a]} (torch.stft), synthesis {[round(t, 4) for t in t_s]} "
            f"(conv_transpose1d), torch.istft {'refused' if t_istft is None else round(t_istft, 4)}; "
            f"device us per launch (profile) analysis {us_a:.1f}, synthesis {us_s:.1f}; bound ms "
            f"analysis {b_a[0]:.4f} ({b_a[1]}), synthesis {b_s[0]:.4f} ({b_s[1]}); device time / "
            f"bound: analysis {us_a / 1e3 / b_a[0]:.2f}, synthesis {us_s / 1e3 / b_s[0]:.2f}; "
            f"device time / library ms: analysis {us_a / 1e3 / t_a[2]:.2f}, synthesis "
            f"{us_s / 1e3 / t_s[2]:.2f}; library device us per call: torch.stft {lib_us[0]:.1f}, "
            f"conv_transpose1d {lib_us[1]:.1f}; device time / library device time: analysis "
            f"{us_a / lib_us[0]:.2f}, synthesis {us_s / lib_us[1]:.2f} (all after an L2 flush); "
            f"warm (back to back): device us per launch analysis "
            f"{dev_us_warm['stft_analysis_kernel']:.1f}, synthesis "
            f"{dev_us_warm['stft_synthesis_kernel']:.1f}, library {lib_us_warm[0]:.1f} / "
            f"{lib_us_warm[1]:.1f}")
        if gname == "operator":                    # the kernels line reports this geometry
            entries["stft_analysis"] = dict(err=err_a, tol=tol_a, shape=list(blocks.shape),
                                            times=t_a, bound=b_a, extra={
                                                "device_us": us_a, "library_device_us": lib_us[0],
                                                "device_us_warm": dev_us_warm[k2_names[0]],
                                                "library_device_us_warm": lib_us_warm[0]})
            entries["stft_synthesis"] = dict(err=err_s, tol=tol_s, shape=list(spec.shape),
                                             times=t_s, bound=b_s, extra={
                                                 "device_us": us_s, "library_device_us": lib_us[1],
                                                 "device_us_warm": dev_us_warm[k2_names[1]],
                                                 "library_device_us_warm": lib_us_warm[1]})

    # --- K3 subband convolution (B=8, F=513, T=517, Nf=100, pre=1) ----------------
    # each entry point with and without the hoisted frame spectrum, against
    # the direct sums and the FFT-route plain versions; the bound counts X
    # (or its spectrum) and H read once and the output written once against
    # 5 n log2 n operations a complex transform of a row, and an entry's
    # bound in the kernels line is the lesser of its two routes' (the least
    # work for the function: from X, which has T frames a row to the
    # spectrum's n, the bytes are fewer)
    Bn, Fb, Tf, Nf, pre = K3_SHAPE
    X, Hf, Gy = crand(Bn, Fb, Tf), crand(Bn, Fb, Nf), crand(Bn, Fb, Tf)
    n = conv_fft_size(Tf, Nf)
    Xs = K3.frame_spectrum(X, Nf)
    fft, ifft = torch.fft.fft, torch.fft.ifft
    k3 = {   # name: ({variant: kernel call}, direct plain, {variant: FFT-route plain}, library,
             #        {variant: (bytes, transforms a row)})
        "subband_conv": (
            {"hoisted": lambda: K3.subband_conv(X, Hf, pre, Xs),
             "from X": lambda: K3.subband_conv(X, Hf, pre)},
            lambda: K3.subband_conv_plain(X, Hf, pre),
            {"hoisted": lambda: K3.subband_conv_fft_plain(X, Hf, pre, fft(X, n)),
             "from X": lambda: K3.subband_conv_fft_plain(X, Hf, pre)},
            lambda: ifft(fft(X, n) * fft(Hf, n))[..., pre:pre + Tf],
            {"hoisted": (8 * (Xs.numel() + Hf.numel() + X.numel()), 2),
             "from X": (8 * (2 * X.numel() + Hf.numel()), 3)}),
        "subband_conv_adjoint": (
            {"": lambda: K3.subband_conv_adjoint(Gy, Hf, pre)},
            lambda: K3.subband_conv_adjoint_plain(Gy, Hf, pre),
            {"": lambda: K3.subband_conv_adjoint_fft_plain(Gy, Hf, pre)},
            lambda: torch.roll(ifft(fft(Gy, n) * fft(Hf, n).conj()), pre, -1)[..., :Tf],
            {"": (8 * (2 * Gy.numel() + Hf.numel()), 3)}),
        "subband_conv_filter_grad": (
            {"hoisted": lambda: K3.subband_conv_filter_grad(Gy, X, Nf, pre, Xs),
             "from X": lambda: K3.subband_conv_filter_grad(Gy, X, Nf, pre)},
            lambda: K3.subband_conv_filter_grad_plain(Gy, X, Nf, pre),
            {"hoisted": lambda: K3.subband_conv_filter_grad_fft_plain(Gy, X, Nf, pre, fft(X, n)),
             "from X": lambda: K3.subband_conv_filter_grad_fft_plain(Gy, X, Nf, pre)},
            lambda: torch.roll(ifft(fft(Gy, n) * fft(X, n).conj()), pre, -1)[..., :Nf],
            {"hoisted": (8 * (Gy.numel() + Xs.numel() + Hf.numel()), 2),
             "from X": (8 * (Gy.numel() + X.numel() + Hf.numel()), 3)}),
        "frame_spectrum": (
            {"": lambda: K3.frame_spectrum(X, Nf)},
            lambda: K3.frame_spectrum_plain(X, Nf), {}, lambda: fft(X, n),
            {"": (8 * (X.numel() + Xs.numel()), 1)}),
    }
    rows = Bn * Fb
    fft_ops = 5.0 * n * np.log2(n) * rows
    k3_log = {}
    with torch.no_grad():
        for name, (kerns, plain, fft_plains, library, work) in k3.items():
            op = plain()
            tol = 1e-4 * float(op.abs().max())     # float32 FFTs of n points against direct sums
            check(f"{name} (library)",
                  max_err(torch.view_as_real(library()), torch.view_as_real(op)),
                  1e-3 * float(op.abs().max()))
            lib_ms = cuda_ms(library)
            lib_us = device_us_per_call(library)
            lib_us_warm = device_us_per_call(library, cold=False)
            plain_ms = cuda_ms(plain)
            bounds = {}
            for variant, kern in kerns.items():
                ok = kern()
                err = max_err(torch.view_as_real(ok), torch.view_as_real(op))
                check(f"{name} {variant}", err, tol)
                if variant in fft_plains:
                    check(f"{name} {variant} (FFT-route plain)",
                          max_err(torch.view_as_real(ok),
                                  torch.view_as_real(fft_plains[variant]())), tol)
                if not torch.equal(ok, kern()):
                    raise AssertionError(f"{name} {variant}: two calls differ")
                k3_name = ["subband_fft_conv_kernel"]
                us = device_us_per_launch(kern, k3_name)[k3_name[0]]
                us_warm = device_us_per_launch(kern, k3_name, cold=False)[k3_name[0]]
                nbytes, transforms = work[variant]
                bound = bounds[variant] = bound_ms(nbytes, transforms * fft_ops)
                ms, ms_warm = cuda_ms(kern), cuda_ms(kern, cold=False)
                k3_log[f"{name} {variant}".strip()] = {
                    "err": err, "tol": tol, "ms": ms, "ms_warm": ms_warm, "device_us": us,
                    "device_us_warm": us_warm, "bound_ms": bound, "library_ms": lib_ms,
                    "library_device_us": lib_us, "library_device_us_warm": lib_us_warm,
                    "device_time_over_library": us / lib_us, "plain_ms": plain_ms}
                if variant in ("", "hoisted"):
                    entries[name] = dict(
                        err=err, tol=tol, shape=[Bn, Fb, Tf, Nf, n], times=(ms, plain_ms, lib_ms),
                        bound=bound, extra={"variant": variant or None, "device_us": us,
                                            "device_us_warm": us_warm, "ms_warm": ms_warm,
                                            "library_device_us": lib_us,
                                            "library_device_us_warm": lib_us_warm})
                else:
                    entries[name]["extra"][variant] = {"ms": ms, "device_us": us,
                                                       "bound_ms": bound[0]}
            entries[name]["bound"] = min(bounds.values())
            if len(bounds) > 1:
                entries[name]["extra"]["bound_ms_hoisted"] = bounds["hoisted"][0]
    log(f"kernel K3 subband conv (FFTs of n = {n} in shared memory): fwd/adjoint/filter-grad, "
        f"with and without the hoisted frame spectrum, and the frame spectrum match the direct "
        f"sums and the FFT-route plain versions (1e-4 of the peak) and are bit-identical between "
        f"two calls at X {list(X.shape)}, H {list(Hf.shape)}; cold (L2 flushed) and warm times, "
        f"bounds (ms, by) and the torch.fft yardstick's device us: " + json.dumps(k3_log))
    return entries


def fused_kernel_checks(dev):
    """K4-K7 against their plain versions at the main path's shapes."""
    import numpy as np
    import torch
    import buddy_tpu_torch.sampling.wpe as wpe
    from buddy_tpu_torch.config import compose
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    from buddy_tpu_torch.ops import filter_design as K6, minphase as K5, spec_loss as K4
    from buddy_tpu_torch.ops import wpe_solve as K7
    from buddy_tpu_torch.ops.stft import STFT, hann_window

    g = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    crand = lambda *s: torch.complex(rand(*s), rand(*s))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    entries = {}
    args = compose("conf_VCTK.yaml", ["tester=blind_dereverberation_BUDDy"])
    op = BlindSubbandFiltering(args["tester"]["informed_dereverberation"]["op_hp"],
                               sample_rate=16000, device=dev)
    c = float(args["tester"]["posterior_sampling"]["rec_loss"]["compression_factor"])
    B = 8

    # --- K4 compressed-STFT loss: the observation's shape and the RIR regulariser's -----
    T_loss = op.apply_stft(torch.zeros(1, 65536, device=dev)).shape[-1]
    T_reg = op.apply_stft(torch.zeros(1, op.length_rir + 1024, device=dev)).shape[-1]
    for T in (T_loss, T_reg):
        X = crand(B, 513, T) * 0.3
        X[..., -4:] = 0                                  # apply_stft's zero-padded frames
        Aref = K4.compress_plain(crand(B, 513, T) * 0.3, c)
        gC = crand(B, 513, T)
        # compression: float32 pow as exp(c log m) in the kernel against torch's pow,
        # a few ulp: 1e-5 of the peak, forward and backward
        Ck, Cp = K4.spec_compress(X, c), K4.compress_plain(X, c)
        e_cf = max_err(torch.view_as_real(Ck), torch.view_as_real(Cp))
        t_cf = 1e-5 * float(Cp.abs().max())
        check(f"spec_compress fwd T={T}", e_cf, t_cf)
        dk, dp = K4.spec_compress_backward(X, gC, c), K4.compress_backward_plain(X, gC, c)
        e_cb = max_err(torch.view_as_real(dk), torch.view_as_real(dp))
        t_cb = 1e-5 * float(dp.abs().max())
        check(f"spec_compress bwd T={T}", e_cb, t_cb)
        e_lf = e_lb = 0.0
        for red, div in (("sum", 1.0), ("mean", 513.0 * T), ("summean", float(T))):
            scale = 512.0 / div
            Lk, Lp = K4.comp_loss(Aref, X, c, scale), K4.comp_loss_plain(Aref, X, c, scale)
            # float32 sums of 513*T terms in another order: 1e-4 relative
            check(f"comp_loss fwd {red} T={T}", rel(Lk, Lp), 1e-4)
            if not torch.equal(Lk, K4.comp_loss(Aref, X, c, scale)):
                raise AssertionError(f"comp_loss fwd {red} T={T}: two calls differ")
            e_lf = max(e_lf, rel(Lk, Lp))
            gL = rand(B)
            gk = K4.comp_loss_backward(Aref, X, gL, c, scale)
            gp = K4.comp_loss_backward_plain(Aref, X, gL, c, scale)
            for what, a, b in (("dA", gk[0], gp[0]), ("dX", gk[1], gp[1])):
                e = max_err(torch.view_as_real(a), torch.view_as_real(b)) / float(b.abs().max())
                check(f"comp_loss bwd {what} {red} T={T}", e, 1e-5)   # elementwise, as above
                e_lb = max(e_lb, e)
        if T == T_loss:
            n = X.numel()
            scale = 512.0 / T
            Xg = X.detach().requires_grad_(True)
            Lg = K4.comp_loss_plain(Aref, Xg, c, scale)
            Cg = K4.compress_plain(Xg, c)
            ones = torch.ones(B, device=dev)
            with torch.no_grad():
                times_cf = (cuda_ms(lambda: K4.spec_compress(X, c)),
                            cuda_ms(lambda: K4.compress_plain(X, c)), None)
                times_lf = (cuda_ms(lambda: K4.comp_loss(Aref, X, c, scale)),
                            cuda_ms(lambda: K4.comp_loss_plain(Aref, X, c, scale)), None)
            times_cb = (cuda_ms(lambda: K4.spec_compress_backward(X, gC, c)),
                        cuda_ms(lambda: torch.autograd.grad(Cg, Xg, gC, retain_graph=True)), None)
            times_lb = (cuda_ms(lambda: K4.comp_loss_backward(Aref, X, ones, c, scale,
                                                              need_a=False)),
                        cuda_ms(lambda: torch.autograd.grad(Lg, Xg, ones, retain_graph=True)),
                        None)
            # device us per launch, cold (L2 flushed) and warm (back to back)
            k4_calls = {
                "compress_kernel": lambda: K4.spec_compress(X, c),
                "compress_bwd_kernel": lambda: K4.spec_compress_backward(X, gC, c),
                "comp_loss_fwd_kernel": lambda: K4.comp_loss(Aref, X, c, scale),
                "comp_loss_bwd_kernel": lambda: K4.comp_loss_backward(Aref, X, ones, c, scale,
                                                                      need_a=False)}
            k4_us = {}
            with torch.no_grad():
                for kname, call in k4_calls.items():
                    k4_us[kname] = (device_us_per_launch(call, [kname])[kname],
                                    device_us_per_launch(call, [kname], cold=False)[kname],
                                    cuda_ms(call, cold=False))
            shape = list(X.shape)
            extra = lambda k: {"device_us": k4_us[k][0], "device_us_warm": k4_us[k][1],
                               "ms_warm": k4_us[k][2]}
            entries["spec_compress_fwd"] = dict(err=e_cf, tol=t_cf, times=times_cf, shape=shape,
                                                bound=bound_ms(16 * n, 30 * n),
                                                extra=extra("compress_kernel"))
            entries["spec_compress_bwd"] = dict(err=e_cb, tol=t_cb, times=times_cb, shape=shape,
                                                bound=bound_ms(24 * n, 50 * n),
                                                extra=extra("compress_bwd_kernel"))
            entries["comp_loss_fwd"] = dict(err=e_lf, tol=1e-4, times=times_lf, shape=shape,
                                            bound=bound_ms(16 * n + 4 * B, 40 * n),
                                            extra=extra("comp_loss_fwd_kernel"))
            entries["comp_loss_bwd"] = dict(err=e_lb, tol=1e-5, times=times_lb, shape=shape,
                                            bound=bound_ms(24 * n + 4 * B, 80 * n),
                                            extra=extra("comp_loss_bwd_kernel"))
    log(f"kernel K4 compressed loss: compression (Triton) and loss (CUDA), fwd/bwd, "
        f"sum/mean/summean, match the plain version at (8,513,{T_loss}) and (8,513,{T_reg}), the "
        f"loss bit-identical between two calls; at (8,513,{T_loss}) device us per launch cold / "
        f"warm and the warm CUDA-event ms: " + json.dumps(k4_us))

    # --- K5 minimum phase: the operator's RIR (8, 12928) -> n = 25856 ---------------------
    # one CUDA launch a direction, its four transforms inside: held against the
    # plain version (torch.fft) at 1e-4 of the peak forward and 5e-4 backward
    # (float32 FFTs of 25856 points on both sides, through log and exp at phases
    # of tens of radians), with both sides' error against a float64 chain
    # printed beside; bit-identical between two calls; at the shipped Nf = 100
    # (L = 128 x 101) and at Nf = 99 (L = 12800 = 128 x 100, another plan); a
    # row length with no plan raises
    k5_log = {}
    for Nf in (100, 99):
        L = op.hop_length * (Nf + 1)
        h = rand(B, L) * torch.exp(-torch.arange(L, device=dev) / 2000.0)
        h[:, 0] = 2.0
        gy = rand(B, L)
        yk, Hs, phs = K5._launch_forward(h)
        yp = K5.minimum_phase_plain(h)
        e_mf, t_mf = max_err(yk, yp), 1e-4 * float(yp.abs().max())
        check(f"minimum_phase fwd Nf={Nf}", e_mf, t_mf)
        hk, hp = h.detach().requires_grad_(True), h.detach().requires_grad_(True)
        K5.minimum_phase_version(hk).backward(gy)
        yp_graph = K5.minimum_phase_plain(hp)
        (gp,) = torch.autograd.grad(yp_graph, hp, gy, retain_graph=True)
        e_mb, t_mb = max_err(hk.grad, gp), 5e-4 * float(gp.abs().max())
        check(f"minimum_phase bwd Nf={Nf}", e_mb, t_mb)
        check(f"minimum_phase bwd (explicit formula) Nf={Nf}",
              max_err(K5.minimum_phase_backward_plain(h, gy), gp), t_mb)
        dk = K5.minimum_phase_backward(Hs, phs, gy)
        if not (torch.equal(yk, K5._launch_forward(h)[0])
                and torch.equal(dk, K5.minimum_phase_backward(Hs, phs, gy))):
            raise AssertionError(f"minimum_phase Nf={Nf}: two calls differ")
        h64, g64 = h.double(), gy.double()
        y64, d64 = K5.minimum_phase_plain(h64), K5.minimum_phase_backward_plain(h64, g64)
        k5_log[f"Nf={Nf} L={L}"] = {
            "fwd": {"err": e_mf, "tol": t_mf, "kernel_vs_float64": max_err(yk.double(), y64),
                    "plain_vs_float64": max_err(yp.double(), y64)},
            "bwd": {"err": e_mb, "tol": t_mb, "kernel_vs_float64": max_err(dk.double(), d64),
                    "plain_vs_float64": max_err(gp.double(), d64)}}
        if Nf != 100:
            continue
        # one launch a direction, and no cuFFT or Triton kernel inside a call
        k5_names = {"fwd": (lambda: K5._launch_forward(h), "minphase_fwd_kernel"),
                    "bwd": (lambda: K5.minimum_phase_backward(Hs, phs, gy), "minphase_bwd_kernel")}
        k5_us = {}
        with torch.no_grad():
            for what, (call, kname) in k5_names.items():
                found = profile_device_us(call)
                if set(found) != {kname} or found[kname][1] != 20:
                    raise AssertionError(f"minimum_phase {what}: one call runs {found}, not one "
                                         f"{kname}")
                k5_us[what] = (found[kname][0] / 20,
                               device_us_per_launch(call, [kname], cold=False)[kname])
            t_f = (cuda_ms(lambda: K5.minimum_phase_version(h)),
                   cuda_ms(lambda: K5.minimum_phase_plain(h)), None)
        t_b = (cuda_ms(lambda: K5.minimum_phase_backward(Hs, phs, gy)),
               cuda_ms(lambda: torch.autograd.grad(yp_graph, hp, gy, retain_graph=True)), None)
        n = 2 * L
        # the least work: four real FFTs of n points (2.5 n log2 n each) and the
        # elementwise passes (~60 operations a point) against h read and y
        # written (backward: h and g read, dh written)
        ops = B * (4 * 2.5 * n * np.log2(n) + 60.0 * n)
        for what, times, nbytes, err, tol in (("fwd", t_f, 8 * B * L, e_mf, t_mf),
                                              ("bwd", t_b, 12 * B * L, e_mb, t_mb)):
            entries[f"minphase_{what}"] = dict(
                err=err, tol=tol, times=times, shape=[B, L], bound=bound_ms(nbytes, ops),
                extra={"device_us": k5_us[what][0], "device_us_warm": k5_us[what][1]})
    try:
        K5._launch_forward(rand(B, op.hop_length * 131))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("minimum_phase: Nf = 130 (L = 128 x 131) has no plan but ran")
    log(f"kernel K5 minimum phase (one cluster launch a direction, FFTs inside): fwd/bwd match "
        f"the plain version at h [8, L], bit-identical between two calls, one launch a call and "
        f"no other kernel; Nf = 130 refused ({refused}); errors, tolerances and both sides "
        f"against float64: " + json.dumps(k5_log) + "; device us per launch cold / warm: "
        + json.dumps(k5_us))

    # --- K6 filter design + phasor at the operator's parameters ---------------------------
    params, _ = op.reset_batched(B, generator=torch.Generator(device=dev).manual_seed(2))
    decay = params["decay"] * (0.5 + torch.rand(params["decay"].shape, generator=g, device=dev))
    weights = params["weights"] * (0.5 + torch.rand(decay.shape, generator=g, device=dev))
    phases = params["phases"]
    geom = op._design_geometry
    gH = crand(*phases.shape)
    Hk, Hp = K6.filter_design(decay, weights, phases, geom), \
        K6.filter_design_plain(decay, weights, phases, geom)
    # decay^(-n) up to n = 99, log, exp and sincos in float32 on both sides: 1e-4 of the peak
    e_df = max_err(torch.view_as_real(Hk), torch.view_as_real(Hp))
    t_df = 1e-4 * float(Hp.abs().max())
    check("filter_design fwd", e_df, t_df)
    leaves = [t.detach().requires_grad_(True) for t in (decay, weights, phases)]
    Hp_graph = K6.filter_design_plain(*leaves, geom)
    auto = torch.autograd.grad(Hp_graph, leaves, gH, retain_graph=True)
    kern = K6.filter_design_backward(decay, weights, phases, gH, geom)
    again = K6.filter_design_backward(decay, weights, phases, gH, geom)
    e_db = 0.0
    for what, a, b, r in zip(("ddecay", "dweights", "dphases"), kern, auto, again):
        # decay and weights: float32 sums of ~51k terms in another order: 1e-3 of the peak
        e = float((a - b).abs().max() / b.abs().max())
        check(f"filter_design bwd {what}", e, 1e-3)
        e_db = max(e_db, e)
        if not torch.equal(a, r):
            raise AssertionError(f"filter_design bwd {what} differs between two runs")
    with torch.no_grad():
        t_f = (cuda_ms(lambda: K6.filter_design(decay, weights, phases, geom)),
               cuda_ms(lambda: K6.filter_design_plain(decay, weights, phases, geom)), None)
    t_b = (cuda_ms(lambda: K6.filter_design_backward(decay, weights, phases, gH, geom)),
           cuda_ms(lambda: torch.autograd.grad(Hp_graph, leaves, gH, retain_graph=True)), None)
    n = phases.numel()
    small = 4 * (2 * decay.numel() + geom.dpc.numel())
    entries["filter_design_fwd"] = dict(err=e_df, tol=t_df, times=t_f, shape=list(phases.shape),
                                        bound=bound_ms(12 * n + small, 120.0 * n))
    entries["filter_design_bwd"] = dict(err=e_db, tol=1e-3, times=t_b, shape=list(phases.shape),
                                        bound=bound_ms(16 * n + small, 160.0 * n))
    log(f"kernel K6 filter design: fwd/bwd match the plain version at params "
        f"{list(decay.shape)}, phases {list(phases.shape)}; the backward is bit-identical "
        f"between two runs")

    # --- K7 WPE solve: the systems of the warm init, 8 x 257 bins of 50 x 50 ---------------
    ys = torch.from_numpy(load_wavs("degraded", 8, 65536)).to(dev)[:, 0]
    geomw = STFT(512, 128, hann_window(512), pad_mode="constant", device=dev)
    Y = geomw.stft(ys)
    taps, delay = 50, 2
    Yt = wpe._build_y_tilde(Y, taps, delay)
    Yn = Yt / torch.clamp(torch.abs(Y) ** 2, min=1e-10)[..., None, :]
    R = (Yn @ Yt.conj().transpose(-1, -2)).contiguous()
    P = (Yn @ Y.conj()[..., None])[..., 0].contiguous()
    load = 1e-6 * torch.diagonal(R, dim1=-2, dim2=-1).real.sum(-1).double() / taps + 1e-10
    A64 = R.to(torch.complex128) + load[..., None, None] * torch.eye(taps, device=dev)
    P64 = P.to(torch.complex128)
    resid = lambda G: float(torch.linalg.norm((A64 @ G.to(torch.complex128)[..., None])[..., 0]
                                              - P64) / torch.linalg.norm(P64))
    Gk, Gp = K7.wpe_solve(R, P), K7.wpe_solve_plain(R, P)
    r_k, r_p = resid(Gk), resid(Gp)
    if not (r_k <= max(r_p, 1e-6)):
        raise AssertionError(f"wpe_solve: residual {r_k:.3e} above the plain version's {r_p:.3e}")

    def dereverb(solve, spec=Y, iterations=1):
        old, wpe.wpe_solve = wpe.wpe_solve, solve
        X = wpe.wpe_bins(spec, taps, delay, iterations)
        wpe.wpe_solve = old
        return geomw.istft(X.to(torch.complex64), length=ys.shape[-1])

    def solve64(Rm, Pm, diag_rel, eps):
        ld = diag_rel * torch.diagonal(Rm, dim1=-2, dim2=-1).real.sum(-1).double() / taps + eps
        M = Rm.to(torch.complex128) + ld[..., None, None] * torch.eye(taps, device=dev)
        return torch.linalg.solve(M, Pm.to(torch.complex128)).to(Pm.dtype)

    # one WPE iteration isolates the solve (the same R and P on every side): the kernel's
    # waveform must be no further from the complex128 solve's than the plain complex64
    # solve's is
    x64 = dereverb(solve64)
    peak = float(x64.abs().max())
    d_k, d_p = max_err(dereverb(K7.wpe_solve), x64), max_err(dereverb(K7.wpe_solve_plain), x64)
    check("wpe_solve: dereverberated waveform against the complex128 solve", d_k, d_p)
    # all five iterations against WPE in complex128 throughout, for the record: the
    # correlations are formed in complex64 on both sides and the iterations amplify that
    full64 = dereverb(solve64, Y.to(torch.complex128), 5)
    d5_k = max_err(dereverb(K7.wpe_solve, iterations=5), full64) / float(full64.abs().max())
    d5_p = max_err(dereverb(K7.wpe_solve_plain, iterations=5), full64) / float(full64.abs().max())
    eye = torch.eye(taps, dtype=R.dtype, device=dev)
    Ald = R + load.float()[..., None, None] * eye

    def chol():
        Lc, _ = torch.linalg.cholesky_ex(Ald)
        return torch.cholesky_solve(P[..., None], Lc)

    with torch.no_grad():
        t_solve = (cuda_ms(lambda: K7.wpe_solve(R, P), reps=5), cuda_ms(
            lambda: K7.wpe_solve_plain(R, P), reps=5),
            cuda_ms(lambda: torch.linalg.solve(Ald, P), reps=5))
        t_chol = cuda_ms(chol, reps=5)
    nsys = P.numel() // taps
    # library_ms is the faster of the two library routes; both stand beside it by name
    entries["wpe_solve"] = dict(err=d_k, tol=d_p, shape=[nsys, taps, taps],
                                times=(t_solve[0], t_solve[1], min(t_solve[2], t_chol)),
                                bound=bound_ms(8 * (R.numel() + 2 * P.numel()),
                                               nsys * 8.0 * taps ** 3 / 3),
                                extra={"library_linalg_solve_ms": t_solve[2],
                                       "library_cholesky_ms": t_chol})
    log(f"kernel K7 WPE solve (LU with partial pivoting in float64): {nsys} systems of "
        f"{taps}x{taps}; residual |(R+load I)G-P|/|P| kernel {r_k:.3e}, plain complex64 "
        f"{r_p:.3e}; dereverberated waveform after one iteration against the complex128 solve, "
        f"max abs / peak: kernel {d_k / peak:.3e}, plain {d_p / peak:.3e}; after five iterations "
        f"against WPE in complex128 throughout: kernel {d5_k:.3e}, plain {d5_p:.3e}; ms kernel {t_solve[0]:.4f}, "
        f"torch.linalg.solve {t_solve[2]:.4f}, cholesky_ex + cholesky_solve {t_chol:.4f}")
    return entries


# ---------------------------------------------------------------------------
# phases 4 and 5: the blind program
# ---------------------------------------------------------------------------
def load_wavs(kind: str, n_utt: int, length: int):
    """The first ``length`` samples of quality_out_heldout/<kind>_utt0..n-1.wav, (n, 1, length)."""
    import numpy as np
    from buddy_tpu_torch.data.audio_io import read_wav
    ys = []
    for i in range(n_utt):
        y, sr = read_wav(os.path.join(REPO, "quality_out_heldout", f"{kind}_utt{i}.wav"))
        if sr != 16000 or len(y) < length:
            raise ValueError(f"{kind}_utt{i}.wav: {len(y)} samples at {sr} Hz")
        ys.append(y[:length])
    return np.stack(ys)[:, None].astype(np.float32)


def write_paired_set(root: str, utterances, seed: int) -> str:
    """A test set in ``VCTKTestPaired``'s layout under ``root``: one clean
    WAV per row of ``utterances`` and one RIR each, exponentially decaying
    Gaussian noise (T60 drawn from 0.4-0.8 s, 16 kHz) behind a unit direct
    path, made with numpy from ``seed``."""
    import numpy as np
    from buddy_tpu_torch.data.audio_io import write_wav
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    for i, clean in enumerate(utterances):
        t60 = rng.uniform(0.4, 0.8)
        t = np.arange(int(t60 * 16000)) / 16000.0
        rir = 0.1 * rng.standard_normal(len(t)) * np.exp(-6.908 * t / t60)
        rir[0] = 1.0
        for sub, data in (("clean", clean), ("rir", rir)):
            os.makedirs(os.path.join(root, sub, "p226"), exist_ok=True)
            write_wav(os.path.join(root, sub, "p226", f"utt{i}.wav"),
                      np.asarray(data, np.float32), 16000)
    return root


def build_tester(dev, tester: str, data_root: str, run_name: str, overrides, seed: int = 0):
    """compose -> network (random weights from ``seed``) -> test set -> Tester,
    as ``python -m buddy_tpu_torch.testing`` builds them."""
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.testing.tester import Tester
    args = compose("conf_VCTK.yaml", [
        f"tester={tester}", "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={data_root}",
        'dset.test.speakers_test=["p226"]', f"model_dir={os.path.join(OUT_DIR, 'smoke_runs')}",
        f"tester.overriden_name={run_name}", "tester.evaluate.use=True", *overrides])
    os.makedirs(args["model_dir"], exist_ok=True)
    shutil.rmtree(os.path.join(args["model_dir"], run_name), ignore_errors=True)
    net = NetworkBundle(instantiate(args["network"], device=dev, seed=seed).requires_grad_(False))
    tester_obj = Tester(args, net, instantiate(args["diff_params"]),
                        instantiate(args["dset"]["test"]), device=dev)
    return args, net, tester_obj


def check_outputs(tester, mode: str, n_items: int, length: int, blind: bool) -> None:
    """The mode's WAV sets: ``n_items`` finite files per directory, the audio
    ones of ``length`` samples; metrics.jsonl with one line per item."""
    import numpy as np
    from buddy_tpu_torch.data.audio_io import read_wav
    base = tester.paths[mode]
    subs = ["original", "degraded", "reconstructed", "true_rir"] + (["estimated_rir"] if blind else [])
    for sub in subs:
        files = sorted(os.listdir(os.path.join(base, sub)))
        if len(files) != n_items:
            raise AssertionError(f"{mode}/{sub}: {len(files)} files, expected {n_items}")
        for f in files:
            wav, sr = read_wav(os.path.join(base, sub, f))
            audio = sub in ("original", "degraded", "reconstructed")
            if sr != 16000 or not np.isfinite(wav).all() or len(wav) == 0 or \
                    (audio and len(wav) != length) or float(np.abs(wav).max()) == 0.0:
                raise AssertionError(f"{mode}/{sub}/{f}: {len(wav)} samples, finite="
                                     f"{bool(np.isfinite(wav).all())}")
    with open(os.path.join(base, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    if len(lines) != n_items or not all(np.isfinite(m["si_sdr"]) for m in lines):
        raise AssertionError(f"{mode}/metrics.jsonl: {len(lines)} lines")


_PORT_KERNELS = (
    "gn_stats_kernel", "gn_apply_kernel", "gn_bwd_stats_kernel", "gn_bwd_apply_kernel",  # K1
    "stft_analysis_kernel", "stft_synthesis_kernel",                                      # K2
    "subband_fft_conv_kernel",                                                            # K3
    "compress_kernel", "compress_bwd_kernel", "comp_loss_fwd_kernel", "comp_loss_bwd_kernel",  # K4
    "minphase_fwd_kernel", "minphase_bwd_kernel",                                         # K5
    "design_fwd_kernel", "design_bwd_point_kernel", "design_bwd_band_kernel",             # K6
    "wpe_solve_kernel")                                                                   # K7


def profile_main_path(run, n_steps: int) -> None:
    """One more main-path run under torch.profiler: device ms per step of
    each of the port's kernels (by exact function name) and of all other
    kernels together, the count of kernel launches, and the device's busy
    share of the wall time.  The full per-kernel table goes to
    chiprun_out/profile_main_path.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    ours = {k: 0.0 for k in _PORT_KERNELS}
    ours_count = 0
    for name, ms, count in rows:
        fn = kernel_name(name)
        if fn in ours:
            ours[fn] += ms
            ours_count += count
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_main_path.txt"), "w") as f:
        for name, ms, count in sorted(rows, key=lambda r: -r[1]):
            f.write(f"{ms:12.3f} ms {count:8d}x  {name}\n")
    per_step = {k: round(v / n_steps, 3) for k, v in ours.items()}
    per_step["other kernels"] = round((busy - sum(ours.values())) / n_steps, 3)
    total = sum(r[2] for r in rows)
    log(f"profile (main path through the tester, {n_steps} steps, profiler on): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%; device kernel and copy launches {total} "
        f"({total / n_steps:.0f} per step; {ours_count} of them the port's kernels); device ms "
        f"per step: " + json.dumps(per_step))


def main_path(dev, wrappers):
    """Phase 4: ``Tester.do_test()`` in blind mode, one batch of 8, full width."""
    import torch
    data = write_paired_set(os.path.join(OUT_DIR, "smoke_data"),
                            load_wavs("clean", 8, 65536)[:, 0], seed=11)
    args, net, tester = build_tester(dev, "blind_dereverberation_BUDDy", data, "blind", [
        f"tester.sampling_params.T={N_STEPS}",
        "network.compute_dtype=bfloat16",
        "tester.posterior_sampling.guidance_jacobian=full",
        "tester.posterior_sampling.blind_hp.op_updates_per_step=10",
        "tester.posterior_sampling.warm_initialization.mode=wpe_scaled",
        "tester.batched.use=True", "tester.batched.batch_size=8"])
    log(f"main path: Tester.do_test(), blind, batched; NCSN++ nf={args['network']['nf']} "
        f"ch_mult={list(args['network']['ch_mult'])} ({net.num_params / 1e6:.2f} M params, bf16 "
        f"body), B=8 x 65536 samples, T={tester.sampler.T} steps, 10 operator updates/step, "
        f"full guidance, WPE warm init")
    sampler_s = []
    inner = tester.sampler.predict_conditional_batched

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        sampler_s.append(time.perf_counter() - t0)
        return out

    tester.sampler.predict_conditional_batched = timed

    def run():
        shutil.rmtree(os.path.join(args["model_dir"], "blind"), ignore_errors=True)
        tester.do_test()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()                                           # cold: Triton/cuDNN first launches
    cold = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    for name in ("stft_analysis", "stft_synthesis"):
        wrappers[name].by_n_fft.clear()
    gn_bwd = wrappers["groupnorm_silu_bwd"]
    gn_bwd.dy_copies = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    check_outputs(tester, "blind_dereverberation", 8, 65536, blind=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    T = tester.sampler.T
    log(f"main path: 5 directories x 8 finite WAVs, metrics.jsonl 8 lines; do_test wall "
        f"{wall:.3f} s (test-set preparation, sampler, WAVs and metrics), of which the sampler "
        f"{sampler_s[-1]:.3f} s for {T} steps incl. WPE warm init ({sampler_s[-1] / T * 1e3:.1f} "
        f"ms/step), cold run {cold:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path launches: " + json.dumps(launches))
    log(f"main path K1 backward calls whose dy came in another layout or dtype (a copy each): "
        f"{gn_bwd.dy_copies} of {launches['groupnorm_silu_bwd']}")
    log(f"main path K2 launches by n_fft (total; per step of {T}, the batch's one-off "
        f"launches included): " + json.dumps({
            name: {n: [c, round(c / T, 2)] for n, c in sorted(wrappers[name].by_n_fft.items())}
            for name in ("stft_analysis", "stft_synthesis")}))
    profile_main_path(run, T)
    return launches, wall


def other_modes(dev) -> None:
    """Phase 5: informed and unconditional at full width, the chunked path
    at a small network, and the CLI as a subprocess."""
    import numpy as np
    import torch
    data = os.path.join(OUT_DIR, "smoke_data")
    wide = ["tester.sampling_params.T=2", "network.compute_dtype=bfloat16"]

    t0 = time.perf_counter()
    _, _, tester = build_tester(dev, "informed_dereverberation_DPS", data, "informed",
                                wide + ["dset.test.num_examples=2"])
    tester.do_test()
    check_outputs(tester, "informed_dereverberation", 2, 65536, blind=False)
    log(f"informed dereverberation (serial, RIR operator, 2 items x 65536, full width, T=2): "
        f"4 directories x 2 finite WAVs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, _, tester = build_tester(dev, "only_unconditional", data, "unconditional",
                                wide + ["tester.unconditional.num_samples=2",
                                        "tester.unconditional.audio_len=65536"])
    preds = tester.do_test()
    files = sorted(f for f in os.listdir(tester.paths["unconditional"]) if f.endswith(".wav"))
    if preds.shape != (2, 65536) or not np.isfinite(preds).all() or len(files) != 2:
        raise AssertionError(f"unconditional: {preds.shape}, files {files}")
    log(f"unconditional (2 samples x 65536, full width, T=2): finite, std "
        f"{float(preds.std()):.4g}, 2 WAVs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    long_utt = load_wavs("clean", 3, 65536)[:, 0].reshape(1, -1)           # 196608 samples
    long_data = write_paired_set(os.path.join(OUT_DIR, "smoke_data_long"), long_utt, seed=12)
    small = ["network.nf=16", "network.ch_mult=[1,2,2,2]", "tester.sampling_params.T=2",
             "tester.posterior_sampling.blind_hp.op_updates_per_step=2"]
    _, _, tester = build_tester(dev, "blind_dereverberation_BUDDy", long_data, "chunked", small + [
        "tester.chunked.threshold=65536", "tester.chunked.chunk_size=65536",
        "tester.chunked.overlap=8192"])
    calls = []
    inner = tester.sampler.predict_conditional
    tester.sampler.predict_conditional = lambda *a, **k: calls.append(k["blind"]) or inner(*a, **k)
    tester.do_test()
    check_outputs(tester, "blind_dereverberation", 1, 196608, blind=True)
    if calls != [True, False, False, False]:
        raise AssertionError(f"chunked path: blind flags {calls}")
    log(f"chunked path (1 item x 196608 samples, 4 chunks of 65536 with 8192 overlap, blind "
        f"on the first chunk only, nf=16): finite WAVs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(OUT_DIR, "smoke_runs", "cli"), ignore_errors=True)
    cmd = [sys.executable, "-m", "buddy_tpu_torch.testing", "--config-name=conf_VCTK.yaml",
           "tester=blind_dereverberation_BUDDy", f"tester.checkpoint={TINY_CKPT}", *TINY_CKPT_NET,
           "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={data}",
           'dset.test.speakers_test=["p226"]', "dset.test.num_examples=2",
           "tester.sampling_params.T=2", "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
           "tester.batched.use=True", "tester.batched.batch_size=2", "tester.overriden_name=cli",
           f"model_dir={os.path.join(OUT_DIR, 'smoke_runs')}", "+gpu=0"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"CLI exited with {run.returncode}:\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-4000:]}")
    if "Test options:" not in run.stdout or "(it=7)" not in run.stdout:
        raise AssertionError(f"CLI output lacks the header or the checkpoint line:\n{run.stdout}")
    # the CLI run keeps the shipped config's default: no metrics file
    base = os.path.join(OUT_DIR, "smoke_runs", "cli", "blind_dereverberation", "VCTK_16k_4s_time")
    for sub in ("original", "degraded", "reconstructed", "true_rir", "estimated_rir"):
        files = os.listdir(os.path.join(base, sub))
        if len(files) != 2:
            raise AssertionError(f"CLI: {sub} holds {files}")
    from buddy_tpu_torch.data.audio_io import read_wav
    rec = read_wav(os.path.join(base, "reconstructed", "utt0.wav"))[0]
    if len(rec) != 65536 or not np.isfinite(rec).all():
        raise AssertionError("CLI: reconstructed/utt0.wav is not 65536 finite samples")
    log(f"CLI (python -m buddy_tpu_torch.testing, blind, batched, 2 items, nf=8 with the "
        f"checkpoint the JAX package wrote): exit 0, 5 WAV sets in {time.perf_counter() - t0:.1f} s")


def build_program(overrides, dev, seed: int = 0):
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    args = compose("conf_VCTK.yaml", ["tester=blind_dereverberation_BUDDy", *overrides])
    net = NetworkBundle(instantiate(args["network"], device=dev, seed=seed))
    sampler = instantiate(args["tester"]["sampler"], net, instantiate(args["diff_params"]),
                          args, device=dev)
    op = BlindSubbandFiltering(args["tester"]["informed_dereverberation"]["op_hp"],
                               sample_rate=16000, device=dev)
    return sampler, op


def small_reference(dev):
    """The blind program at a small size, kernels on the card against plain
    versions on the CPU, same weights (same seed) and noise."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    overrides = ["network.nf=16", "network.ch_mult=[1,2,2,2]", "tester.sampling_params.T=2",
                 "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
                 "tester.posterior_sampling.warm_initialization.mode=reverb_scaled"]
    ys = torch.from_numpy(load_wavs("degraded", 2, 16384))
    outs = []
    for d in (dev, torch.device("cpu")):
        sampler, op = build_program(overrides, d)
        params, H = op.reset_batched(2, noise=torch.randn((2, op.length_rir),
                                                          generator=torch.Generator().manual_seed(4)))
        out = sampler.predict_conditional_batched(ys, op, blind=True, noise=NoiseSource(torch.Generator().manual_seed(5)),
                                                  op_params_batch=params, H_batch=H)
        outs.append(out.detach().cpu())
    # float32 on both sides; the operator's Adam steps (lr * m/sqrt(v))
    # amplify rounding where the second moment is small: 5e-3 of the peak
    err = max_err(outs[0], outs[1])
    tol = 5e-3 * float(outs[1].abs().max())
    check("small blind program, card vs CPU", err, tol)
    log(f"small blind program (B=2, 16384 samples, T=2): card kernels vs CPU plain versions, "
        f"max abs error {err:.3e} (tolerance {tol:.3e})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "buddy_tpu_torch")):
        print("chip_smoke: buddy_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from buddy_tpu_torch.device import resolve_device
    from buddy_tpu_torch.ops import (_build, filter_design as K6, groupnorm as K1, minphase as K5,
                                     spec_loss as K4, stft as K2, subband_conv as K3,
                                     wpe_solve as K7)

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build()
    regs = []
    for name in _build.SOURCES:
        with open(_build.library_path(name)[:-3] + ".log") as f:
            regs += [ln.strip() for ln in f if "registers" in ln]
    log(f"build: nvcc sm_90a {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel); ptxas: {' | '.join(regs)}")

    wrappers = {
        "groupnorm_silu_fwd": K1.group_norm_act, "groupnorm_silu_bwd": K1.group_norm_act_backward,
        "stft_analysis": K2.stft_analysis, "stft_synthesis": K2.stft_synthesis,
        "subband_conv": K3.subband_conv, "subband_conv_adjoint": K3.subband_conv_adjoint,
        "subband_conv_filter_grad": K3.subband_conv_filter_grad,
        "frame_spectrum": K3.frame_spectrum,
        "spec_compress_fwd": K4.spec_compress, "spec_compress_bwd": K4.spec_compress_backward,
        "comp_loss_fwd": K4.comp_loss, "comp_loss_bwd": K4.comp_loss_backward,
        "minphase_fwd": K5.minimum_phase_version, "minphase_bwd": K5.minimum_phase_backward,
        "filter_design_fwd": K6.filter_design, "filter_design_bwd": K6.filter_design_backward,
        "wpe_solve": K7.wpe_solve,
    }
    meta = {
        "groupnorm_silu_fwd": ("cuda", "buddy_tpu_torch/csrc/groupnorm.cu",
                               "scripts/tpu_pallas_gn_probe.py:61"),
        "groupnorm_silu_bwd": ("cuda", "buddy_tpu_torch/csrc/groupnorm.cu",
                               "buddy_tpu/models/layers.py:62"),
        "stft_analysis": ("cuda", "buddy_tpu_torch/csrc/stft.cu", "buddy_tpu/ops/stft.py:154"),
        "stft_synthesis": ("cuda", "buddy_tpu_torch/csrc/stft.cu", "buddy_tpu/ops/stft.py:317"),
        "subband_conv": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                         "buddy_tpu/operators/subband.py:76"),
        "subband_conv_adjoint": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                                 "buddy_tpu/operators/subband.py:76"),
        "subband_conv_filter_grad": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                                     "buddy_tpu/operators/subband.py:76"),
        "frame_spectrum": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                           "buddy_tpu/operators/subband.py:132"),
        "spec_compress_fwd": ("triton", "buddy_tpu_torch/csrc/spec_loss.py",
                              "buddy_tpu/losses.py:51"),
        "spec_compress_bwd": ("triton", "buddy_tpu_torch/csrc/spec_loss.py",
                              "buddy_tpu/losses.py:51"),
        "comp_loss_fwd": ("cuda", "buddy_tpu_torch/csrc/spec_loss.cu",
                          "buddy_tpu/losses.py:120"),
        "comp_loss_bwd": ("cuda", "buddy_tpu_torch/csrc/spec_loss.cu",
                          "buddy_tpu/losses.py:120"),
        "minphase_fwd": ("cuda", "buddy_tpu_torch/csrc/minphase.cu",
                         "buddy_tpu/ops/minphase.py:38"),
        "minphase_bwd": ("cuda", "buddy_tpu_torch/csrc/minphase.cu",
                         "buddy_tpu/ops/minphase.py:38"),
        "filter_design_fwd": ("cuda", "buddy_tpu_torch/csrc/filter_design.cu",
                              "buddy_tpu/operators/subband.py:341"),
        "filter_design_bwd": ("cuda", "buddy_tpu_torch/csrc/filter_design.cu",
                              "buddy_tpu/operators/subband.py:341"),
        "wpe_solve": ("cuda", "buddy_tpu_torch/csrc/wpe_solve.cu",
                      "buddy_tpu/sampling/wpe.py:61"),
    }
    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    checks.update(fused_kernel_checks(dev))
    log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

    launches, _ = main_path(dev, wrappers)
    other_modes(dev)
    small_reference(dev)

    kernels = []
    for name, (route, source, replaces) in meta.items():
        c = checks[name]
        ms, plain_ms, lib_ms = c["times"]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": c["err"], "tolerance": c["tol"],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": c["bound"][0],
                        "bound_by": c["bound"][1], "library_ms": lib_ms, "shape": c["shape"],
                        **c.get("extra", {})})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
