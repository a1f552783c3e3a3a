#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``buddy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card

Phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. building the CUDA kernels (K1, K2, K3, K4's loss pair, K5, K6, K7, K10, K11) from
   ``buddy_tpu_torch/csrc`` with nvcc, one process per source, all at once
   (K4's Triton compression compiles at its first launch, in phase 3), and
   beside them the data pipeline's host library (``csrc/wavio.cpp``,
   ``csrc/loader.cpp``) with the host's C++ compiler, its seconds logged;
3. each kernel at the main path's shapes and dtypes (K1 at the U-Net's four
   GroupNorm shapes, through its autograd wrapper and its C calls; K2 at its four geometries:
   operator, model, WPE and the operator's short `cons` spectra, with its
   synthesis compared bit for bit between two calls; K3's entry points with
   and without the hoisted frame spectrum, against the direct sums and the
   FFT-route plain versions; K4 at the loss's and the RIR regulariser's
   shape and in its three reductions; K5 at the shipped Nf and at Nf = 99,
   one launch a direction with no other kernel inside, its errors beside a
   float64 chain's; K6 and K7 one launch a call, K6 also at Nf = 99, 1039
   and 2500 and at each direction's cap, one above which raises; K7 also
   against the complex128 solve, bit for bit between two calls, and at
   n = 1, 2, 10, 64, 119, 120, 200, 512 and its cap 1024 on its two routes,
   n = 1025 refused), forward and backward,
   against its
   plain PyTorch version on the same inputs, with the stated tolerance, and
   timed beside its plain version and a PyTorch library call where one
   computes the same function (the yardstick; the port never calls it).
   Every timed call comes after an L2 flush (a write of twice the L2, left
   out of the profiler's tables by its kernel's name), so that inputs come
   from device memory as on the main path; K2, K3 and K4 are also timed
   warm (back to back) beside it.  Device us per launch come from the
   profiler.  Then the lengths the packed K2 and the direct K5 do not take
   (K2's chirp route at n_fft 511, 154, 74, 222 and 8191; K5 at Nf = 130,
   250 and 512 and on its chirp route), each one kernel a call with no
   library FFT, a length above each cap refused, and the shipped
   geometries' outputs held bit for bit to commit d09e59e's kernels
   (digests); then the functional ``stft`` / ``istft`` of
   ``buddy_tpu_torch.ops`` at the model geometry (510/128) on (8, 65536)
   float32, center True / False x pad_mode reflect / constant, istft at
   three lengths, against K2's plain versions on the same CUDA tensors
   (2e-5 / 1e-4 of the peak) and torch.stft / torch.istft, K2's launches
   counted and no library FFT inside;
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
   to chiprun_out/); then the WPE warm init alone, its device time split
   into K7, K2 and the matmuls;
5. the tester's other paths: informed dereverberation (serial, time-domain
   RIR operator, 2 items), with full and with identity guidance, and
   unconditional sampling (2 samples of 65536) at full width with T=2; one
   item of 196608 samples through the chunked path at a small network; and
   the CLI, ``python -m buddy_tpu_torch.testing``, as a subprocess with a
   checkpoint that the JAX package wrote;
6. training and checkpointing: the 8 in-repo clean utterances written under
   chiprun_out/train/<speaker>/ and read through ``VCTKTrain`` and
   ``make_train_loader`` with ``exp.num_workers`` and ``exp.seed`` (the
   native loader, asserted); K1 in float32 at every GroupNorm shape of the
   train step (batch 16), forward and backward with d weight and d bias,
   against its plain version, timed beside it and ``F.group_norm``; K2 at
   the model geometry on a (16, 65536) float32 batch, the analysis, the
   synthesis and both backwards against the plain version, bit for bit
   between two calls; the full-width network trained at the shipped exp (batch 16 x 65536,
   float32, Adam, clip, EMA) through ``Trainer.training_loop`` for 5 steps
   with saves at it=2 and 4, K1 (both directions) and K2 launched in every
   step; a new Trainer resumed from the save at it=2 held bit for bit to
   the uninterrupted run (cuDNN deterministic); ms a step (deterministic
   and default cuDNN), peak memory, one profiled step (device time by part,
   launches, idle share from the union of the device's intervals; the
   table to chiprun_out/); ``heavy_logging`` from
   the EMA leaving the trainer's weights as they were; the input pipeline
   at the shipped exp (batch 16 x 65536, ``exp.num_workers`` workers): the
   native loader's batches a second beside the threaded loader's,
   ``Trainer.get_batch``'s host ms a step inside 3 train steps on the native
   loader and on a ``DeviceLoader`` over it, beside those steps' ms, the
   device batches bit for bit with the host batches, every row a cyclic
   window of a training file; the training CLI ``python -m buddy_tpu_torch.training`` at
   nf=8 (on the native loader, by its ``Loader:`` line), then the testing
   CLI on the checkpoint it wrote;
7. the blind program (with full and with identity guidance, its U-Net at
   ``init_scale`` 1 so that its output enters; the two modes must end at
   least 1e-2 of the peak apart) and one train step at a small size on the
   card (kernels) and on the CPU (plain versions) with the same weights and
   noise: the outputs must agree; also the blind program with
   ``fuse_resample`` and static int8 (scales calibrated on the card and
   copied to the CPU network; its 16-64 channels run K10's mma route, whose
   launches in the card's sampler call are counted and must be > 0, the
   sm90 route's 0), then K10 at each distinct conv shape of that run
   through the route ``int8_conv`` picks there: int32 sums, float32 and
   bf16 outputs bit for bit against the plain versions;
8. the serving profile's fused up-convolutions (K8) and the int8 U-Net
   (K10, built with the rest in phase 2): K10 at every convolution shape
   of the full-width int8 U-Net (bf16, B=8; its 3x3 and 1x1 convs, the
   fused four-phase 3x3 and 1x1 of the up-blocks, the ``quantize_bwd``
   adjoints), quantized activations and weights bit for bit against the
   plain versions, and each route of the convolution (``qc_conv_sm90_kernel``,
   TMA + wgmma, which every one of these shapes takes, and ``qc_conv_kernel``,
   mma.sync, forced): int32 sums (against a float64 convolution) and the
   bf16 and float32 outputs dequantized with and without bias and with
   folded per-channel weights, bit for bit, and two calls bit for bit; each timed (device us
   after an L2 flush, the sm90 route also warm; wrapper; plain) beside its
   bound (int8 tensor cores at 1979 TOP/s or bytes at 3.35 TB/s) and, as
   yardsticks, the bf16 cuDNN convolution of the same shape, for the fused
   kinds upsample + bf16 conv, and ``torch._int_mm`` on the same int8
   operands (an im2col matrix at 3x3); K8's float route (one cuDNN
   transposed convolution) against upsample + conv at the up-blocks (run
   after phase 3); then ``Tester.do_test()`` in blind mode at full width,
   T=2, four times: the serving profile (``fuse_resample``), the fast
   serving profile (the same with identity guidance: K1's backward
   launched 0 times, K1's forward and K2-K7 more than 0, by the wrappers'
   counts and the profile's kernel names), int8 static after
   ``NetworkBundle.calibrate_quant`` (bench.py's recipe), int8 dynamic
   with ``quantize_bwd``: sampler ms a step, K10's launches a step (> 0;
   the sm90 route > 0 and the mma route 0, by the wrappers' counts and by
   the profile's kernel names), the fused convs' calls (> 0 in the serving
   runs), five WAV sets, and one profiled run each (device ms and launches
   a step, K10's or the port's kernels' device ms, idle share) (run after
   phase 5);
9. the rest of NCSN++'s configuration space at full width (nf=128,
   ch_mult [1,2,2,2], 65536-sample utterances), after phase 7: (a)
   ``Tester.do_test()`` in blind mode with ``fir`` and both residual
   pyramids, float32 body, B=8, T=2, 10 operator updates a step, WPE warm
   init: five WAV sets, sampler ms, K1's and K11's launches a step (> 0;
   K11's forward and input vjp of the up and the down passes, each launch
   recorded by its geometry), and a profiled run (device ms, launches and
   idle a step, K11's device ms by kernel name, no FIR-shaped library
   convolution); then K11 (FIR resampling, ``csrc/upfirdn.cu``) at the top
   up- and down-block shapes, at every other FIR geometry (a) recorded and
   at generic small cases (up 3 / down 2, a negative pad, asymmetric and
   non-square kernels, C = 1 and 3, ``upfirdn1d``): forward and input vjp
   against the zero-stuffing definition (1e-5 of the peak), two calls bit
   for bit, device us a launch cold and warm, wrapper ms, plain ms, the
   byte bound, and the depthwise library route it replaced as the
   yardstick (the table to chiprun_out/fir_k11.json); (b) the ddpm network
   without pyramids trained at the shipped exp (batch 16 x 65536, float32,
   deterministic cuDNN) for 3 steps with ``remat=false``, then 3 from the
   same weights, batches and draws with ``remat=true``: a finite loss, the
   gradients, parameters, EMA and moments bit for bit after every step, K1
   in every step, ms a step and peak memory of each; (c) both
   configurations at nf=16 card vs CPU: (a)'s network forward and input
   vjp (K11 on the card, launched in both directions, the plain route on
   the CPU), (b)'s one train step (with remat);
10. the device mesh over torch.distributed (``buddy_tpu_torch/parallel``):
   (a) the training CLI under ``python -m torch.distributed.run --standalone
   --nproc_per_node=1`` (NCCL, world 1, ``exp.mesh.dp=-1``) at nf=8 for 2
   steps on the native loader, then the testing CLI under it on its
   checkpoint; (b) two ranks on
   the one card over gloo (CUDA tensors), started by this script
   (``chip_smoke.py --mesh-rank <r>``), training the full-width network in
   float32 at a global batch of 4 x 65536 with deterministic cuDNN: 2 steps
   at dp=2, then 1 at dp=1 x sp=2, each against one process at the same
   global batch and draws (loss and grad norm every step, gradients,
   moments, parameters and EMA after the last), both ranks bit for bit, K1
   and K2 launched in every rank's step, ms a step and the gradient
   all-reduce's ms (two processes share the card: not a two-card figure);
   (c) ``Tester.do_test()`` blind on the two ranks (full width, bf16, batch
   8 split 4 a rank, T=2): the gathered predictions and estimated RIRs bit
   for bit against one process running each rank's 4 utterances with that
   rank's draw rows, rank 0 writing five directories of 8 finite WAVs and
   rank 1 none, 2 unconditional samples at dp=2 row for row, the sampler's
   ms a step per rank; (d) ``log_spectrogram`` through K2 against its plain
   version; (e) in the same world of two, the full-width network in float32
   at exp.mesh.dp=1 x tp=2 (its convolutions column-sharded over the two
   ranks, K1 on each rank's local channels and groups) for 2 steps at a
   global batch of 4 x 65536 against one process (loss and grad norm every
   step; the gradients, moments, parameters and EMA gathered to the first
   rank after the last; the replicated leaves bit for bit between the
   ranks), each rank's parameter + Adam + EMA bytes and peak memory beside
   one process's, the tp collectives' bytes and ms a step, and the
   checkpoint written at tp=2 resumed at tp=1 bit for bit; (f) a world of
   four ranks at dp=2 x tp=2, nf=16, with ``remat``, one step against one
   process (the recomputation's all-gathers counted); (g) K1 at each local
   shape (e) runs (C/2 channels in G/2 groups, float32, forward and
   backward) against its plain version, device us a launch beside the
   whole-width launch.  Then the total seconds (and, after phase 7, those
   of the fast serving profile's and the functional STFT's parts).

A JSON line of the kernels' results precedes the last line (K1's float32
rows from phase 6, their launches those of its training loop; K2's check
at the training shapes under its rows' ``training_shape``; K11's four rows
at phase 9's top blocks, their launches those of run (a)), which is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero without that line.  It imports nothing of JAX.
"""

import concurrent.futures
import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
PEAK_F64_FLOPS = 67e12          # H100 SXM float64 through the tensor cores (DMMA; 34e12 outside)
N_STEPS = 4                     # diffusion steps of the main-path run (T=201 in the tester)
OUT_DIR = os.path.join(REPO, "chiprun_out")
TINY_CKPT = os.path.join(REPO, "tests", "goldens", "torch_tiny.ckpt.npz")
TINY_CKPT_NET = ["network.nf=8", "network.ch_mult=[1,2,2,2]", "network.num_res_blocks=1"]
# the U-Net's four GroupNorm shapes (B, C, H, W) at full width, bf16
GN_SHAPES = [(8, 128, 256, 528), (8, 256, 128, 264), (8, 256, 64, 132), (8, 256, 32, 66)]
# K3 on the main path: utterances, bins, frames of the operator geometry, taps, pre
K3_SHAPE = (8, 513, 517, 100, 1)


LOG_PATH = os.path.join(OUT_DIR, "chip_smoke.log")


def log(msg: str) -> None:
    """Print a line, and keep it in chiprun_out/chip_smoke.log (the whole
    run's lines, for a reader who has only the end of the output)."""
    print(msg, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(msg + "\n")


PROFILE_PAD_S = 0.02            # the host's idle time at each end of a profiler window
PROFILE_TRIES = 4               # windows a measurement may take
_PROFILE = {"windows": 0, "retaken": 0, "events": 0, "t0": time.perf_counter()}


@contextlib.contextmanager
def device_profile(cpu: bool = False, **kwargs):
    """torch.profiler over the body (the device's activity, and the host's
    too when ``cpu``), with the host idle at each end of the window.  The
    profiler keeps only the device activity whose timestamps fall inside
    its window, and on the H100 machines a kernel's timestamp now and then
    lies milliseconds before its launch on the host's clock
    (profiler_clock_probe.py): without the margin, a window of a few short
    calls can come back with none of their kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    _PROFILE["windows"] += 1
    with profile(activities=activities, **kwargs) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


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
    if "keys" not in _FLUSH:
        l2_flush()
        torch.cuda.synchronize()
        with device_profile() as prof:
            l2_flush()
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


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time for the work: the bytes at the memory's rate or the
    operations at the peak of their type (float32 unless ``peak_flops`` says
    otherwise), whichever is longer, in ms, and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _try(fn):
    """fn()'s result, or the exception it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 -- returned to the caller, which checks its type
        return e


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


def _retake(why: str) -> None:
    """Count a profiler window that is taken again, and log why."""
    _PROFILE["retaken"] += 1
    log(f"profiler window taken again, {time.perf_counter() - _PROFILE['t0']:.0f} s into the "
        f"run: {why}"[:400])


def profile_device_us(fn, reps: int = 20, cold: bool = True) -> dict:
    """{kernel name: [device us, launches]} over ``reps`` calls of fn()
    under torch.profiler (after one call outside it), each call after an L2
    flush when ``cold``; the flush's kernel is left out.  A window that
    records no device activity is taken again, up to PROFILE_TRIES windows."""
    import torch
    skip = flush_keys() if cold else set()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with device_profile() as prof:
            for _ in range(reps):
                if cold:
                    l2_flush()
                fn()
        found = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0 and e.key not in skip:
                f = found.setdefault(kernel_name(e.key), [0.0, 0])
                f[0] += e.self_device_time_total
                f[1] += e.count
        if found:
            return found
        _retake(f"no device activity in {reps} calls")
    return found


def device_us_per_launch(fn, names, reps: int = 20, cold: bool = True) -> dict:
    """Device us per launch of each kernel in ``names`` over ``reps`` calls of
    fn().  A profile that records no launch of a kernel is taken again, up
    to PROFILE_TRIES windows: the profiler now and then drops part of a
    window's activity."""
    for _ in range(PROFILE_TRIES):
        found = profile_device_us(fn, reps, cold)
        missing = [k for k in names if k not in found]
        if not missing:
            return {k: found[k][0] / found[k][1] for k in names}
        _retake(f"no launch of {missing} in {reps} calls; found "
                f"{ {k: v[1] for k, v in found.items()} }")
    raise AssertionError(f"profile shows no launch of {missing} in {PROFILE_TRIES} windows")


def profile_whole_calls(fn, reps: int = 20, cold: bool = True) -> dict:
    """profile_device_us(fn, reps, cold) from a window whose launches are a
    whole number of calls' (a call launches the same kernels each time),
    taken again up to PROFILE_TRIES windows; {} if none is.  At some shapes
    the profiler loses a call's launches from every window (K1's float32
    training shapes: 19 of 20 calls in each, NVIDIA H100 80GB HBM3)."""
    for _ in range(PROFILE_TRIES):
        found = profile_device_us(fn, reps, cold)
        n = sum(c for _, c in found.values())
        if n >= reps and n % reps == 0:
            return found
        _retake(f"{n} launches in {reps} calls: {found}")
    return {}


def device_us_per_call(fn, reps: int = 20, cold: bool = True) -> float:
    """Device us of all the kernels of one call of fn(), from a profile of
    whole calls (``profile_whole_calls``); without one, the call is timed
    with CUDA events instead (``cuda_ms``, the same calls, each after an L2
    flush when ``cold``: the span from its first kernel's start to its last
    one's end), and the log says so."""
    return call_us(profile_whole_calls(fn, reps, cold), fn, reps, cold)


def call_us(found: dict, fn, reps: int = 20, cold: bool = True) -> float:
    """Device us a call from ``profile_whole_calls``' table of ``reps`` calls
    of fn(), or, where it is empty, from CUDA events (logged)."""
    if found:
        return sum(t for t, _ in found.values()) / reps
    _PROFILE["events"] += 1
    us = 1e3 * cuda_ms(fn, reps=reps, cold=cold)
    log(f"profiler: no window of whole calls in {PROFILE_TRIES}; CUDA events instead: {us:.1f} us "
        f"a call")
    return us


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
    from buddy_tpu_torch.ops import groupnorm as K1, subband_conv as K3
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
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
            fwd = lambda: K1._launch_forward(x, w, b, G, 1e-6, True)
            bwd = lambda: K1.group_norm_act_backward(x, dy, w, b, mr, True, False)
            per_f, per_b = profile_whole_calls(fwd, reps), profile_whole_calls(bwd, reps)
            us_f, us_b = call_us(per_f, fwd, reps), call_us(per_b, bwd, reps)
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
    # (L = 128 x 101) and at Nf = 99 (L = 12800 = 128 x 100, another plan);
    # the lengths the direct plans alone cannot take are in new_lengths()
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
                k5_us[what] = (one_launch(call, kname, f"minimum_phase {what}"),
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
    log(f"kernel K5 minimum phase (one cluster launch a direction, FFTs inside): fwd/bwd match "
        f"the plain version at h [8, L], bit-identical between two calls, one launch a call and "
        f"no other kernel; errors, tolerances and both sides against float64: "
        + json.dumps(k5_log) + "; device us per launch cold / warm: " + json.dumps(k5_us))

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
    if not torch.equal(Hk, K6.filter_design(decay, weights, phases, geom)):
        raise AssertionError("filter_design fwd differs between two runs")
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
    # one launch a call each way and no other kernel; device us cold (after
    # an L2 flush) and warm (back to back), and the wrapper's CUDA-event ms
    k6_calls = {"design_fwd_kernel": lambda: K6.filter_design(decay, weights, phases, geom),
                "design_bwd_kernel": lambda: K6.filter_design_backward(decay, weights, phases, gH,
                                                                       geom)}
    k6_us = {}
    with torch.no_grad():
        for kname, call in k6_calls.items():
            k6_us[kname] = (one_launch(call, kname, f"filter_design {kname}"),
                            device_us_per_launch(call, [kname], cold=False)[kname],
                            cuda_ms(call, cold=False))
        t_f = (cuda_ms(k6_calls["design_fwd_kernel"]),
               cuda_ms(lambda: K6.filter_design_plain(decay, weights, phases, geom)), None)
    t_b = (cuda_ms(k6_calls["design_bwd_kernel"]),
           cuda_ms(lambda: torch.autograd.grad(Hp_graph, leaves, gH, retain_graph=True)), None)
    n = phases.numel()
    small = 4 * (2 * decay.numel() + geom.dpc.numel())
    extra = lambda k: {"kernel": k, "device_us": k6_us[k][0], "device_us_warm": k6_us[k][1],
                       "ms_warm": k6_us[k][2]}
    entries["filter_design_fwd"] = dict(err=e_df, tol=t_df, times=t_f, shape=list(phases.shape),
                                        bound=bound_ms(12 * n + small, 120.0 * n),
                                        extra=extra("design_fwd_kernel"))
    entries["filter_design_bwd"] = dict(err=e_db, tol=1e-3, times=t_b, shape=list(phases.shape),
                                        bound=bound_ms(16 * n + small, 160.0 * n),
                                        extra=extra("design_bwd_kernel"))
    # and at other operator shapes, same tolerances: Nf = 99 (F Nf odd: no 16-byte path) and
    # B = 3 (another row schedule); Nf = 1039 at hop 64, the longest RIR K5 runs there, at one
    # wave; then, on the operator's breakpoints with OLA factors of one and no direct-path
    # correction, Nf = 2500 (the backward's R halved) and each direction at its cap (the
    # largest Nf its row schedule fits, one or two rows a CTA), and one above it, which raises
    def k6_case(what, geom_, leaves_, bwd=True):
        Hk_, Hp_ = K6.filter_design(*leaves_, geom_), K6.filter_design_plain(*leaves_, geom_)
        check(f"filter_design fwd {what}", max_err(torch.view_as_real(Hk_),
                                                   torch.view_as_real(Hp_)),
              1e-4 * float(Hp_.abs().max()))
        del Hk_, Hp_
        if not bwd:
            return
        gk = crand(*leaves_[2].shape)
        lv = [t.detach().requires_grad_(True) for t in leaves_]
        auto_ = torch.autograd.grad(K6.filter_design_plain(*lv, geom_), lv, gk)
        kern_ = K6.filter_design_backward(*leaves_, gk, geom_)
        for name, a_, b_ in zip(("ddecay", "dweights", "dphases"), kern_, auto_):
            check(f"filter_design bwd {name} {what}", rel(a_, b_), 1e-3)
        if not all(torch.equal(u, v) for u, v in zip(
                kern_, K6.filter_design_backward(*leaves_, gk, geom_))):
            raise AssertionError(f"filter_design bwd {what} differs between two runs")

    k6_shapes = []
    for Nf_, hop_, B_ in ((99, 128, 3), (1039, 64, 8)):
        args_ = compose("conf_VCTK.yaml", ["tester=blind_dereverberation_BUDDy",
                                           f"tester.informed_dereverberation.op_hp.Nf={Nf_}",
                                           f"tester.informed_dereverberation.op_hp.hop={hop_}"])
        op_ = BlindSubbandFiltering(args_["tester"]["informed_dereverberation"]["op_hp"],
                                    sample_rate=16000, device=dev)
        p_, _ = op_.reset_batched(B_, generator=torch.Generator(device=dev).manual_seed(3))
        geom_ = op_._design_geometry
        k6_case(f"Nf={Nf_} hop={hop_} B={B_}", geom_, [p_["decay"], p_["weights"], p_["phases"]])
        k6_shapes.append([B_, geom.dpc.shape[0], Nf_, list(geom_.schedules.values())])

    def bare(Nf_):
        """The operator's breakpoints at Nf_ columns, with its decays and weights."""
        gm = K6.FilterDesignGeometry(op.freqs, op.EQ_freqs, np.ones(Nf_, np.float32),
                                     np.zeros((geom.dpc.shape[0], Nf_), np.float32),
                                     geom.fix_extremes, dev)
        return gm, [decay, weights, 2 * np.pi * torch.rand((B, geom.dpc.shape[0], Nf_),
                                                           generator=g, device=dev) - np.pi]

    gm, lv_ = bare(2500)
    k6_case(f"Nf=2500 B={B}", gm, lv_)
    k6_shapes.append([B, geom.dpc.shape[0], 2500, list(gm.schedules.values())])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    caps = {}
    for bwd in (False, True):
        fits = lambda n: not isinstance(_try(lambda: K6.schedule(geom.j_host, n, 1, decay.shape[2],
                                                                  B, sms, bwd)), ValueError)
        lo, hi = 1, 1 << 16
        while hi - lo > 1:
            lo, hi = ((lo + hi) // 2, hi) if fits((lo + hi) // 2) else (lo, (lo + hi) // 2)
        caps["bwd" if bwd else "fwd"] = lo
        for Nf_ in (lo, lo + 1):
            gm, lv_ = bare(Nf_)
            if Nf_ == lo:
                k6_case(f"Nf={Nf_} B={B} (the {'backward' if bwd else 'forward'}'s cap)", gm, lv_,
                        bwd)
                continue
            call = K6.filter_design_backward if bwd else K6.filter_design
            extra_arg = [crand(*lv_[2].shape)] if bwd else []
            err_ = _try(lambda: call(*lv_, *extra_arg, gm))
            if not (isinstance(err_, ValueError) and "above the cap" in str(err_)):
                raise AssertionError(f"filter_design {'bwd' if bwd else 'fwd'} Nf={Nf_}: above "
                                     f"the cap but gave {type(err_).__name__}")
        del gm, lv_
    log(f"kernel K6 filter design: fwd/bwd match the plain version at params "
        f"{list(decay.shape)}, phases {list(phases.shape)} and at [B, F, Nf, [[R, nb, qmax] "
        f"fwd, bwd]] {k6_shapes}, and at the caps Nf = {caps}, above which each raises; "
        f"bit-identical between two runs, one "
        f"launch a call each way; device us cold / warm and warm ms a call: " + json.dumps(k6_us)
        + f"; ms cold kernel/plain: fwd {t_f[0]:.4f}/{t_f[1]:.4f}, bwd {t_b[0]:.4f}/{t_b[1]:.4f}")

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
    c0 = K7.wpe_solve.launches
    Gk, Gk2, Gp = K7.wpe_solve(R, P), K7.wpe_solve(R, P), K7.wpe_solve_plain(R, P)
    if K7.wpe_solve.launches - c0 != 2 or not torch.equal(Gk, Gk2):
        raise AssertionError(f"wpe_solve: {K7.wpe_solve.launches - c0} launches for two calls, "
                             f"bit-identical {torch.equal(Gk, Gk2)}")
    r_k, r_p = resid(Gk), resid(Gp)
    if not (r_k <= max(r_p, 1e-6)):
        raise AssertionError(f"wpe_solve: residual {r_k:.3e} above the plain version's {r_p:.3e}")

    def solve128(Rm, Pm, diag_rel=1e-6, eps=1e-10):
        """torch.linalg.solve in complex128 of the same loaded system (the trace
        summed in float64, as the kernel sums it)."""
        n = Rm.shape[-1]
        ld = diag_rel * torch.diagonal(Rm, dim1=-2, dim2=-1).real.double().sum(-1) / n + eps
        M = Rm.to(torch.complex128) + ld[..., None, None] * torch.eye(n, device=Rm.device)
        return torch.linalg.solve(M, Pm.to(torch.complex128))

    rel128 = lambda G, G128: float((G.to(torch.complex128) - G128).abs().max() / G128.abs().max())
    e128 = rel128(Gk, solve128(R, P))
    check("wpe_solve: max|G - G128| / max|G128| against the complex128 solve", e128, 1e-5)

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
        k7_us = (one_launch(lambda: K7.wpe_solve(R, P), "wpe_solve_kernel", "wpe_solve"),
                 device_us_per_launch(lambda: K7.wpe_solve(R, P), ["wpe_solve_kernel"],
                                      cold=False)["wpe_solve_kernel"])
    nsys = P.numel() // taps

    # every other tap count the JAX package takes, on both routes, against the complex128
    # solve (1e-5 of the peak, as at n = 50), one launch a call and bit-identical between
    # two; a few systems each (WPE correlations of a seeded spectrum, 4 n + 16 frames so
    # that R has full rank); one above the cap raises
    g = torch.Generator(device=dev).manual_seed(7)

    def wpe_systems(nsys_, n):
        T = 4 * n + 16
        Ys = torch.complex(torch.randn(nsys_, T, generator=g, device=dev),
                           torch.randn(nsys_, T, generator=g, device=dev))
        Ys = Ys * torch.exp(-torch.arange(T, device=dev) / (T / 4))
        Yts = wpe._build_y_tilde(Ys, n, delay)
        Yns = Yts / torch.clamp(torch.abs(Ys) ** 2, min=1e-10)[..., None, :]
        return ((Yns @ Yts.conj().transpose(-1, -2)).contiguous(),
                (Yns @ Ys.conj()[..., None])[..., 0].contiguous())

    other_n = {}
    for n in (1, 2, 10, 64, 119, 120, 200, 512, K7.MAX_N):
        Rn, Pn = wpe_systems(4, n)
        c0 = K7.wpe_solve.launches
        Gn, Gn2 = K7.wpe_solve(Rn, Pn), K7.wpe_solve(Rn, Pn)
        route = K7.solve_route(n, 4).route
        if K7.wpe_solve.launches - c0 != 2 or not torch.equal(Gn, Gn2):
            raise AssertionError(f"wpe_solve n={n} ({route}): {K7.wpe_solve.launches - c0} "
                                 f"launches for two calls, bit-identical {torch.equal(Gn, Gn2)}")
        other_n[n] = {"route": route, "err": rel128(Gn, solve128(Rn, Pn))}
        check(f"wpe_solve n={n} ({route}) against the complex128 solve", other_n[n]["err"], 1e-5)
    refused = _try(lambda: K7.wpe_solve(*wpe_systems(1, K7.MAX_N + 1)))
    if not isinstance(refused, ValueError) or f"MAX_N = {K7.MAX_N}" not in str(refused):
        raise AssertionError(f"wpe_solve n={K7.MAX_N + 1}: {refused!r}, not the cap's ValueError")
    large = {}
    with torch.no_grad():
        for n in (200, 512):
            Rn, Pn = wpe_systems(8, n)
            large[n] = {"systems": 8, "device_us": one_launch(
                lambda: K7.wpe_solve(Rn, Pn), "wpe_solve_large_kernel", f"wpe_solve n={n}")}
    # library_ms is the faster of the two library routes; both stand beside it by name.  The
    # bound counts the LU's 8 n^3 / 3 operations a complex system in float64, the kernel's
    # arithmetic, against the card's float64 peak (the tensor cores'), and the bytes
    entries["wpe_solve"] = dict(err=d_k, tol=d_p, shape=[nsys, taps, taps],
                                times=(t_solve[0], t_solve[1], min(t_solve[2], t_chol)),
                                bound=bound_ms(8 * (R.numel() + 2 * P.numel()),
                                               nsys * 8.0 * taps ** 3 / 3, PEAK_F64_FLOPS),
                                extra={"library_linalg_solve_ms": t_solve[2],
                                       "library_cholesky_ms": t_chol, "device_us": k7_us[0],
                                       "device_us_warm": k7_us[1], "err_vs_complex128": e128,
                                       "other_n": other_n, "large_route": large})
    log(f"kernel K7 WPE solve (LU with partial pivoting in float64): {nsys} systems of "
        f"{taps}x{taps}; residual |(R+load I)G-P|/|P| kernel {r_k:.3e}, plain complex64 "
        f"{r_p:.3e}; max|G-G128|/max|G128| {e128:.3e} (tolerance 1e-5), bit-identical between "
        f"two calls, one launch a call; dereverberated waveform after one iteration against "
        f"the complex128 solve, max abs / peak: kernel {d_k / peak:.3e}, plain {d_p / peak:.3e}; "
        f"after five iterations against WPE in complex128 throughout: kernel {d5_k:.3e}, "
        f"plain {d5_p:.3e}; ms kernel {t_solve[0]:.4f}, "
        f"torch.linalg.solve {t_solve[2]:.4f}, cholesky_ex + cholesky_solve {t_chol:.4f}; device "
        f"us a launch cold {k7_us[0]:.1f}, warm {k7_us[1]:.1f}; bound ms "
        f"{entries['wpe_solve']['bound'][0]:.4f} ({entries['wpe_solve']['bound'][1]}, float64); "
        f"other n against complex128, one launch a call, bit-identical: " + json.dumps(other_n)
        + f"; n = {K7.MAX_N + 1} refused; the large route, device us a launch cold: "
        + json.dumps(large))
    return entries



# ---------------------------------------------------------------------------
# phase 3 (continued): lengths the packed K2 and the direct K5 do not take,
# and the shipped geometries' bits
# ---------------------------------------------------------------------------
# K2's chirp route: n_fft -> hop.  511 (odd) and 154 (= 2 7 11, two primes
# above 5), 74 and 222 (a prime above 31), and 8191, the longest odd n
K2_CHIRP = {511: 128, 154: 128, 74: 16, 222: 64, 8191: 2048}
# K5 rows: Nf = 130, 250 and 512 at hop 128 (direct DFTs of 131, 251 and 513
# points), and the chirp route: a prime (101), 2 x 257, 2 x 7 x 11 x 13, and
# the prime 65521 near the cap
K5_LENGTHS = (128 * 131, 128 * 251, 128 * 513, 101, 2 * 257, 2 * 7 * 11 * 13, 65521)
# sha256 (first 16 hex digits) of the shipped geometries' outputs on the
# inputs of shipped_digests(), from commit d09e59e's kernels (printed by
# ``chip_compare.py`` for a checkout of that commit, NVIDIA H100 80GB HBM3):
# the main path's bits must not move
PARENT_DIGESTS = {
    "stft_analysis operator": "31a15854817c006c", "stft_synthesis operator": "7b30b785c4ba9f1f",
    "stft_analysis model": "bcef482e4fbaf620", "stft_synthesis model": "bfee69b15bd2993e",
    "stft_analysis wpe": "2625e31384dbeabd", "stft_synthesis wpe": "e8d4f318b2369823",
    "stft_analysis cons": "f3f62e4a281e4b17", "stft_synthesis cons": "18ef8308d528f42d",
    "minphase_fwd Nf=100": "cf1a89e4560ef893", "minphase_bwd Nf=100": "396d61882134cd77"}


def one_launch(call, kname: str, what: str) -> float:
    """Profiles 20 calls (cold) and requires exactly one launch of ``kname``
    a call and no other kernel (no library FFT); returns its device us.  A
    window that records fewer launches than calls is taken again, up to
    PROFILE_TRIES windows (the profiler now and then drops part of a
    window's activity)."""
    for _ in range(PROFILE_TRIES):
        found = profile_device_us(call)
        if set(found) - {kname} or found.get(kname, [0, 0])[1] > 20:
            break
        if found.get(kname, [0, 0])[1] == 20:
            return found[kname][0] / 20
        _retake(f"{what}: {found.get(kname, [0, 0])[1]} launches of {kname} in 20 calls")
    raise AssertionError(f"{what}: one call runs {found}, not one {kname}")


def new_lengths(dev) -> dict:
    """K2 at the chirp route's lengths and K5 at rows beyond the old 128 x 128 plans,
    against their plain versions (torch.fft) on the card: 1e-4 of the
    peak forward (K2 both ways, K5's forward), 5e-4 of the peak for K5's
    backward (as at Nf = 100); bit-identical between two calls; one kernel
    a call and no other; a length above each cap raises ValueError."""
    import numpy as np
    import torch
    from buddy_tpu_torch.ops import minphase as K5
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.ops.fft_plan import MINPHASE_MAX_L, MinPhasePlan
    from buddy_tpu_torch.ops.stft import MAX_N_FFT, STFT, hann_window
    rng = np.random.default_rng(21)
    on = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    k2, k5 = {}, {}
    for n_fft, hop in K2_CHIRP.items():
        geom = STFT(n_fft, hop, hann_window(n_fft), pad_mode="constant", device=dev)
        plan = geom.plan
        if plan.route != K2.CHIRP:
            raise AssertionError(f"stft n_fft={n_fft}: route {plan.route}, not the chirp route")
        blocks, T = geom.frame_blocks(on(rng.standard_normal((8, 16384))))
        spec_k = K2.stft_analysis(blocks, plan, T)
        spec_p = K2.analysis_plain(blocks, plan, T, plan.ones).contiguous()
        err_a = max_err(torch.view_as_real(spec_k), torch.view_as_real(spec_p))
        check(f"stft_analysis chirp n_fft={n_fft}", err_a, 1e-4 * float(spec_p.abs().max()))
        y_k = K2.stft_synthesis(spec_p, plan)
        y_p = K2.synthesis_plain(spec_p, plan, plan.istft_weights)
        err_s = max_err(y_k, y_p)
        check(f"stft_synthesis chirp n_fft={n_fft}", err_s, 1e-4 * float(y_p.abs().max()))
        if not (torch.equal(spec_k, K2.stft_analysis(blocks, plan, T))
                and torch.equal(y_k, K2.stft_synthesis(spec_p, plan))):
            raise AssertionError(f"stft chirp n_fft={n_fft}: two calls differ")
        g = torch.complex(on(rng.standard_normal(spec_p.shape)), on(rng.standard_normal(spec_p.shape)))
        bk, bp = blocks.detach().requires_grad_(True), blocks.detach().requires_grad_(True)
        K2.stft_analysis(bk, plan, T).backward(g)
        K2.analysis_plain(bp, plan, T, plan.ones).backward(g)
        err_ab = max_err(bk.grad, bp.grad)
        check(f"stft_analysis bwd chirp n_fft={n_fft}", err_ab, 1e-4 * float(bp.grad.abs().max()))
        with torch.no_grad():
            us = (one_launch(lambda: K2.stft_analysis(blocks, plan, T),
                             "stft_chirp_analysis_kernel", f"stft_analysis n_fft={n_fft}"),
                  one_launch(lambda: K2.stft_synthesis(spec_p, plan),
                             "stft_chirp_synthesis_kernel", f"stft_synthesis n_fft={n_fft}"))
        # the bound as at the shipped geometries: the signal read and the
        # spectrum written once, a real FFT's 2.5 n log2 n operations a frame
        fft_flops = 2.5 * n_fft * np.log2(n_fft) * blocks.shape[0]
        bounds = (bound_ms(4 * blocks.numel() + 8 * spec_k.numel(), fft_flops * T),
                  bound_ms(8 * spec_p.numel() + 4 * y_p.numel(), fft_flops * spec_p.shape[-1]))
        k2[n_fft] = {"hop": hop, "M": plan.M, "frames": T, "err": [err_a, err_s, err_ab],
                     "device_us_cold": [round(u, 1) for u in us],
                     "bound_us": [round(b[0] * 1e3, 3) for b in bounds],
                     "bound_by": [b[1] for b in bounds]}
    try:
        STFT(MAX_N_FFT + 1, 2048, hann_window(MAX_N_FFT + 1), device=dev)
    except ValueError as e:
        k2_cap = str(e)
    else:
        raise AssertionError(f"STFT: n_fft={MAX_N_FFT + 1} is above the cap but planned")
    log(f"kernel K2 chirp route (a Bluestein step in shared memory) at n_fft -> hop "
        f"{K2_CHIRP}: analysis, synthesis and the analysis's backward match the plain version "
        f"(1e-4 of the peak), bit-identical between two calls, one kernel a call and no library "
        f"FFT; n_fft={MAX_N_FFT + 1} refused ({k2_cap}): " + json.dumps(k2))

    for L in K5_LENGTHS:
        plan = MinPhasePlan(L, dev)
        h = on(np.exp(-np.arange(L) / (L / 6.0)) * rng.standard_normal((8, L)))
        h[:, 0] = 2.0
        gy = on(rng.standard_normal((8, L)))
        yk, Hs, phs = K5._launch_forward(h)
        yp = K5.minimum_phase_plain(h)
        e_f, t_f = max_err(yk, yp), 1e-4 * float(yp.abs().max())
        check(f"minimum_phase fwd L={L}", e_f, t_f)
        dk = K5.minimum_phase_backward(Hs, phs, gy)
        dp = K5.minimum_phase_backward_plain(h, gy)
        e_b, t_b = max_err(dk, dp), 5e-4 * float(dp.abs().max())
        check(f"minimum_phase bwd L={L}", e_b, t_b)
        if not (torch.equal(yk, K5._launch_forward(h)[0])
                and torch.equal(dk, K5.minimum_phase_backward(Hs, phs, gy))):
            raise AssertionError(f"minimum_phase L={L}: two calls differ")
        with torch.no_grad():
            us = (one_launch(lambda: K5._launch_forward(h), "minphase_fwd_kernel",
                             f"minimum_phase fwd L={L}"),
                  one_launch(lambda: K5.minimum_phase_backward(Hs, phs, gy), "minphase_bwd_kernel",
                             f"minimum_phase bwd L={L}"))
        # the bound as at the shipped Nf: four real FFTs of 2 L points and ~60
        # operations a point, against h read and y written (backward: h and g
        # read, dh written)
        n = 2 * L
        ops = 8 * (4 * 2.5 * n * np.log2(n) + 60.0 * n)
        bounds = (bound_ms(8 * 8 * L, ops), bound_ms(12 * 8 * L, ops))
        k5[L] = {"route": ["direct", "chirp"][plan.route], "N1 x N2": [plan.N1, plan.N2],
                 "err": [e_f, e_b], "tol": [t_f, t_b], "device_us_cold": [round(u, 1) for u in us],
                 "bound_us": [round(b[0] * 1e3, 3) for b in bounds],
                 "bound_by": [b[1] for b in bounds]}
    try:
        K5._launch_forward(on(np.ones((1, MINPHASE_MAX_L + 1))))
    except ValueError as e:
        k5_cap = str(e)
    else:
        raise AssertionError(f"minimum_phase: L={MINPHASE_MAX_L + 1} is above the cap but ran")
    log(f"kernel K5 at rows beyond the old 128 x 128 plans (Nf = 130, 250, 512 at hop 128; the "
        f"chirp route): "
        f"fwd/bwd match the plain version (1e-4 / 5e-4 of the peak), bit-identical between two "
        f"calls, one kernel a call; L={MINPHASE_MAX_L + 1} refused ({k5_cap}): " + json.dumps(k5))
    return {"stft": k2, "minphase": k5}


def shipped_digests(dev) -> dict:
    """sha256 (16 hex digits) of K2's outputs at the four shipped geometries
    and of K5's at Nf = 100, forward and backward, on inputs made with numpy
    from a seed: a record of the main path's bits that another tree's
    kernels can be held to."""
    import hashlib
    import numpy as np
    import torch
    from buddy_tpu_torch.ops import minphase as K5
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    rng = np.random.default_rng(31)
    on = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    digest = lambda t: hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    op_window = np.pad(hann_window(512), (0, 512))
    out = {}
    with torch.no_grad():
        for gname, (n_fft, window, mode, length) in {
                "operator": (1024, op_window, "constant", 65536 + 512),
                "model": (510, hann_window(510), "reflect", 65536),
                "wpe": (512, hann_window(512), "constant", 65536),
                "cons": (1024, op_window, "constant", 12928)}.items():
            geom = STFT(n_fft, 128, window, pad_mode=mode, device=dev)
            blocks, T = geom.frame_blocks(on(rng.standard_normal((8, length))))
            spec = K2.stft_analysis(blocks, geom.plan, T)
            out[f"stft_analysis {gname}"] = digest(torch.view_as_real(spec))
            out[f"stft_synthesis {gname}"] = digest(K2.stft_synthesis(spec.contiguous(), geom.plan))
        L = 128 * 101
        h = on(np.exp(-np.arange(L) / 2000.0) * rng.standard_normal((8, L)))
        h[:, 0] = 2.0
        y, Hs, phs = K5._launch_forward(h)
        out["minphase_fwd Nf=100"] = digest(torch.cat([y.flatten(), torch.view_as_real(Hs).flatten(),
                                                       phs.flatten()]))
        out["minphase_bwd Nf=100"] = digest(K5.minimum_phase_backward(
            Hs, phs, on(rng.standard_normal((8, L)))))
    return out


def check_digests(dev) -> None:
    """The shipped geometries' outputs against PARENT_DIGESTS, bit for bit."""
    ours = shipped_digests(dev)
    differ = {k: (v, PARENT_DIGESTS.get(k)) for k, v in ours.items() if PARENT_DIGESTS.get(k) != v}
    if differ:
        raise AssertionError(f"shipped geometries: outputs differ from commit d09e59e's kernels: {differ}")
    log(f"K2 at the operator, model, WPE and cons geometries and K5 at Nf = 100, fwd and bwd: "
        f"bit-identical to commit d09e59e's kernels on the same inputs ({len(ours)} digests)")


# the functional stft / istft: (center, pad_mode) at the model geometry
FUNCTIONAL_STFT = ((True, "reflect"), (True, "constant"), (False, "reflect"), (False, "constant"))


@contextlib.contextmanager
def k2_plain():
    """K2's dispatch on its plain versions whatever the tensors' device: the
    functional forms' reference on the same CUDA tensors."""
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    saved = K2._analysis, K2._synthesis
    K2._analysis = K2.analysis_plain
    K2._synthesis = lambda spec, plan, bin_w: K2.synthesis_plain(spec, plan, bin_w).reshape(
        spec.shape[0], -1, plan.hop)
    try:
        yield
    finally:
        K2._analysis, K2._synthesis = saved


def functional_stft_checks(dev) -> dict:
    """The functional ``stft`` / ``istft`` (``buddy_tpu_torch.ops``) at the
    model geometry (510/128, Hann) on (8, 65536) float32, for center True /
    False x pad_mode reflect / constant, istft at three lengths (None,
    4096 shorter, 4096 longer): against K2's plain versions on the same
    CUDA tensors (2e-5 of the peak forward, 1e-4 inverse) and against
    torch.stft / torch.istft (the yardstick; the port never calls them),
    which refuses a Hann window without centring (its envelope is 0 at
    sample 0): there the inverse is also held to it with a Hamming window.
    The kernels' launches are counted (> 0 each), one stft + istft pair is
    profiled (K2's two kernels and no library FFT), and both are timed
    beside the library calls (CUDA events, cold)."""
    import numpy as np
    import torch
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.ops import istft, stft
    n_fft, hop = 510, 128
    hann = K2.hann_window(n_fft)
    hamming = (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    g = torch.Generator().manual_seed(31)
    rand = lambda *s: torch.randn(s, generator=g).to(dev)
    x = rand(8, 65536)
    real = torch.view_as_real
    worst = {"stft": 0.0, "istft": 0.0, "torch.stft": 0.0, "torch.istft": 0.0}
    launches = {"stft_analysis": 0, "stft_synthesis": 0}
    refused = 0

    def held(what, key, ours, ref, tol):
        peak = float(ref.abs().max())
        err = max_err(ours, ref)
        check(f"functional {what}", err, tol * peak)
        worst[key] = max(worst[key], err / peak)

    for center, pad_mode in FUNCTIONAL_STFT:
        kw = dict(n_fft=n_fft, hop_length=hop, center=center)
        what = f"center={center} {pad_mode}"
        K2.stft_analysis.launches = K2.stft_synthesis.launches = 0
        spec = stft(x, hann, pad_mode=pad_mode, **kw)
        with k2_plain():
            spec_p = stft(x, hann, pad_mode=pad_mode, **kw)
        lib = torch.stft(x, n_fft, hop, window=torch.as_tensor(hann, device=dev), center=center,
                         pad_mode=pad_mode, return_complex=True)
        held(f"stft {what}", "stft", real(spec), real(spec_p), 2e-5)
        held(f"stft {what} (torch.stft)", "torch.stft", real(spec), real(lib), 2e-5)
        T = spec.shape[-1]
        natural = n_fft + hop * (T - 1) - (2 * (n_fft // 2) if center else 0)
        spec_in = torch.complex(rand(8, n_fft // 2 + 1, T), rand(8, n_fft // 2 + 1, T))
        for wname, window in [("hann", hann)] + ([("hamming", hamming)] if not center else []):
            for length in (None, natural - 4096, natural + 4096):
                y = istft(spec_in, window, length=length, **kw)
                if y.shape != (8, natural if length is None else length):
                    raise AssertionError(f"functional istft {what} length={length}: {y.shape}")
                with k2_plain():
                    y_p = istft(spec_in, window, length=length, **kw)
                held(f"istft {what} {wname} length={length}", "istft", y, y_p, 1e-4)
                wt = torch.as_tensor(window, device=dev)
                lib_y = _try(lambda: torch.istft(spec_in, n_fft, hop, window=wt, center=center,
                                                 length=length))
                if center or wname == "hamming":
                    held(f"istft {what} {wname} length={length} (torch.istft)", "torch.istft",
                         y, lib_y, 1e-4)
                elif isinstance(lib_y, RuntimeError):
                    refused += 1
                else:
                    raise AssertionError("torch.istft took a Hann window without centring")
        counts = (K2.stft_analysis.launches, K2.stft_synthesis.launches)
        if 0 in counts:
            raise AssertionError(f"functional stft/istft {what}: K2 launches {counts}")
        launches["stft_analysis"] += counts[0]
        launches["stft_synthesis"] += counts[1]

    def pair():
        return istft(stft(x, hann, n_fft=n_fft, hop_length=hop), hann, n_fft=n_fft,
                     hop_length=hop, length=65536)

    with torch.no_grad():
        found = profile_device_us(pair, reps=5)
        library_fft = [k for k in found if "fft" in k.lower() and not k.startswith("stft_")]
        if "stft_analysis_kernel" not in found or "stft_synthesis_kernel" not in found \
                or library_fft:
            raise AssertionError(f"functional stft + istft: kernels {sorted(found)}")
        wt = torch.as_tensor(hann, device=dev)
        spec = stft(x, hann, n_fft=n_fft, hop_length=hop)
        ms = {"stft": cuda_ms(lambda: stft(x, hann, n_fft=n_fft, hop_length=hop)),
              "torch.stft": cuda_ms(lambda: torch.stft(x, n_fft, hop, window=wt,
                                                       return_complex=True)),
              "istft": cuda_ms(lambda: istft(spec, hann, n_fft=n_fft, hop_length=hop,
                                             length=65536)),
              "torch.istft": cuda_ms(lambda: torch.istft(spec, n_fft, hop, window=wt,
                                                         length=65536))}
    out = {"worst_err_of_peak": {k: float(f"{v:.3e}") for k, v in worst.items()},
           "launches": launches, "torch_istft_refused": refused,
           "kernels_in_a_pair": {k: v[1] // 5 for k, v in found.items()},
           "ms_cold": {k: round(v, 4) for k, v in ms.items()}}
    log(f"functional stft / istft (model geometry 510/128, (8, 65536) float32; center True / "
        f"False x reflect / constant, istft lengths None, -4096, +4096): against K2's plain "
        f"versions within 2e-5 / 1e-4 of the peak and against torch.stft / torch.istft (which "
        f"refused Hann without centring {refused} times: held there with a Hamming window); "
        f"no library FFT inside: " + json.dumps(out))
    return out


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
    "stft_chirp_analysis_kernel", "stft_chirp_synthesis_kernel",
    "subband_fft_conv_kernel",                                                            # K3
    "compress_kernel", "compress_bwd_kernel", "comp_loss_fwd_kernel", "comp_loss_bwd_kernel",  # K4
    "minphase_fwd_kernel", "minphase_bwd_kernel",                                         # K5
    "design_fwd_kernel", "design_bwd_kernel",                                             # K6
    "wpe_solve_kernel", "wpe_solve_large_kernel",                                         # K7
    "qc_absmax_kernel", "qc_quantize_kernel", "qc_weight_kernel", "qc_conv_kernel")       # K10


def device_busy_ms(prof) -> float:
    """ms in which the card ran at least one kernel, copy or set: the union
    of the device events' intervals in a profiler's trace (summed kernel
    times count overlapping kernels twice)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def profile_main_path(run, n_steps: int) -> None:
    """One more main-path run under torch.profiler: device ms per step of
    each of the port's kernels (by exact function name) and of all other
    kernels together, the count of kernel launches, and the device's busy
    share of the wall time.  The full per-kernel table goes to
    chiprun_out/profile_main_path.txt."""
    import torch
    with device_profile(cpu=True) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    union = device_busy_ms(prof)
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
        f"{wall * 1e3:.1f} ms, device time summed {busy:.1f} ms, busy (the union of the device "
        f"events) {union:.1f} ms ({100 * union / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - union / (wall * 1e3)):.1f}%; device kernel and copy launches {total} "
        f"({total / n_steps:.0f} per step; {ours_count} of them the port's kernels); device ms "
        f"per step: " + json.dumps(per_step))


def wpe_warm_init(dev, wcfg) -> None:
    """The WPE warm init alone at the main path's batch (the 8 degraded
    utterances of 65536 samples, the tester's taps, delay and iterations):
    CUDA-event ms a call (cold), and its device time split by the profile
    into K7, K2, the correlations' matmuls and the rest."""
    import torch
    from buddy_tpu_torch.sampling.wpe import wpe_dereverb
    ys = torch.from_numpy(load_wavs("degraded", 8, 65536)).to(dev)[:, 0]
    call = lambda: wpe_dereverb(ys, taps=int(wcfg["taps"]), delay=int(wcfg["delay"]),
                                iterations=int(wcfg["iterations"]))
    reps = 3
    with torch.no_grad():
        ms = cuda_ms(call, reps=5)
        found = profile_device_us(call, reps=reps)
    split = {"K7 wpe_solve kernels": [0.0, 0], "K2 stft kernels": [0.0, 0],
             "matmuls (cuBLAS)": [0.0, 0], "other": [0.0, 0]}
    for name, (us, count) in found.items():
        low = name.lower()
        if name in ("wpe_solve_kernel", "wpe_solve_large_kernel"):
            key = "K7 wpe_solve kernels"
        elif name.startswith("stft_"):
            key = "K2 stft kernels"
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "xmma")):
            key = "matmuls (cuBLAS)"
        else:
            key = "other"
        split[key][0] += us / reps / 1e3
        split[key][1] += count // reps
    device = sum(v[0] for v in split.values())
    log(f"WPE warm init alone (B=8 x 65536, taps {wcfg['taps']}, delay {wcfg['delay']}, "
        f"{wcfg['iterations']} iterations): {ms:.3f} ms a call (CUDA events, cold), device "
        f"{device:.3f} ms, by part [ms, launches]: "
        + json.dumps({k: [round(v[0], 4), v[1]] for k, v in split.items()}))


def blind_tester(dev, steps: int = N_STEPS, network=("network.compute_dtype=bfloat16",),
                 run_name: str = "blind"):
    """The main path's tester: blind, batched (one batch of 8 x 65536
    samples), full width, bf16 body (or the ``network`` overrides), full
    guidance, 10 operator updates a step, WPE warm init, T = ``steps``, on a
    paired test set written under chiprun_out/.  Returns (args, net, tester,
    sampler_s, run): the sampler call's wall seconds are appended to
    sampler_s, and run() is one ``do_test()`` with the device synchronised."""
    import torch
    data = write_paired_set(os.path.join(OUT_DIR, "smoke_data"),
                            load_wavs("clean", 8, 65536)[:, 0], seed=11)
    args, net, tester = build_tester(dev, "blind_dereverberation_BUDDy", data, run_name, [
        f"tester.sampling_params.T={steps}", *network,
        "tester.posterior_sampling.guidance_jacobian=full",
        "tester.posterior_sampling.blind_hp.op_updates_per_step=10",
        "tester.posterior_sampling.warm_initialization.mode=wpe_scaled",
        "tester.batched.use=True", "tester.batched.batch_size=8"])
    log(f"{run_name}: Tester.do_test(), blind, batched; NCSN++ nf={args['network']['nf']} "
        f"ch_mult={list(args['network']['ch_mult'])} ({net.num_params / 1e6:.2f} M params, "
        f"compute_dtype {args['network']['compute_dtype']}), B=8 x 65536 samples, "
        f"T={tester.sampler.T} steps, 10 operator updates/step, full guidance, WPE warm init")
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
        shutil.rmtree(os.path.join(args["model_dir"], run_name), ignore_errors=True)
        tester.do_test()
        torch.cuda.synchronize()

    return args, net, tester, sampler_s, run


def main_path(dev, wrappers):
    """Phase 4: ``Tester.do_test()`` in blind mode, one batch of 8, full width."""
    import torch
    args, net, tester, sampler_s, run = blind_tester(dev)
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
    wpe_warm_init(dev, args["tester"]["posterior_sampling"]["warm_initialization"]["wpe"])
    return launches, wall


def other_modes(dev) -> float:
    """Phase 5: informed (full and identity guidance) and unconditional at
    full width, the chunked path at a small network, and the CLI as a
    subprocess; returns the informed identity run's seconds."""
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
    _, _, tester = build_tester(dev, "informed_dereverberation_DPS", data, "informed_identity",
                                wide + ["dset.test.num_examples=2", IDENTITY])
    if tester.sampler.guidance_jacobian != "identity":
        raise AssertionError(f"informed identity: {tester.sampler.guidance_jacobian} guidance")
    tester.do_test()
    check_outputs(tester, "informed_dereverberation", 2, 65536, blind=False)
    identity_s = time.perf_counter() - t0
    log(f"informed dereverberation with identity guidance (serial, RIR operator, 2 items x "
        f"65536, full width, bf16, T=2): 4 directories x 2 finite WAVs in {identity_s:.1f} s")

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
    return identity_s


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


def small_reference(dev, guidance: str = "full"):
    """The blind program at a small size with ``guidance`` (full or
    identity), kernels on the card against plain versions on the CPU, same
    weights (same seed) and noise; returns the card's and the CPU's
    outputs.  The shipped ``init_scale`` 0 zeroes every residual branch's
    last conv and the output conv, which leaves the denoiser c_skip x, a
    linear-diagonal map under which identity and full guidance agree; at
    ``init_scale`` 1 the U-Net takes part."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    overrides = ["network.init_scale=1.0",
                 "network.nf=16", "network.ch_mult=[1,2,2,2]", "tester.sampling_params.T=2",
                 "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
                 "tester.posterior_sampling.warm_initialization.mode=reverb_scaled",
                 f"tester.posterior_sampling.guidance_jacobian={guidance}"]
    ys = torch.from_numpy(load_wavs("degraded", 2, 16384))
    outs = []
    for d in (dev, torch.device("cpu")):
        sampler, op = build_program(overrides, d)
        if sampler.guidance_jacobian != guidance:
            raise AssertionError(f"small program: {sampler.guidance_jacobian} guidance")
        params, H = op.reset_batched(2, noise=torch.randn((2, op.length_rir),
                                                          generator=torch.Generator().manual_seed(4)))
        out = sampler.predict_conditional_batched(ys, op, blind=True, noise=NoiseSource(torch.Generator().manual_seed(5)),
                                                  op_params_batch=params, H_batch=H)
        outs.append(out.detach().cpu())
    # float32 on both sides; the operator's Adam steps (lr * m/sqrt(v))
    # amplify rounding where the second moment is small: 5e-3 of the peak
    err = max_err(outs[0], outs[1])
    tol = 5e-3 * float(outs[1].abs().max())
    check(f"small blind program ({guidance} guidance), card vs CPU", err, tol)
    log(f"small blind program (B=2, 16384 samples, T=2, init_scale 1, {guidance} guidance): card "
        f"kernels vs CPU plain versions, max abs error {err:.3e} (tolerance {tol:.3e}, "
        f"{err / float(outs[1].abs().max()):.2e} of the peak)")
    return outs


# ---------------------------------------------------------------------------
# phase 6: training and checkpointing
# ---------------------------------------------------------------------------
TRAIN_BATCH = 16                # the shipped exp: batch 16 of 65536 samples, float32
TRAIN_GRAD_ACCUM = 1            # exp.grad_accum of the full-width run
TRAIN_STEPS = 5                 # the uninterrupted run: it = 0 .. 4, saves at it = 2 and 4
TINY_TRAIN = ["network.nf=8", "network.ch_mult=[1,2,2,2]", "network.num_res_blocks=1"]
NATIVE_CLI = "Loader:                  NativeBatchLoader"   # the training CLI's line


class RecordingLoader:
    """A batch loader that keeps every batch it hands out."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []

    def next_batch(self):
        batch = self.inner.next_batch()
        self.batches.append(batch)
        return batch

    def close(self):
        self.inner.close()


class ReplayLoader:
    """Hands out given batches in order."""

    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0)


def write_train_set(root: str) -> str:
    """The 8 in-repo clean utterances of 65536 samples under
    ``root/<speaker>/``, the layout ``VCTKTrain`` scans (p225, p226)."""
    from buddy_tpu_torch.data.audio_io import write_wav
    shutil.rmtree(root, ignore_errors=True)
    for i, utt in enumerate(load_wavs("clean", 8, 65536)[:, 0]):
        spk = "p225" if i < 4 else "p226"
        os.makedirs(os.path.join(root, spk), exist_ok=True)
        write_wav(os.path.join(root, spk, f"utt{i}.wav"), utt, 16000)
    return root


def build_trainer(dev, overrides, loader=None, noise=None):
    """compose -> training set and loader (unless ``loader`` is given) ->
    network (random weights from exp.seed) -> in-training tester ->
    Trainer, as ``python -m buddy_tpu_torch.training`` builds them."""
    import torch
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.data.loader import make_train_loader
    from buddy_tpu_torch.models import NetworkBundle
    from buddy_tpu_torch.testing.tester import Tester
    args = compose("conf_VCTK.yaml", overrides)
    args["exp"]["model_dir"] = args["model_dir"]
    os.makedirs(args["model_dir"], exist_ok=True)
    if loader is None:
        loader = RecordingLoader(make_train_loader(
            instantiate(args["dset"]["train"]), batch_size=int(args["exp"]["batch_size"]),
            num_workers=int(args["exp"]["num_workers"]), seed=int(args["exp"]["seed"])))
    net = NetworkBundle(instantiate(args["network"], device=dev, seed=int(args["exp"]["seed"])))
    diff = instantiate(args["diff_params"])
    args["tester"]["sampling_params"]["same_as_training"] = True
    tester = Tester(args, net, diff, device=dev, in_training=True)
    trainer = instantiate(args["exp"]["trainer"], args, loader, net, diff, tester, device=dev,
                          noise=noise)
    return trainer, loader


def gn_calls_of_step(module, batch: int, length: int, dev):
    """[((B, C, H, W), silu)] of every GroupNorm call of one forward at the
    training batch, in call order (forward hooks on the GroupNormAct
    modules)."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.models.layers import GroupNormAct
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: calls.append((tuple(a[0].shape), m.act is F.silu)))
        for m in module.modules() if isinstance(m, GroupNormAct)]
    try:
        with torch.no_grad():
            module(torch.zeros((batch, 1, length), device=dev), torch.zeros((batch,), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return calls


def k1_training_checks(dev, calls) -> dict:
    """K1 in float32 at every GroupNorm shape of the train step, forward and
    backward with d weight and d bias, through the autograd wrapper and the
    C calls, against the plain version; each timed (cold) beside the plain
    version and F.group_norm (+ F.silu), the backward with autograd, and
    the kernels' device us a call from the profiler (cold).  The bound
    counts x read and y written (forward, 8 bytes an element, 10
    operations), x and dy read and dx written (backward, 12 bytes, 20
    operations).  Returns the kernels line's two entries at the top-level
    shape, the others under "shapes"."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.ops import groupnorm as K1
    g = torch.Generator(device=dev).manual_seed(2)
    cl = torch.channels_last
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    shapes = {}
    for shape, silu in calls:
        shapes[(shape, silu)] = shapes.get((shape, silu), 0) + 1
    table, entries = [], {}
    for (shape, silu), count in sorted(shapes.items(), key=lambda kv: -kv[0][0][1] * kv[0][0][2]
                                       * kv[0][0][3]):
        B, C, H, W = shape
        G = min(C // 4, 32)
        act = F.silu if silu else (lambda v: v)
        x = (rand(B, C, H, W) * 2 + 0.3).contiguous(memory_format=cl)
        dy = rand(B, C, H, W).contiguous(memory_format=cl)
        w, b = 1 + 0.1 * rand(C), 0.1 * rand(C)
        xp, wp, bp = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        yp = K1.group_norm_act_plain(xp, wp, bp, G, 1e-6, silu=silu)
        dxp, dwp, dbp = torch.autograd.grad(yp, (xp, wp, bp), dy, retain_graph=True)
        xa, wa, ba = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        ya = K1.group_norm_act(xa, wa, ba, G, 1e-6, silu=silu)
        dxa, dwa, dba = torch.autograd.grad(ya, (xa, wa, ba), dy)
        # float32 inside both, the statistics summed in another order: y and
        # dx to 1e-5 of their peaks; d weight and d bias are sums of
        # B H W = 2e5 - 2.2e6 terms a channel in another order: 1e-4 of the peak
        tol_y, tol_dx = 1e-5 * float(yp.detach().abs().max()), 1e-5 * float(dxp.abs().max())
        tol_w, tol_b = 1e-4 * float(dwp.abs().max()), 1e-4 * float(dbp.abs().max())
        where = f"{list(shape)} silu={silu} float32"
        err = {"y": max_err(ya.detach(), yp.detach()), "dx": max_err(dxa, dxp),
               "dweight": max_err(dwa, dwp), "dbias": max_err(dba, dbp)}
        for k, tol in (("y", tol_y), ("dx", tol_dx), ("dweight", tol_w), ("dbias", tol_b)):
            check(f"groupnorm autograd {k} {where}", err[k], tol)
        y_k, mr = K1._launch_forward(x, w, b, G, 1e-6, silu)
        dx, dw, db = K1.group_norm_act_backward(x, dy, w, b, mr, silu, True)
        check(f"groupnorm fwd {where}", max_err(y_k, yp.detach()), tol_y)
        check(f"groupnorm bwd dx {where}", max_err(dx, dxp), tol_dx)
        check(f"groupnorm bwd dweight {where}", max_err(dw, dwp), tol_w)
        check(f"groupnorm bwd dbias {where}", max_err(db, dbp), tol_b)
        again = K1.group_norm_act_backward(x, dy, w, b, mr, silu, True)
        if not all(torch.equal(u, v) for u, v in zip((dx, dw, db), again)):
            raise AssertionError(f"groupnorm {where}: two backward calls differ")
        del dxp, dwp, dbp, dxa, dwa, dba, ya, xa, y_k, dx, dw, db, again
        xl, wl, bl = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        yl = act(F.group_norm(xl, G, wl, bl, 1e-6))
        reps = 10 if x.numel() > 4e8 else 20
        with torch.no_grad():
            t_fwd = (cuda_ms(lambda: K1.group_norm_act(x, w, b, G, 1e-6, silu=silu), reps),
                     cuda_ms(lambda: K1.group_norm_act_plain(x, w, b, G, 1e-6, silu=silu), reps),
                     cuda_ms(lambda: act(F.group_norm(x, G, w, b, 1e-6)), reps))
            t_bwd = [cuda_ms(lambda: K1.group_norm_act_backward(x, dy, w, b, mr, silu, True), reps)]
        t_bwd += [cuda_ms(lambda: torch.autograd.grad(yp, (xp, wp, bp), dy, retain_graph=True),
                          reps),
                  cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True),
                          reps)]
        with torch.no_grad():
            us = (device_us_per_call(lambda: K1._launch_forward(x, w, b, G, 1e-6, silu), reps),
                  device_us_per_call(
                      lambda: K1.group_norm_act_backward(x, dy, w, b, mr, silu, True), reps))
        n = x.numel()
        b_f, b_b = bound_ms(8 * n, 10 * n), bound_ms(12 * n, 20 * n)
        row = {"shape": list(shape), "silu": silu, "calls_per_forward": count,
               "err": {k: float(v) for k, v in err.items()},
               "device_us": [round(u, 1) for u in us],
               "fwd_ms": [round(t, 4) for t in t_fwd], "bwd_ms": [round(t, 4) for t in t_bwd],
               "bound_ms": [round(b_f[0], 4), round(b_b[0], 4)]}
        table.append(row)
        # the kernels line reports the top level's nf-channel shape with SiLU
        # (the largest H W, the fewest channels there)
        key = (-H * W, C)
        if silu and (not entries or key < entries["key"]):
            entries = {"key": key, "groupnorm_silu_fwd_f32": dict(
                err=err["y"], tol=tol_y, times=t_fwd, shape=list(shape), bound=b_f,
                extra={"device_us": us[0]}),
                "groupnorm_silu_bwd_f32": dict(
                err=err["dx"], tol=tol_dx, times=tuple(t_bwd), shape=list(shape), bound=b_b,
                extra={"device_us": us[1], "dweight_err": err["dweight"],
                       "dbias_err": err["dbias"]})}
        del x, dy, xp, yp, xl, yl, mr
        torch.cuda.empty_cache()
    del entries["key"]
    for e in entries.values():
        e["extra"]["shapes"] = table
    log(f"kernel K1 groupnorm float32 at the train step's {len(table)} GroupNorm shapes "
        f"(batch {TRAIN_BATCH}, {sum(shapes.values())} calls a forward): y, dx, d weight and "
        f"d bias through the autograd wrapper and the C calls match the plain version; device "
        f"us a call [fwd, bwd], ms [kernel, plain, library] (cold) and bound ms [fwd, bwd]: "
        + json.dumps(table))
    return entries


def k2_training_checks(dev) -> dict:
    """K2 at the train step's shapes: the model geometry (510/128, reflect)
    on a (TRAIN_BATCH, 65536) float32 batch.  A step runs the analysis (513
    frames), the synthesis (528 frames, after pad_spec_frames) and the
    synthesis's backward (the analysis with the ISTFT's bin weights); the
    analysis's backward (the synthesis with unit weights) is held too.  Each
    against its plain version (the backwards against autograd through the
    plain version's torch.fft ops) to 1e-4 of the peak, as in phase 3, and
    bit for bit between two calls; ms (cold) of the kernel, the plain
    version and the library call (torch.stft, conv_transpose1d, and conv1d,
    the transposed convolution's adjoint, for the synthesis's backward), the
    kernel's device us a launch (cold) and the bound, counted as in phase
    3.  Run before cuDNN is made deterministic: the library's convolutions
    are timed with their default algorithms."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.ops.stft import STFT, hann_window, pad_spec_frames
    g = torch.Generator(device=dev).manual_seed(3)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    crand = lambda *s: torch.complex(rand(*s), rand(*s))
    n_fft = 510
    geom = STFT(n_fft, 128, hann_window(n_fft), pad_mode="reflect", device=dev)
    plan = geom.plan
    x = rand(TRAIN_BATCH, 65536)
    blocks, T = geom.frame_blocks(x)
    spec_p = K2.analysis_plain(blocks, plan, T, plan.ones).contiguous()
    spec = pad_spec_frames(spec_p, 16).contiguous()
    y_p = K2.synthesis_plain(spec, plan, plan.istft_weights)
    gspec, gy = crand(*spec_p.shape), rand(*y_p.shape)

    def grad(fn, leaf, g_out):
        leaf = leaf.detach().requires_grad_(True)
        return torch.autograd.grad(fn(leaf), leaf, g_out)[0]

    real = lambda t: torch.view_as_real(t) if t.is_complex() else t
    calls = {  # name: (kernel, plain version, frames of the FFTs)
        "analysis": (lambda: K2.stft_analysis(blocks, plan, T),
                     lambda: K2.analysis_plain(blocks, plan, T, plan.ones), T),
        "synthesis": (lambda: K2.stft_synthesis(spec, plan),
                      lambda: K2.synthesis_plain(spec, plan, plan.istft_weights), spec.shape[-1]),
        "analysis_bwd": (lambda: grad(lambda b: K2.stft_analysis(b, plan, T), blocks, gspec),
                         lambda: grad(lambda b: K2.analysis_plain(b, plan, T, plan.ones),
                                      blocks, gspec), T),
        "synthesis_bwd": (lambda: grad(lambda s: K2.stft_synthesis(s, plan), spec, gy),
                          lambda: grad(lambda s: K2.synthesis_plain(s, plan, plan.istft_weights),
                                       spec, gy), spec.shape[-1]),
    }
    z = torch.cat([spec.real, spec.imag], 1).contiguous()              # (N, 2F, frames)
    wct = synthesis_basis(plan).to(dev)
    gy_lib = rand(TRAIN_BATCH, 1, (spec.shape[-1] - 1) * plan.hop + wct.shape[-1])
    wt = torch.as_tensor(hann_window(n_fft), device=dev)
    library = {
        "analysis": lambda: torch.stft(x, n_fft, 128, window=wt, center=True, pad_mode="reflect",
                                       return_complex=True),
        "synthesis": lambda: F.conv_transpose1d(z, wct, stride=plan.hop),
        "analysis_bwd": None,
        "synthesis_bwd": lambda: F.conv1d(gy_lib, wct, stride=plan.hop),
    }
    fft_flops = 2.5 * n_fft * np.log2(n_fft) * TRAIN_BATCH
    out = {}
    for name, (kern, plain, frames) in calls.items():
        a, ref = kern(), plain()
        tol = 1e-4 * float(ref.abs().max())
        err = max_err(real(a), real(ref))
        check(f"stft_{name} training shape {list(x.shape)}", err, tol)
        if not torch.equal(a, kern()):
            raise AssertionError(f"stft_{name} training shape: two calls differ")
        spec_bytes = 8 * TRAIN_BATCH * plan.n_bins * frames
        sig_bytes = 4 * (blocks.numel() if name.startswith("analysis") else y_p.numel())
        b = bound_ms(spec_bytes + sig_bytes, fft_flops * frames)
        lib = library[name]
        times = (cuda_ms(kern), cuda_ms(plain), None if lib is None else cuda_ms(lib))
        kname = "stft_analysis_kernel" if name in ("analysis", "synthesis_bwd") \
            else "stft_synthesis_kernel"
        us = device_us_per_launch(kern, [kname])[kname]
        out[name] = {"err": err, "tol": tol, "ms": times, "device_us": us, "bound_ms": b[0],
                     "bound_by": b[1]}
    log(f"kernel K2 at the train step's shapes (model geometry 510/128 reflect, batch "
        f"{list(x.shape)} float32: blocks {list(blocks.shape)}, spec {list(spec_p.shape)} -> "
        f"{list(spec.shape)}): analysis, synthesis and both backwards match the plain version "
        f"(1e-4 of the peak) and are bit-identical between two calls; ms [kernel, plain, "
        f"library] (cold, the backwards through torch.autograd.grad), the kernel's device us "
        f"a launch (cold) and bound: " + json.dumps(out))
    return out


def profile_train_step(trainer) -> dict:
    """One train step under torch.profiler: device ms by part, the count of
    launches, the device's busy time (the union of its events' intervals)
    and idle share of the wall time; the per-kernel table goes to
    chiprun_out/profile_train_step.txt."""
    import torch
    with device_profile(cpu=True) as prof:
        t0 = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    parts = {"K1 groupnorm fwd": 0.0, "K1 groupnorm bwd": 0.0, "K2 stft": 0.0,
             "cuDNN convolutions (their FFTs and layout transforms too)": 0.0,
             "cuBLAS GEMMs (real: attention, dense layers, GEMM-route convolutions)": 0.0,
             "optimizer and EMA (foreach)": 0.0, "other elementwise, reductions, copies": 0.0}
    for key, ms, _ in rows:
        name, low = kernel_name(key), key.lower()
        if name in ("gn_stats_kernel", "gn_apply_kernel"):
            part = "K1 groupnorm fwd"
        elif name in ("gn_bwd_stats_kernel", "gn_bwd_apply_kernel"):
            part = "K1 groupnorm bwd"
        elif name.startswith("stft_"):
            part = "K2 stft"
        elif "multi_tensor_apply" in low:
            part = "optimizer and EMA (foreach)"
        elif any(s in low for s in ("cudnn", "conv", "fft2d", "wgrad", "dgrad", "fprop",
                                    "winograd", "cf32")):
            part = "cuDNN convolutions (their FFTs and layout transforms too)"
        elif any(s in low for s in ("gemm", "cutlass", "cublas")):
            part = "cuBLAS GEMMs (real: attention, dense layers, GEMM-route convolutions)"
        else:
            part = "other elementwise, reductions, copies"
        parts[part] += ms
    with open(os.path.join(OUT_DIR, "profile_train_step.txt"), "w") as f:
        for key, ms, count in sorted(rows, key=lambda r: -r[1]):
            f.write(f"{ms:12.3f} ms {count:8d}x  {key}\n")
    union = device_busy_ms(prof)
    # kernels on cuDNN's side streams overlap: their summed time can exceed
    # the wall, so the idle share comes from the union of their intervals
    return {"wall_ms": wall, "device_ms_summed": sum(parts.values()), "busy_ms": union,
            "idle": 1 - union / wall,
            "launches": sum(r[2] for r in rows),
            "device_ms_by_part": {k: round(v, 3) for k, v in parts.items()}}


def steps_ms(trainer, n: int) -> float:
    """ms a train step (CUDA events around n steps, the loader and the
    host's draws included)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        trainer.train_step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def training_path(dev, wrappers) -> dict:
    """Phase 6: the full-width network trained on the card at the shipped
    exp through ``Trainer.training_loop`` (saves, logs), K1 and K2 launched
    in every step; a resumed Trainer's next steps held to the uninterrupted
    run's; ms a step, peak memory, one profiled step; heavy_logging."""
    import numpy as np
    import torch
    data = write_train_set(os.path.join(OUT_DIR, "train"))
    model_dir = os.path.join(OUT_DIR, "train_runs", "full")
    shutil.rmtree(model_dir, ignore_errors=True)
    overrides = [
        f"dset.train.path={data}", "dset.train.speakers_test=[]", "dset.train.speakers_discard=[]",
        f"exp.batch_size={TRAIN_BATCH}", f"exp.grad_accum={TRAIN_GRAD_ACCUM}",
        f"exp.max_iters={TRAIN_STEPS - 1}", "exp.resume=False", "logging.save_interval=2",
        "logging.log_interval=1", "logging.heavy_log_interval=1000000",
        "logging.remove_old_checkpoints=False", "tester=only_unconditional",
        "tester.sampling_params.T=2", "tester.unconditional.num_samples=2",
        f"model_dir={model_dir}"]
    trainer, loader = build_trainer(dev, overrides)
    a = trainer.args
    from buddy_tpu_torch.data.loader import NativeBatchLoader
    if not isinstance(loader.inner, NativeBatchLoader):
        raise AssertionError(f"phase 6 trains on {type(loader.inner).__name__}, not the native "
                             f"loader")
    calls = gn_calls_of_step(trainer.module, TRAIN_BATCH // TRAIN_GRAD_ACCUM, 65536, dev)
    log(f"training: NCSN++ nf={a['network']['nf']} ch_mult={list(a['network']['ch_mult'])} "
        f"({trainer.total_params / 1e6:.2f} M params, compute_dtype "
        f"{a['network']['compute_dtype']}), batch {a['exp']['batch_size']} x "
        f"{a['exp']['audio_len']}, grad_accum {trainer.grad_accum}, Adam lr {trainer.lr}, "
        f"clip {trainer.max_grad_norm}, EMA {trainer.ema_rate} rampup {trainer.ema_rampup}; "
        f"{len(calls)} GroupNorm calls a forward")
    entries = k1_training_checks(dev, calls)
    k2 = k2_training_checks(dev)
    # the resume check holds the resumed run to the uninterrupted one bit for
    # bit: cuDNN's deterministic algorithms (K1's sums are in a fixed order)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    k_names = ("groupnorm_silu_fwd", "groupnorm_silu_bwd", "stft_analysis", "stft_synthesis")
    per_step = []
    inner = trainer.train_step

    def counted():
        before = {k: wrappers[k].launches for k in k_names}
        inner()
        per_step.append({k: wrappers[k].launches - before[k] for k in k_names})

    trainer.train_step = counted
    p0 = {k: p.detach().clone() for k, p in trainer.params.items()}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.training_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer.train_step = inner
    losses = [r["loss"] for r in trainer._log_rows]
    if trainer.it != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
        raise AssertionError(f"training loop: it={trainer.it}, {len(per_step)} steps")
    if len(losses) != TRAIN_STEPS - 1 or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {losses}")
    bad = [s for s in per_step if min(s.values()) == 0]
    if bad:
        raise AssertionError(f"a train step launched no K1 or K2: {per_step}")
    w_key = "unet.all_modules.0.W"
    moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.params.items())
    if not torch.equal(trainer.params[w_key], p0[w_key]) or moved < 0.8 * len(p0):
        raise AssertionError(f"training: W changed or only {moved} of {len(p0)} leaves moved")
    files = sorted(os.listdir(model_dir))
    ckpts = [f for f in files if f.endswith(".ckpt")]
    if ckpts != ["VCTK_16k_4s_time-2.ckpt", "VCTK_16k_4s_time-4.ckpt"] or \
            "train_log.jsonl" not in files:
        raise AssertionError(f"training output: {files}")
    log(f"training loop (Trainer.training_loop, {TRAIN_STEPS} steps it=0..{TRAIN_STEPS - 1}, "
        f"saves at it=2 and 4, logs at it=1..4, deterministic cuDNN): losses "
        f"{[round(v, 5) for v in losses]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in trainer._log_rows]}; W unchanged, {moved} of "
        f"{len(p0)} leaves moved; wall {wall:.2f} s incl. the first step's set-up; peak memory "
        f"{peak:.2f} GiB (max_memory_allocated); launches per step (K1 fwd, K1 bwd, K2 "
        f"analysis, K2 synthesis): {json.dumps(per_step)}")

    # resume from the save at it=2 and take the steps it=3, 4 on the batches
    # the uninterrupted run took there
    resumed, _ = build_trainer(dev, overrides + [
        "exp.resume=True", f"exp.resume_checkpoint={os.path.join(model_dir, ckpts[0])}"],
        loader=ReplayLoader(loader.batches[3:TRAIN_STEPS]))
    if resumed.it != 2 or resumed.count != 3:
        raise AssertionError(f"resume: it={resumed.it}, Adam count {resumed.count}")
    for it in range(3, TRAIN_STEPS):
        resumed.it = it
        resumed.train_step()
    diffs = {}
    for what in ("params", "ema", "mu", "nu"):
        x, y = getattr(trainer, what), getattr(resumed, what)
        diffs[what] = max(float((x[k] - y[k]).detach().abs().max()) for k in x)
    if any(diffs.values()) or resumed.count != trainer.count:
        raise AssertionError(f"resumed run differs from the uninterrupted one: max abs "
                             f"differences {diffs}")
    log(f"resume from it=2: the steps it=3, 4 give parameters, EMA and Adam moments bit for bit "
        f"equal to the uninterrupted run's (max abs differences {diffs})")
    del resumed
    loader.close()

    # ms a step: deterministic cuDNN (the resume check's setting) and the default
    trainer.dset = ReplayLoader(loader.batches[:TRAIN_STEPS] * 3)
    ms_det = steps_ms(trainer, 3)
    torch.backends.cudnn.deterministic = False
    steps_ms(trainer, 1)
    ms_default = steps_ms(trainer, 3)
    prof = profile_train_step(trainer)
    log(f"train step (batch {TRAIN_BATCH} x 65536, float32, grad_accum {TRAIN_GRAD_ACCUM}): "
        f"{ms_default:.1f} ms a step (CUDA events over 3 steps, the loader and the host's draws "
        f"included), {ms_det:.1f} ms with deterministic cuDNN; peak memory {peak:.2f} GiB; "
        f"one profiled step: " + json.dumps(prof))

    # heavy_logging: unconditional samples from the EMA, the trainer's weights untouched
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    bwd0 = wrappers["groupnorm_silu_bwd"].launches
    trainer.heavy_logging()
    changed = [k for k, p in trainer.params.items() if not torch.equal(p, before[k])]
    samples = sorted(f for f in os.listdir(model_dir) if f.startswith("sample_"))
    from buddy_tpu_torch.data.audio_io import read_wav
    wavs = [read_wav(os.path.join(model_dir, f))[0] for f in samples]
    if changed or len(samples) != 2 or not all(len(w_) == 65536 and np.isfinite(w_).all()
                                               for w_ in wavs):
        raise AssertionError(f"heavy_logging: changed {changed[:3]}, samples {samples}")
    if wrappers["groupnorm_silu_bwd"].launches != bwd0:
        raise AssertionError("heavy_logging ran K1's backward")
    log(f"heavy_logging (unconditional, T=2, 2 samples x 65536 from the EMA): {samples}, "
        f"finite; the trainer's parameters unchanged, no K1 backward")
    input_pipeline = loader_step(dev, trainer, data, ms_default)
    step_counts = per_step[0]
    for e in entries.values():
        e["extra"]["training_ms_per_step"] = ms_default
    entries["groupnorm_silu_fwd_f32"]["extra"]["launches_per_step"] = step_counts[
        "groupnorm_silu_fwd"]
    entries["groupnorm_silu_bwd_f32"]["extra"]["launches_per_step"] = step_counts[
        "groupnorm_silu_bwd"]
    del trainer
    torch.cuda.empty_cache()
    for f in ckpts:             # 1 GB each: not for chiprun_out's way back
        os.remove(os.path.join(model_dir, f))
    return {"entries": entries, "k2": k2, "launches": launches, "per_step": step_counts,
            "ms_per_step": ms_default, "peak_gib": peak, "input_pipeline": input_pipeline}


LOADER_WINDOW_S = 1.0           # each loader's batches are counted over this long
LOADER_STEPS = 3                # train steps with get_batch timed, each loader


def batches_per_s(loader) -> float:
    """Batches a second that ``loader.next_batch`` hands out over
    ``LOADER_WINDOW_S`` after two batches of warm-up."""
    for _ in range(2):
        loader.next_batch()
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < LOADER_WINDOW_S:
        loader.next_batch()
        n += 1
    return n / (time.perf_counter() - t0)


def cyclic_window(row, files) -> bool:
    """Whether ``row`` is a cyclic window of one of ``files`` (arrays)."""
    import numpy as np
    for x in files:
        for s in np.flatnonzero(x == row[0]):
            if np.array_equal(x[(s + np.arange(len(row))) % len(x)], row):
                return True
    return False


def loader_step(dev, trainer, data: str, ms_step: float) -> dict:
    """The input pipeline at the shipped exp (batch 16 x 65536, exp.num_workers
    workers, exp.seed): the native loader's batches a second beside the
    threaded loader's over the same ``VCTKTrain``; the host ms of
    ``Trainer.get_batch`` a step inside ``LOADER_STEPS`` train steps on the
    native loader and on a ``DeviceLoader`` over it, beside those steps' ms;
    the device batches bit for bit with the host batches they came from;
    every row a cyclic window of one of the training files."""
    import glob
    import torch
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.data.audio_io import read_wav
    from buddy_tpu_torch.data.loader import (DeviceLoader, PythonBatchLoader,
                                             make_train_loader)
    t0 = time.perf_counter()
    a = trainer.args
    batch, workers, seed = (int(a["exp"][k]) for k in ("batch_size", "num_workers", "seed"))
    length = int(a["dset"]["train"]["segment_length"])
    files = [read_wav(f)[0] for f in sorted(glob.glob(os.path.join(data, "*", "*.wav")))]

    def native():
        return make_train_loader(instantiate(a["dset"]["train"]), batch_size=batch,
                                 num_workers=workers, seed=seed)

    rates = {}
    for name, build in (("native", native),
                        ("threaded", lambda: PythonBatchLoader(instantiate(a["dset"]["train"]),
                                                               batch))):
        loader = build()
        try:
            rates[name] = batches_per_s(loader)
        finally:
            loader.close()

    # get_batch timed where the trainer calls it, at the head of each step: from
    # the second step on the host is ahead of the card, so a blocking upload
    # waits for the previous step's kernels
    host_ms, per_step, step_ms, rows_ok, equal = {}, {}, {}, True, True
    saved, get_batch = trainer.dset, trainer.get_batch
    try:
        for name in ("native", "DeviceLoader"):
            inner = RecordingLoader(native())
            trainer.dset = inner if name == "native" else DeviceLoader(inner, dev)
            times, got = [], []

            def timed():
                c0 = time.perf_counter()
                got.append(get_batch())
                times.append((time.perf_counter() - c0) * 1e3)
                return got[-1]

            trainer.get_batch = timed
            try:
                step_ms[name] = steps_ms(trainer, LOADER_STEPS)
                host_ms[name] = sorted(times)[LOADER_STEPS // 2]
                per_step[name] = times
                for x, h in zip(got, inner.batches):
                    equal = equal and torch.equal(x.cpu(), torch.from_numpy(h))
                    rows_ok = rows_ok and all(cyclic_window(r, files) for r in h)
            finally:
                del trainer.get_batch
                trainer.dset.close()
    finally:
        trainer.dset = saved
    if not (equal and rows_ok):
        raise AssertionError(f"input pipeline: device batches equal to the host's {equal}, "
                             f"every row a window of a training file {rows_ok}")
    out = {"batch": [batch, length], "workers": workers, "seed": seed,
           "native_batches_per_s": rates["native"], "threaded_batches_per_s": rates["threaded"],
           "get_batch_host_ms": host_ms["native"],
           "get_batch_host_ms_device_loader": host_ms["DeviceLoader"],
           "get_batch_host_ms_by_step": per_step,
           "train_step_ms": ms_step, "train_step_ms_native": step_ms["native"],
           "train_step_ms_device_loader": step_ms["DeviceLoader"],
           "device_batch_bit_for_bit": equal,
           "rows_are_windows": rows_ok, "seconds": time.perf_counter() - t0}
    log(f"input pipeline (batch {batch} x {length}, {workers} workers, seed {seed}): native loader "
        f"{rates['native']:.1f} batches/s, threaded loader {rates['threaded']:.1f}; "
        f"Trainer.get_batch host ms a step (median of {LOADER_STEPS} train steps) "
        f"{host_ms['native']:.3f} on the native loader, {host_ms['DeviceLoader']:.3f} on "
        f"DeviceLoader, beside {step_ms['native']:.1f} / {step_ms['DeviceLoader']:.1f} ms a "
        f"train step ({ms_step:.1f} on replayed batches); device batches bit for bit with the "
        f"host batches: "
        f"{equal}; rows cyclic windows of the training files: {rows_ok}; "
        f"{out['seconds']:.1f} s: " + json.dumps(out))
    return out


def training_clis(dev) -> None:
    """``python -m buddy_tpu_torch.training`` at the tiny network, then
    ``python -m buddy_tpu_torch.testing`` on the checkpoint it wrote."""
    import numpy as np
    t0 = time.perf_counter()
    model_dir = os.path.join(OUT_DIR, "train_runs", "cli")
    shutil.rmtree(model_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "buddy_tpu_torch.training", "--config-name=conf_VCTK.yaml",
           *TINY_TRAIN, f"dset.train.path={os.path.join(OUT_DIR, 'train')}",
           "dset.train.speakers_test=[]", "exp.batch_size=4", "exp.max_iters=2",
           "logging.save_interval=2", "logging.log_interval=1", "logging.heavy_log_interval=2",
           "tester.sampling_params.T=2", "tester.unconditional.num_samples=1",
           f"model_dir={model_dir}"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if run.returncode != 0 or "it=2 loss=" not in run.stdout or NATIVE_CLI not in run.stdout:
        raise AssertionError(f"training CLI exited with {run.returncode}:\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-4000:]}")
    loader_line = [ln.strip() for ln in run.stdout.splitlines() if ln.startswith("Loader:")]
    ckpt = os.path.join(model_dir, "VCTK_16k_4s_time-2.ckpt")
    if not os.path.exists(ckpt) or not os.path.exists(os.path.join(model_dir, "sample_0_it2.wav")):
        raise AssertionError(f"training CLI wrote {sorted(os.listdir(model_dir))}")
    data = os.path.join(OUT_DIR, "smoke_data")
    cmd = [sys.executable, "-m", "buddy_tpu_torch.testing", "--config-name=conf_VCTK.yaml",
           "tester=blind_dereverberation_BUDDy", f"tester.checkpoint={ckpt}", *TINY_TRAIN,
           "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={data}",
           'dset.test.speakers_test=["p226"]', "dset.test.num_examples=2",
           "tester.sampling_params.T=2", "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
           "tester.batched.use=True", "tester.batched.batch_size=2", "tester.overriden_name=cli",
           f"model_dir={model_dir}"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if run.returncode != 0 or "(it=2)" not in run.stdout:
        raise AssertionError(f"testing CLI on the trained checkpoint exited with "
                             f"{run.returncode}:\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    from buddy_tpu_torch.data.audio_io import read_wav
    rec = read_wav(os.path.join(model_dir, "cli", "blind_dereverberation", "VCTK_16k_4s_time",
                                "reconstructed", "utt0.wav"))[0]
    if len(rec) != 65536 or not np.isfinite(rec).all():
        raise AssertionError("testing CLI: reconstructed/utt0.wav is not 65536 finite samples")
    log(f"training CLI (python -m buddy_tpu_torch.training, nf=8, batch 4 x 65536, "
        f"max_iters=2; {loader_line[0]}): exit 0, checkpoint at it=2 and an in-training "
        f"sample; the testing CLI "
        f"(blind, 2 items) on that checkpoint: exit 0, finite WAVs; "
        f"{time.perf_counter() - t0:.1f} s")


def train_step_card_vs_cpu(dev, network=TINY_TRAIN, label: str = "nf=8") -> None:
    """One train step of a small network (``network``: the tiny one unless
    given) on the card (kernels) and on the CPU (plain versions): the same
    weights (seed), batch and draws (a CPU generator).  Gradients to 1e-4 of each leaf's peak (no less than 1e-6
    of the largest leaf's: the leaves whose sums cancel hold rounding);
    the moments accordingly; the parameters and EMA after Adam's first step
    lr g / (|g| + eps) to 1e-6 where |g| is 100 x above eps and the
    gradient's tolerance (the step is lr sign(g) there), to 2 lr elsewhere
    (the step's sign follows the last bits of g)."""
    import numpy as np
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    batch = load_wavs("clean", 2, 16384)[:, 0]
    over = [*network, "exp.batch_size=2", "exp.audio_len=16384", "exp.resume=False",
            "logging.log=False", f"model_dir={os.path.join(OUT_DIR, 'train_runs', 'small')}"]
    out = []
    for d in (dev, torch.device("cpu")):
        trainer, _ = build_trainer(d, over, loader=ReplayLoader([batch]),
                                   noise=NoiseSource(torch.Generator().manual_seed(6)))
        trainer.train_step()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                 for k, p in trainer.params.items()}
        out.append({"grads": grads, **{w: {k: v.detach().cpu() for k, v in
                                           getattr(trainer, w).items()}
                                       for w in ("params", "ema", "mu", "nu")},
                    "loss": float(trainer._metrics_acc["loss"])})
    card, cpu = out
    top = max(float(g.abs().max()) for g in cpu["grads"].values())
    worst = {"grads": 0.0, "mu": 0.0, "nu": 0.0, "params": 0.0, "ema": 0.0}
    for k, g in cpu["grads"].items():
        peak = float(g.abs().max())
        tol = max(1e-4 * peak, 1e-6 * top)
        checks = {"grads": (card["grads"][k], g, tol),
                  "mu": (card["mu"][k], cpu["mu"][k], 0.1 * tol),
                  "nu": (card["nu"][k], cpu["nu"][k], 1e-3 * (2 * peak * tol + tol * tol))}
        for what, (a, b, t) in checks.items():
            e = max_err(a, b)
            worst[what] = max(worst[what], e / t if t else 0.0)
            check(f"card vs CPU train step {what} {k}", e, t)
        far = g.abs() > 100 * max(1e-8, tol)
        for what in ("params", "ema"):
            d = (card[what][k] - cpu[what][k]).abs()
            if (d[far] > 1e-6).any() or (d[~far] > 2e-4).any():
                raise AssertionError(f"card vs CPU train step {what} {k}: {float(d.max()):.3e}")
            worst[what] = max(worst[what], float(d.max()))
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check("card vs CPU train step loss (relative)", rel, 1e-5)
    log(f"train step card vs CPU ({label}, batch 2 x 16384, same weights, batch and draws): loss "
        f"{card['loss']:.6f} / {cpu['loss']:.6f}; largest error / tolerance of gradients, mu, "
        f"nu {[round(worst[w], 3) for w in ('grads', 'mu', 'nu')]}, largest parameter and EMA "
        f"differences {worst['params']:.2e} / {worst['ema']:.2e}")


# ---------------------------------------------------------------------------
# phase 8: the serving profile's fused up-convolutions (K8) and the int8 U-Net (K10)
# ---------------------------------------------------------------------------
PEAK_INT8_OPS = 1979e12         # H100 SXM int8 tensor cores, dense
INT8_STEPS = 2                  # diffusion steps of the serving and int8 runs
K10_KERNELS = ("qc_absmax_kernel", "qc_quantize_kernel", "qc_weight_kernel", "qc_conv_kernel",
               "qc_conv_sm90_kernel")
SERVING = ["network.compute_dtype=bfloat16", "network.fuse_resample=true"]
FULL = "tester.posterior_sampling.guidance_jacobian=full"
IDENTITY = "tester.posterior_sampling.guidance_jacobian=identity"   # the fast serving profile
INT8_STATIC = SERVING + ["network.quantize_int8=true", "network.quantize_static=true"]
INT8_DYNAMIC = SERVING + ["network.quantize_int8=true", "network.quantize_accum=int32",
                          "network.quantize_bwd=true"]
# phase 8's runs through the tester: label, network overrides, guidance
SERVING_RUNS = (("serving", SERVING, FULL), ("serving_identity", SERVING, IDENTITY),
                ("int8_static", INT8_STATIC, FULL), ("int8_dynamic", INT8_DYNAMIC, FULL))


def int8_conv_shapes(dev) -> list:
    """Every distinct convolution of the full-width int8 U-Net (nf=128,
    ch_mult [1,2,2,2], bf16, fused up-blocks) at B=8 x 65536: (kind, C_in,
    C_out, H, W, roles), recorded by forward hooks over one forward, with
    the bwd_quant adjoints of the unfused kinds (C_in and C_out swapped)."""
    import torch
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.models import layers as L
    args = compose("conf_VCTK.yaml", INT8_DYNAMIC)
    net = instantiate(args["network"], device=dev, seed=0).requires_grad_(False)
    seen = {}

    def hook(m, inp, out):
        x = inp[0]
        seen.setdefault((m.kind, x.shape[1], m.weight.shape[0], x.shape[2], x.shape[3]),
                        set()).add("forward")

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (L.QConv, L.FusedUpConv))]
    with torch.no_grad():
        net(torch.randn((8, 1, 65536), device=dev) * 0.05, torch.zeros(8, device=dev))
    for h in hooks:
        h.remove()
    for (kind, ci, co, h, w) in list(seen):
        if not kind.startswith("up"):
            seen.setdefault((kind, co, ci, h, w), set()).add("adjoint")
    del net
    torch.cuda.empty_cache()
    return [k + (sorted(r),) for k, r in sorted(seen.items(), key=lambda kv: (-kv[0][3], kv[0]))]


def int_mm_operands(xq, wq, kind):
    """The int32 sums of a convolution as GEMMs for ``torch._int_mm``, one a
    phase: A (M, taps * C_in) row-major, the input shifted by each tap of
    the phase (an im2col matrix; the 1x1 kinds' A is x_q itself) and B
    (taps * C_in, C_out) column-major; A @ B is the phase's sums
    (B, H, W, C_out)."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.ops import qconv as Q
    phases, ntaps, _, taps = Q.tap_table(kind)
    n, h, w, c = xq.shape
    out = []
    for ph in range(phases):
        tp = taps[ph * ntaps:(ph + 1) * ntaps]
        if ntaps == 1:
            a = xq.reshape(n * h * w, c)
        else:
            xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
            a = torch.stack([xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy, dx, _ in tp],
                            dim=3).reshape(n * h * w, ntaps * c)
        b = wq[[t for _, _, t in tp]].permute(1, 0, 2).reshape(wq.shape[1], ntaps * c)
        out.append((a, b.t()))
    return out


def k10_checks(dev) -> dict:
    """K10 at every convolution shape of the int8 U-Net, bf16, B=8: the
    quantized activations (dynamic and per channel) and weights (plain and
    folded) bit for bit against the plain versions; then each route of the
    convolution (``qc_conv_sm90_kernel``, the shapes' own, and
    ``qc_conv_kernel``, forced): the int32 sums against the float64 plain
    version, the bf16 and the float32 output dequantized with and without
    bias and with the folded per-channel weights, each bit for bit, and two
    calls bit for bit;
    then each route's device us a launch after an L2 flush (the sm90 route
    also warm), the bound, the wrapper's and the plain version's ms, and as
    yardsticks the bf16 cuDNN convolution of the same shape (not the same
    function: PyTorch has no int8 convolution on CUDA), for the fused kinds
    the unfused upsample + bf16 conv, and ``torch._int_mm`` on the same int8
    operands (the 1x1 kinds: x_q itself, the same sums in one call; the 3x3
    kinds: an im2col matrix built outside the timed window; the fused 3x3:
    four calls, one a phase; the fused 1x1's sums once, not written four
    times); K8's float route at the up-block shapes against the unfused
    pair."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.models import layers as L
    from buddy_tpu_torch.ops import qconv as Q, resample as R
    shapes = int8_conv_shapes(dev)
    gen = torch.Generator().manual_seed(10)
    rows, k8_rows, rep = [], [], None
    cl, bf16 = torch.channels_last, torch.bfloat16
    kernel = {"sm90": "qc_conv_sm90_kernel", "mma": "qc_conv_kernel"}
    for kind, cin, cout, h, w, roles in shapes:
        k = 3 if kind.endswith("3x3") else 1
        x = torch.randn((8, cin, h, w), generator=gen).to(dev, bf16).contiguous(memory_format=cl)
        wt = (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        wd = Q._derived(wt, kind).contiguous()
        what = f"K10 {kind} {cin}->{cout} at {h}x{w}"
        with torch.no_grad():
            xq, sx = Q.quantize_act(x)
            xq0, sx0 = Q.quantize_act_plain(x)
            if not (torch.equal(xq, xq0) and torch.equal(sx, sx0)):
                raise AssertionError(f"{what}: dynamic activation quantization differs")
            sxc = Q.static_scale(x.abs().amax(dim=(0, 2, 3)).float() * 0.8)
            xqc = Q.quantize_act(x, sxc)[0]
            if not torch.equal(xqc, Q.quantize_act_plain(x, sxc)[0]):
                raise AssertionError(f"{what}: per-channel activation quantization differs")
            wq, sw = Q.quantize_weight(wd)
            wqc, swc = Q.quantize_weight(wd, sxc)
            for got, want in zip((wq, sw, wqc, swc),
                                 Q.quantize_weight_plain(wd) + Q.quantize_weight_plain(wd, sxc)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: weight quantization differs")
            acc0 = Q.int8_conv_plain(xq, wq, kind)
            accc = Q.int8_conv_plain(xqc, wqc, kind)
            f32 = torch.float32
            want = {"with bias": Q.dequant_plain(acc0, bf16, sx * sw, b),
                    "without bias": Q.dequant_plain(acc0, bf16, sx * sw),
                    "folded per-channel weights": Q.dequant_plain(accc, bf16, swc, b),
                    "float32 with bias": Q.dequant_plain(acc0, f32, sx * sw, b),
                    "float32 without bias": Q.dequant_plain(acc0, f32, sx * sw),
                    "float32 folded per-channel weights": Q.dequant_plain(accc, f32, swc, b)}
            del accc
            for route in Q.ROUTES:
                acc = Q.int8_conv(xq, wq, sw, kind, raw=True, route=route)
                if not torch.equal(acc, acc0):
                    raise AssertionError(f"{what}, {route} route: int32 sums differ from the "
                                         f"float64 plain version "
                                         f"({int((acc != acc0).sum())} elements)")
                got = {"with bias": Q.int8_conv(xq, wq, sw, kind, s_x=sx, bias=b, route=route),
                       "without bias": Q.int8_conv(xq, wq, sw, kind, s_x=sx, route=route),
                       "folded per-channel weights": Q.int8_conv(xqc, wqc, swc, kind, bias=b,
                                                                 route=route),
                       "float32 with bias": Q.int8_conv(xq, wq, sw, kind, out_dtype=f32, s_x=sx,
                                                        bias=b, route=route),
                       "float32 without bias": Q.int8_conv(xq, wq, sw, kind, out_dtype=f32,
                                                           s_x=sx, route=route),
                       "float32 folded per-channel weights": Q.int8_conv(
                           xqc, wqc, swc, kind, out_dtype=f32, bias=b, route=route)}
                for form, y in got.items():
                    if not torch.equal(y.permute(0, 2, 3, 1), want[form]):
                        raise AssertionError(f"{what}, {route} route: dequantized output "
                                             f"{form} differs")
                if not torch.equal(got["with bias"],
                                   Q.int8_conv(xq, wq, sw, kind, s_x=sx, bias=b, route=route)):
                    raise AssertionError(f"{what}, {route} route: two calls differ")
                del acc, got
            del want
            calls = {r: (lambda r=r: Q.int8_conv(xq, wq, sw, kind, out_dtype=bf16, s_x=sx,
                                                 bias=b, route=r)) for r in Q.ROUTES}
            us = {r: device_us_per_launch(calls[r], [kernel[r]], reps=5)[kernel[r]]
                  for r in Q.ROUTES}
            us_warm = device_us_per_launch(calls["sm90"], [kernel["sm90"]], reps=5,
                                           cold=False)[kernel["sm90"]]
            ms = {r: cuda_ms(calls[r], reps=5, warmup=1) for r in Q.ROUTES}
            plain_ms = cuda_ms(lambda: Q.dequant_plain(Q.int8_conv_plain(xq, wq, kind),
                                                       bf16, sx * sw, b),
                               reps=1, warmup=0)
            q_ms = cuda_ms(lambda: Q.quantize_act(x), reps=5, warmup=1)
            mm = int_mm_operands(xq, wq, kind)
            mm_eq = torch.equal(torch._int_mm(*mm[0]).reshape(acc0.shape[0], h, w, cout),
                                acc0[:, 0::2, 0::2] if kind.startswith("up") else acc0)
            mm_ms = cuda_ms(lambda: [torch._int_mm(a_, b_) for a_, b_ in mm], reps=5, warmup=1)
            del mm, acc0
            wb, bb = wt.to(bf16), b.to(bf16)
            if kind.startswith("up"):
                fused = R.up2_conv3x3 if k == 3 else R.up2_conv1x1
                yard = cuda_ms(lambda: fused(x, wt, b), reps=5, warmup=1)
                naive = cuda_ms(lambda: F.conv2d(L.naive_upsample_2d(x), wb, bb, padding=k // 2),
                                reps=5, warmup=1)
                yf, yn = fused(x, wt, b).float(), F.conv2d(L.naive_upsample_2d(x), wb, bb,
                                                           padding=k // 2).float()
                err, tol = max_err(yf, yn), 2.0 ** -6 * float(yn.abs().max())
                check(f"K8 float route {kind} {cin}->{cout} at {h}x{w} vs upsample + conv",
                      err, tol)
                k8_rows.append([kind, cin, cout, h, w, err, tol, round(yard, 4), round(naive, 4)])
                del yf, yn
            else:
                yard = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=k // 2), reps=5, warmup=1)
                naive = None
        up = kind.startswith("up")
        macs = 8 * h * w * cin * cout * {"3x3": 9, "1x1": 1, "up3x3": 16, "up1x1": 1}[kind]
        n_out = 8 * h * w * cout * (4 if up else 1)
        bound = bound_ms(8 * h * w * cin + wq.numel() + 2 * n_out + 8 * cout, 2.0 * macs,
                         PEAK_INT8_OPS)
        qbound = bound_ms(8 * h * w * cin * 3, 0.0)
        row = [kind, cin, cout, h, w, "+".join(roles), round(us["sm90"], 2), round(us_warm, 2),
               round(us["mma"], 2), round(bound[0] * 1e3, 2), bound[1], round(ms["sm90"], 4),
               round(ms["mma"], 4), round(plain_ms, 3), round(q_ms, 4), round(yard, 4),
               None if naive is None else round(naive, 4), round(mm_ms, 4), mm_eq]
        rows.append(row)
        log("K10 " + json.dumps(row))
        if rep is None and kind == "3x3" and cin == 128 and cout == 128 and h == 256:
            rep = dict(us=us, us_warm=us_warm, ms=ms, plain_ms=plain_ms, bound=bound, yard=yard,
                       mm_ms=mm_ms, q_ms=q_ms, qbound=qbound, shape=[8, cin, h, w, cout], x=x,
                       wd=wd)
        del x, xq, xq0, xqc, wq, wqc, wd
        torch.cuda.empty_cache()
    # the representative shape (the top level's 3x3): the activation and
    # weight quantization's own device times
    with torch.no_grad():
        x, wd = rep["x"], rep["wd"]
        q_us = device_us_per_launch(lambda: Q.quantize_act(x),
                                    ["qc_absmax_kernel", "qc_quantize_kernel"], reps=5)
        w_us = device_us_per_launch(lambda: Q.quantize_weight(wd), ["qc_weight_kernel"], reps=5)
        wq_ms = cuda_ms(lambda: Q.quantize_weight(wd), reps=5)
        wq_plain = cuda_ms(lambda: Q.quantize_weight_plain(wd), reps=5)
        qa_plain = cuda_ms(lambda: Q.quantize_act_plain(x), reps=3)
    log(f"K10 at {len(rows)} convolution shapes of the int8 U-Net (B=8, bf16): activations, "
        f"weights, and each route's int32 sums and dequantized outputs (bf16 and float32, with "
        f"and without bias, folded per-channel weights) bit for bit against the plain versions, "
        f"two calls bit "
        f"for bit; rows [kind, C_in, C_out, H, W, roles, sm90 device us cold, sm90 device us "
        f"warm, mma device us cold, bound us, bound by, sm90 wrapper ms, mma wrapper ms, plain "
        f"ms, quantize_act ms, yardstick ms (bf16 cuDNN conv; fused kinds: K8's float route), "
        f"unfused upsample + bf16 conv ms, torch._int_mm ms (3x3: over an im2col matrix; fused "
        f"3x3: four calls), _int_mm's sums equal]")
    log("K8 float route (one cuDNN transposed conv with the derived kernel) against upsample + "
        "bf16 conv at the up-blocks [kind, C_in, C_out, H, W, max abs err, tolerance 2^-6 of the "
        "peak, fused ms, unfused ms]: " + json.dumps(k8_rows))
    shape = rep["shape"]
    library = {"library": "torch._int_mm over an im2col matrix (built outside the timed window)",
               "yardstick_bf16_conv_ms": rep["yard"],
               "yardstick": "a bf16 cuDNN conv of the same shape, not the same function"}
    entries = {
        "int8_conv": dict(err=0.0, tol=0.0, times=(rep["ms"]["mma"], rep["plain_ms"],
                                                   rep["mm_ms"]),
                          bound=rep["bound"], shape=shape,
                          extra={"device_us": rep["us"]["mma"], "kernel": "qc_conv_kernel",
                                 "route": "mma.sync, the shapes the sm90 rule does not take; "
                                          "forced at the 43 shapes", **library}),
        "int8_conv_sm90": dict(err=0.0, tol=0.0, times=(rep["ms"]["sm90"], rep["plain_ms"],
                                                        rep["mm_ms"]),
                               bound=rep["bound"], shape=shape,
                               extra={"device_us": rep["us"]["sm90"],
                                      "device_us_warm": rep["us_warm"],
                                      "kernel": "qc_conv_sm90_kernel", **library,
                                      "shapes": rows}),
        "quantize_act": dict(err=0.0, tol=0.0, times=(rep["q_ms"], qa_plain, None),
                             bound=rep["qbound"], shape=shape[:4],
                             extra={"device_us": q_us}),
        "quantize_weight": dict(err=0.0, tol=0.0, times=(wq_ms, wq_plain, None),
                                bound=bound_ms(5 * wd.numel(), 0.0), shape=list(wd.shape),
                                extra={"device_us": w_us}),
    }
    del rep
    torch.cuda.empty_cache()
    return entries


def profile_run(run, n_steps: int, names, label: str) -> dict:
    """One run under torch.profiler: device ms a step of the kernels named
    (by function name) and of all kernels, device launches a step, and the
    device's idle share of the wall; the per-kernel table goes to
    chiprun_out/profile_<label>.txt."""
    import torch
    with device_profile(cpu=True) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(kernel_name(e.key), e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        for name, ms, count in sorted(rows, key=lambda r: -r[1]):
            f.write(f"{ms:12.3f} ms {count:8d}x  {name}\n")
    ours = {k: [0.0, 0] for k in names}
    for name, ms, count in rows:
        if name in ours:
            ours[name][0] += ms / n_steps
            ours[name][1] += count
    busy = device_busy_ms(prof)
    return {"device_ms_per_step": round(sum(r[1] for r in rows) / n_steps, 3),
            "launches_per_step": round(sum(r[2] for r in rows) / n_steps, 1),
            "idle_share": round(1 - busy / wall, 4),
            "kernels_ms_per_step": {k: round(v[0], 3) for k, v in ours.items()},
            "kernels_launches": {k: v[1] for k, v in ours.items()}}


def calibration_inputs(dev, edm, seed: int = 7):
    """bench.py's calibration recipe: a 0.05-std signal, 8 sigmas on a
    geometric grid from sigma_max to sigma_min, the network's inputs cin * x
    and cnoise, from a seed."""
    import numpy as np
    import torch
    gen = torch.Generator().manual_seed(seed)
    clean = torch.randn((1, 1, 65536), generator=gen) * 0.05
    xs, cns = [], []
    for s in np.geomspace(edm.sigma_max, edm.sigma_min, 8):
        sig = torch.full((1,), float(s))
        xn = clean + float(s) * torch.randn(clean.shape, generator=gen)
        xs.append((edm.cin(sig)[:, None, None] * xn).to(dev))
        cns.append(edm.cnoise(sig).to(dev))
    return xs, cns


def serving_and_int8_runs(dev, wrappers) -> dict:
    """``Tester.do_test()`` in blind mode at full width, B=8 x 65536, 10
    operator updates a step, T=2: the serving profile (``fuse_resample``)
    with full guidance, then the fast serving profile (the same with
    identity guidance), then int8 static after ``calibrate_quant`` and int8
    dynamic with int32 sums, ``quantize_bwd`` and fused up-blocks, both
    with full guidance.  Each: a network built anew (its convs quantize
    their weights in the run), the counts set to 0 just before, read just
    after, five WAV sets of 8 finite files, sampler ms a step; then one more
    run profiled.  The fast profile runs no U-Net backward: K1's backward
    launches 0 times (by its count and by the profile's kernel names), K1's
    forward and K2-K7 more than 0 each."""
    import torch
    from buddy_tpu_torch.models import layers as L
    from buddy_tpu_torch.ops import qconv as Q
    data = os.path.join(OUT_DIR, "smoke_data")
    common = [f"tester.sampling_params.T={INT8_STEPS}",
              "tester.posterior_sampling.blind_hp.op_updates_per_step=10",
              "tester.batched.use=True", "tester.batched.batch_size=8"]
    k10 = {"int8_conv_sm90": Q.int8_conv_sm90, "int8_conv_mma": Q.int8_conv_mma,
           "quantize_act": Q.quantize_act, "quantize_weight": Q.quantize_weight}
    out = {}
    for label, over, guidance in SERVING_RUNS:
        t0 = time.perf_counter()
        args, net, tester = build_tester(dev, "blind_dereverberation_BUDDy", data, label,
                                         common + over + [guidance])
        mode = guidance.split("=")[1]
        if tester.sampler.guidance_jacobian != mode:
            raise AssertionError(f"{label}: {tester.sampler.guidance_jacobian} guidance")
        if label == "int8_static":
            net.calibrate_quant(*calibration_inputs(dev, tester.diff_params))
            scales = [b for n, b in net.module.named_buffers() if n.endswith("a_scale")]
            if not scales or not all(bool((b > 0).any()) for b in scales):
                raise AssertionError("calibrate_quant left a scale at zero")
        sampler_s = []
        inner = tester.sampler.predict_conditional_batched

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = inner(*a, **k)
            torch.cuda.synchronize()
            sampler_s.append(time.perf_counter() - t)
            return r

        tester.sampler.predict_conditional_batched = timed

        def run():
            shutil.rmtree(os.path.join(args["model_dir"], label), ignore_errors=True)
            tester.do_test()
            torch.cuda.synchronize()

        for w in list(k10.values()) + list(wrappers.values()):
            w.launches = 0
        L.FusedUpConv.float_calls = 0
        run()
        launches = {k: w.launches for k, w in k10.items()}
        port = {k: w.launches for k, w in wrappers.items()}
        fused = L.FusedUpConv.float_calls
        check_outputs(tester, "blind_dereverberation", 8, 65536, blind=True)
        if label.startswith("serving") and fused == 0:
            raise AssertionError(f"{label}: no fused up-convolution ran")
        if label == "serving_identity":
            missing = [k for k, v in port.items() if v == 0 and k != "groupnorm_silu_bwd"]
            if missing or port["groupnorm_silu_bwd"] != 0:
                raise AssertionError(f"{label}: kernels not launched: {missing}; K1's backward "
                                     f"launched {port['groupnorm_silu_bwd']} times")
        elif label != "serving":
            # every conv of the full-width U-Net takes the sm90 route
            missing = [k for k, v in launches.items() if v == 0 and k != "int8_conv_mma"]
            if missing or launches["int8_conv_mma"] != 0:
                raise AssertionError(f"{label}: K10 wrappers not launched: {missing}; the mma "
                                     f"route launched {launches['int8_conv_mma']} times")
        names = _PORT_KERNELS if label == "serving_identity" else K10_KERNELS
        prof = profile_run(run, INT8_STEPS, names, label)
        seen = prof["kernels_launches"]
        if label == "serving_identity" and (
                seen["gn_bwd_stats_kernel"] or seen["gn_bwd_apply_kernel"]
                or not seen["gn_stats_kernel"] or not seen["gn_apply_kernel"]):
            raise AssertionError(f"{label}: the profile shows K1's kernels {seen}")
        if label.startswith("int8") and (seen["qc_conv_sm90_kernel"] == 0 or
                                         seen["qc_conv_kernel"] != 0):
            raise AssertionError(f"{label}: the profile shows qc_conv_sm90_kernel "
                                 f"{seen['qc_conv_sm90_kernel']} and qc_conv_kernel "
                                 f"{seen['qc_conv_kernel']} times (want > 0 and 0)")
        out[label] = {"seconds": round(time.perf_counter() - t0, 1),
                      "sampler_ms_per_step": round(sampler_s[0] / INT8_STEPS * 1e3, 1),
                      "k10_launches": launches,
                      "k10_launches_per_step": {k: round(v / INT8_STEPS, 1)
                                                for k, v in launches.items()},
                      "fused_float_calls": fused, **prof}
        if label == "serving_identity":
            out[label].update(port_launches=port, port_launches_per_step={
                k: round(v / INT8_STEPS, 1) for k, v in port.items()})
        log(f"{label} (Tester.do_test(), blind, B=8 x 65536, full width, bf16 body, "
            f"{' '.join(o.split('=')[0].split('.')[-1] + '=' + o.split('=')[1] for o in over[1:])},"
            f" T={INT8_STEPS}, {mode} guidance, 10 updates/step): 5 directories x 8 finite WAVs; "
            + json.dumps(out[label]))
        del net, tester
        torch.cuda.empty_cache()
    return out


def small_reference_int8(dev) -> dict:
    """The small blind program with ``fuse_resample`` and static int8, card
    (kernels) against CPU (plain versions): the same weights (seed), the
    scales calibrated on the card and copied to the CPU network, the same
    noise; float32 body.  Its convs (nf=16: 16-64 channels) miss the sm90
    rule: this is the run of K10's mma route, its launches counted from
    just before the card's sampler call (after calibration) to just after.
    Then the route ``int8_conv`` picks at each distinct conv shape of that
    run, held bit for bit against the plain versions."""
    import torch
    from buddy_tpu_torch.models import layers as L
    from buddy_tpu_torch.ops import qconv as Q
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    overrides = ["network.nf=16", "network.ch_mult=[1,2,2,2]", "tester.sampling_params.T=2",
                 "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
                 "tester.posterior_sampling.warm_initialization.mode=reverb_scaled",
                 "network.fuse_resample=true", "network.quantize_int8=true",
                 "network.quantize_static=true"]
    ys = torch.from_numpy(load_wavs("degraded", 2, 16384))
    outs, scales, shapes = [], None, set()
    for d in (dev, torch.device("cpu")):
        sampler, op = build_program(overrides, d)
        bundle = sampler.model
        if scales is None:
            xs, cns = calibration_inputs(d, sampler.diff_params)
            xs = [x[..., :16384] for x in xs]
            bundle.calibrate_quant(xs, cns)
            scales = {n: b.detach().cpu().clone() for n, b in bundle.module.named_buffers()
                      if n.endswith("a_scale")}
        else:
            with torch.no_grad():
                for n, b in bundle.module.named_buffers():
                    if n.endswith("a_scale"):
                        b.copy_(scales[n])
        params, H = op.reset_batched(2, noise=torch.randn(
            (2, op.length_rir), generator=torch.Generator().manual_seed(4)))
        hooks = []
        if d.type == "cuda":
            hooks = [m.register_forward_hook(
                lambda m, inp, out: shapes.add((m.kind, inp[0].shape[1], m.weight.shape[0],
                                                *inp[0].shape[2:], inp[0].shape[0])))
                for m in bundle.module.modules()
                if isinstance(m, L.QConv) or (isinstance(m, L.FusedUpConv) and m.quant)]
            Q.int8_conv_mma.launches = Q.int8_conv_sm90.launches = 0
        out = sampler.predict_conditional_batched(
            ys, op, blind=True, noise=NoiseSource(torch.Generator().manual_seed(5)),
            op_params_batch=params, H_batch=H)
        if d.type == "cuda":
            mma, sm90 = Q.int8_conv_mma.launches, Q.int8_conv_sm90.launches
            for h in hooks:
                h.remove()
        outs.append(out.detach().cpu())
    # the int8 kernels are bit for bit with the plain versions on equal
    # inputs; the float layers (cuDNN against the CPU's convolutions) differ
    # in their last bits and flip a few static roundings, which the
    # program's guidance carries (tests/test_torch_int8.py: 7.5e-3 of the
    # peak for one network between the two packages): 3e-2 of the peak
    err = max_err(outs[0], outs[1])
    tol = 3e-2 * float(outs[1].abs().max())
    check("small blind program, fused + static int8, card vs CPU", err, tol)
    if mma == 0 or sm90 != 0:
        raise AssertionError(f"small int8 program: the mma route launched {mma} times and the "
                             f"sm90 route {sm90} (want > 0 and 0)")
    log(f"small blind program with fuse_resample and static int8 (B=2, 16384 samples, T=2, "
        f"nf=16): card kernels vs CPU plain versions, max abs error {err:.3e} (tolerance "
        f"{tol:.3e}, {err / float(outs[1].abs().max()):.2e} of the peak); K10's mma route "
        f"launched {mma} times in the card's sampler call")
    checked = small_int8_conv_checks(dev, sorted(shapes))
    return {"launches": mma, "shapes": checked}


def small_int8_conv_checks(dev, shapes) -> list:
    """K10 at the conv shapes of the small int8 program (kind, C_in, C_out,
    H, W, B), through the route ``int8_conv`` picks there (mma: 16-64
    channels, K padded in shared memory): the int32 sums against the float64
    plain version, the float32 (the program's dtype) and bf16 outputs
    dequantized with and without bias and with folded per-channel weights,
    each bit for bit, and two calls bit for bit."""
    import torch
    from buddy_tpu_torch.ops import qconv as Q
    gen = torch.Generator().manual_seed(12)
    f32, bf16 = torch.float32, torch.bfloat16
    for kind, cin, cout, h, w, n in shapes:
        what = f"K10 {kind} {cin}->{cout} at {n}x{h}x{w} (small int8 program)"
        if Q.conv_route(cin, cout) != "mma":
            raise AssertionError(f"{what}: takes the {Q.conv_route(cin, cout)} route")
        k = 3 if kind.endswith("3x3") else 1
        x = torch.randn((n, cin, h, w), generator=gen).to(dev).contiguous(
            memory_format=torch.channels_last)
        wt = (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        wd = Q._derived(wt, kind).contiguous()
        with torch.no_grad():
            xq, sx = Q.quantize_act(x)
            sxc = Q.static_scale(x.abs().amax(dim=(0, 2, 3)) * 0.8)
            xqc = Q.quantize_act(x, sxc)[0]
            wq, sw = Q.quantize_weight(wd)
            wqc, swc = Q.quantize_weight(wd, sxc)
            acc0, accc = Q.int8_conv_plain(xq, wq, kind), Q.int8_conv_plain(xqc, wqc, kind)
            if not torch.equal(Q.int8_conv(xq, wq, sw, kind, raw=True), acc0):
                raise AssertionError(f"{what}: int32 sums differ from the float64 plain version")
            for dt in (f32, bf16):
                forms = {"with bias": ((xq, wq, sw), dict(s_x=sx, bias=b), (acc0, sx * sw, b)),
                         "without bias": ((xq, wq, sw), dict(s_x=sx), (acc0, sx * sw, None)),
                         "folded per-channel weights": ((xqc, wqc, swc), dict(bias=b),
                                                        (accc, swc, b))}
                for form, (ops, kw, (acc, scale, bias)) in forms.items():
                    y = Q.int8_conv(*ops, kind, out_dtype=dt, **kw)
                    if not torch.equal(y.permute(0, 2, 3, 1),
                                       Q.dequant_plain(acc, dt, scale, bias)):
                        raise AssertionError(f"{what}: {dt} output {form} differs")
                    if not torch.equal(y, Q.int8_conv(*ops, kind, out_dtype=dt, **kw)):
                        raise AssertionError(f"{what}: two calls differ")
    rows = [list(s) for s in shapes]
    log(f"K10 at the {len(rows)} conv shapes of the small int8 program [kind, C_in, C_out, H, W, "
        f"B], the route int8_conv picks (mma): int32 sums, float32 and bf16 outputs (with and "
        f"without bias, folded per-channel weights) bit for bit against the plain versions, two "
        f"calls bit for bit: " + json.dumps(rows))
    return rows


# ---------------------------------------------------------------------------
# phase 9: the rest of NCSN++'s configuration space at full width
# ---------------------------------------------------------------------------
# (a) FIR resampling with both residual skip pyramids, float32 body (the JAX
# package has no FIR path under bfloat16); (b) the ddpm ResBlock without
# pyramids, trained with and without remat
FIR_NET = ["network.fir=true", "network.progressive=residual",
           "network.progressive_input=residual"]
DDPM_NET = ["network.resblock_type=ddpm", "network.progressive=none",
            "network.progressive_input=none"]
FIR_STEPS = 2                   # diffusion steps of run (a)
REMAT_STEPS = 3                 # train steps of run (b), each way
SMALL_NET = ["network.nf=16", "network.ch_mult=[1,2,2,2]", "network.num_res_blocks=1"]
FIR_TOP = {"up": (8, 256, 128, 264), "down": (8, 128, 256, 528)}   # run (a)'s top blocks' inputs
K11_KERNEL = "upfirdn_kernel"   # csrc/upfirdn.cu's kernel (two instances: float4, float)
# the kernels line's K11 rows: the U-Net's up and down passes, forward and
# input vjp, at run (a)'s top blocks
K11_ROWS = {"upfirdn_up": ("top up-block", 0), "upfirdn_up_vjp": ("top up-block", 1),
            "upfirdn_down": ("top down-block", 0), "upfirdn_down_vjp": ("top down-block", 1)}


def fir_ops(prof) -> list:
    """The profiled FIR convolutions of the library route K11 replaced: the
    ``aten::convolution`` / ``aten::convolution_backward`` ops with a
    depthwise 4 x 4 weight (C, 1, 4, 4: the shipped fir_kernel's), which no
    other convolution of the U-Net has (needs ``record_shapes``); run (a)
    must show none."""
    def fir(e):
        return e.name in ("aten::convolution", "aten::convolution_backward") and any(
            len(sh) == 4 and sh[1] == 1 and sh[2] == sh[3] == 4 for sh in e.input_shapes)
    return [e for e in prof.events() if fir(e)]


def k11_profile_ms(rows) -> dict:
    """{K11's kernel (with its template argument): [device ms, launches]}
    from a profile's (key, ms, count) rows."""
    found = {}
    for key, ms, count in rows:
        if K11_KERNEL in key:
            name = key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
            f = found.setdefault(name, [0.0, 0])
            f[0] += ms
            f[1] += count
    return found


def k11_kind(direction: str, ay) -> str:
    """The kernels-line row of a K11 launch: the up or the down pass of the
    U-Net, forward or input vjp (the up pass's vjp is a down-type launch)."""
    up_type = ay.up > 1
    if direction == "upfirdn2d":
        return "upfirdn_up" if up_type else "upfirdn_down"
    return "upfirdn_down_vjp" if up_type else "upfirdn_up_vjp"


def k11_us(call, counter, what: str, cold: bool = True) -> float:
    """Device us of the one K11 launch of call(): a call must add one to the
    wrapper's count (``counter``) and the profiler must show no kernel but
    K11 in 20 calls (after an L2 flush each when ``cold``); the time comes
    from a window that holds all 20 launches, else (the profiler loses some
    of a window's launches late in a run, as at K1's float32 shapes) from
    CUDA events over the same calls, logged (``call_us``)."""
    n = counter.launches
    call()
    if counter.launches - n != 1:
        raise AssertionError(f"{what}: {counter.launches - n} K11 launches in one call")
    for _ in range(PROFILE_TRIES):
        found = profile_device_us(call, cold=cold)
        if set(found) - {K11_KERNEL}:
            raise AssertionError(f"{what}: a call runs {found}, not K11 alone")
        if found.get(K11_KERNEL, [0, 0])[1] == 20:
            return found[K11_KERNEL][0] / 20
        _retake(f"{what}: {found.get(K11_KERNEL, [0, 0])[1]} launches of {K11_KERNEL} in 20 "
                f"calls")
    return call_us({}, call, cold=cold)


def fir_case(dev, label: str, x, kern, args: dict, gen, one_d: bool = False) -> dict:
    """K11 at one geometry: ``upfirdn2d`` (``upfirdn1d`` when ``one_d``) and
    its input vjp through autograd against the zero-stuffing definition and
    its autograd vjp on the same CUDA tensors (1e-5 of the peak), two calls
    of each direction bit for bit, the output in the input's memory format;
    each direction's device us a launch cold (after an L2 flush) and warm
    (``k11_us``: one K11 launch a call and no other kernel), wrapper
    ms (cold, CUDA events), the plain version's ms (the definition; for the
    vjp the definition of the adjoint), the byte bound (input read once,
    output written once; the operations, the taps that meet a nonzero
    input, are far below it) and as ``library`` the depthwise route the
    port ran before K11 (``upfirdn_conv``: one library convolution)."""
    import torch
    from buddy_tpu_torch.ops import resample as R
    up, down, pad = args.get("up", 1), args.get("down", 1), args["pad"]
    fn, plain = (R.upfirdn1d, R.upfirdn1d_plain) if one_d else (R.upfirdn2d, R.upfirdn2d_plain)
    x4, k2 = (x.unsqueeze(2), kern.view(1, -1)) if one_d else (x, kern)
    ay = R.make_axis(1, 1, 1, 1, (0, 0)) if one_d else \
        R.make_axis(x4.shape[2], k2.shape[0], up, down, pad)
    ax = R.make_axis(x4.shape[3], k2.shape[1], up, down, pad)
    by, bx = R.adjoint_axis(ay), R.adjoint_axis(ax)
    kd, k2d, kfd = kern.to(dev), k2.to(dev), k2.flip(0, 1).to(dev)   # K11 takes kern on the host
    fmt = torch.channels_last if x4.is_contiguous(memory_format=torch.channels_last) and \
        not x4.is_contiguous() else torch.contiguous_format
    xr = x.detach().requires_grad_(True)
    y = fn(xr, kern, **args)
    g4 = torch.randn((x4.shape[0], x4.shape[1], ay.out, ax.out), generator=gen).to(dev)
    g4 = g4.contiguous(memory_format=fmt)
    g = g4.squeeze(2) if one_d else g4
    (dx,) = torch.autograd.grad(y, xr, g)
    xp = x.detach().requires_grad_(True)
    yp = plain(xp, kd, **args)
    (dxp,) = torch.autograd.grad(yp, xp, g)
    y, yp = y.detach(), yp.detach()
    tol_y, tol_dx = 1e-5 * float(yp.abs().max()), 1e-5 * float(dxp.abs().max())
    e_y, e_dx = max_err(y, yp), max_err(dx, dxp)
    check(f"K11 {label} forward", e_y, tol_y)
    check(f"K11 {label} input vjp", e_dx, tol_dx)
    fwd = lambda: fn(x, kern, **args)
    vjp = lambda: R.upfirdn2d_backward(g4, k2, ay, ax)
    with torch.no_grad():
        if not torch.equal(y, fwd()) or not torch.equal(dx, vjp().squeeze(2) if one_d else vjp()):
            raise AssertionError(f"K11 {label}: two calls differ")
        if not y.is_contiguous(memory_format=fmt) or not dx.is_contiguous(memory_format=fmt):
            raise AssertionError(f"K11 {label}: the output left the input's memory format")
        del yp, dxp, xp, xr
        out = {"x": list(x.shape), "y": list(y.shape), "up": up, "down": down, "pad": list(pad),
               "taps": list(k2.shape), "channels_last": fmt == torch.channels_last,
               "err": [e_y, e_dx], "tol": [tol_y, tol_dx]}
        n_bytes = 4 * (x.numel() + y.numel())
        del y, dx
        taps = -(-k2.shape[0] // up) * -(-k2.shape[1] // up)
        for what, call, counter, pl, lib, n_out, n_taps in (
                ("fwd", fwd, R.upfirdn2d, lambda: plain(x, kd, **args),
                 lambda: R.upfirdn_conv(x4, k2d, ay, ax), ay.out * ax.out, taps),
                ("vjp", vjp, R.upfirdn2d_backward, lambda: R.upfirdn_plain(g4, kfd, by, bx),
                 lambda: R.upfirdn_conv(g4, kfd, by, bx), by.out * bx.out,
                 -(-k2.shape[0] // down) * -(-k2.shape[1] // down))):
            out[what] = {
                "device_us": k11_us(call, counter, f"K11 {label} {what}"),
                "device_us_warm": k11_us(call, counter, f"K11 {label} {what} warm", cold=False),
                "ms": cuda_ms(call, reps=10), "plain_ms": cuda_ms(pl, reps=10),
                "library_ms": cuda_ms(lib, reps=10),
                "bound": bound_ms(n_bytes, 2.0 * n_taps * n_out * x4.shape[0] * x4.shape[1])}
    torch.cuda.empty_cache()
    return out


def fir_op_checks(dev, record: dict) -> dict:
    """K11 (``fir_case``) at the top up- and down-block shapes of run (a)
    (float32, channels_last, the shipped kernel), at every other distinct
    FIR call shape run (a) recorded (``upfirdn2d.record``: its forward
    launches), and at the generic cases at small sizes: up 3 / down 2, a
    negative pad, the asymmetric (1, 2, 4, 1) kernel, a non-square 3 x 5
    kernel, C = 1 and 3 (the scalar path) in NCHW and channels_last, and
    ``upfirdn1d`` up and down."""
    import torch
    from buddy_tpu_torch.ops import resample as R
    gen = torch.Generator().manual_seed(13)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    shipped_up, shipped_down = R.fir_kernel((1, 3, 3, 1), 4.0), R.fir_kernel((1, 3, 3, 1), 1.0)
    cases = {"top up-block": (cl(rnd(*FIR_TOP["up"])), shipped_up, dict(up=2, pad=(2, 1))),
             "top down-block": (cl(rnd(*FIR_TOP["down"])), shipped_down,
                                dict(down=2, pad=(1, 1)))}
    seen = {(tuple(v[0].shape), True, tuple(v[1].flatten().tolist()), v[2].get("up", 1))
            for v in cases.values()}
    for (direction, shape, is_cl, ay, ax, taps), _ in sorted(record.items(), key=str):
        if direction != "upfirdn2d" or (shape, is_cl, taps, ay.up) in seen:
            continue
        seen.add((shape, is_cl, taps, ay.up))
        x = rnd(*shape)
        cases[f"run (a) {'up' if ay.up > 1 else 'down'} {list(shape)}"] = (
            cl(x) if is_cl else x, torch.tensor(taps).view(ay.taps, ax.taps),
            dict(up=ay.up, down=ay.down, pad=(ay.pad0, ay.pad1)))
    asym = R.fir_kernel((1, 2, 4, 1), 1.0)
    k35 = torch.rand((3, 5), generator=gen) + 0.1
    k35 /= k35.sum()
    cases.update({
        "up 3 down 2, C=3 NCHW": (rnd(2, 3, 37, 45), asym, dict(up=3, down=2, pad=(0, 2))),
        "up 2 pad (5,-1), C=16 channels_last": (cl(rnd(2, 16, 37, 45)), asym,
                                                dict(up=2, pad=(5, -1))),
        "3x5 up 2, C=16 channels_last": (cl(rnd(2, 16, 37, 45)), k35, dict(up=2, pad=(2, 1))),
        "3x5 down 2, C=16 channels_last": (cl(rnd(2, 16, 37, 45)), k35, dict(down=2, pad=(1, 1))),
        "C=1 down 2": (rnd(8, 1, 256, 528), asym, dict(down=2, pad=(1, 1))),
        "C=3 channels_last up 2": (cl(rnd(8, 3, 128, 264)), asym, dict(up=2, pad=(2, 1)))})
    out = {}
    for label, (x, kern, args) in cases.items():
        out[label] = fir_case(dev, label, x, kern, args, gen)
        del x
    k1d = torch.tensor([1.0, 2.0, 4.0, 1.0]) / 4
    for label, args in (("upfirdn1d up 2, (8,16,16384)", dict(up=2, pad=(2, 1))),
                        ("upfirdn1d down 2, (8,16,16384)", dict(down=2, pad=(1, 1)))):
        out[label] = fir_case(dev, label, rnd(8, 16, 16384), k1d, args, gen, one_d=True)
    with open(os.path.join(OUT_DIR, "fir_k11.json"), "w") as f:
        json.dump(out, f, indent=1)
    summary = {k: {"x": v["x"], "device_us": [round(v["fwd"]["device_us"], 2),
                                              round(v["vjp"]["device_us"], 2)],
                   "bound_us": [round(1e3 * v["fwd"]["bound"][0], 2),
                                round(1e3 * v["vjp"]["bound"][0], 2)],
                   "library_ms": [round(v["fwd"]["library_ms"], 4),
                                  round(v["vjp"]["library_ms"], 4)],
                   "err_of_tol": [round(v["err"][0] / v["tol"][0], 3),
                                  round(v["err"][1] / v["tol"][1], 3)]}
               for k, v in out.items()}
    log(f"kernel K11 (FIR, csrc/upfirdn.cu): forward and input vjp within 1e-5 of the peak of "
        f"the zero-stuffing definition at {len(out)} geometries, one launch a call, bit for bit "
        f"between two calls, the output in the input's memory format; [forward, vjp] device us "
        f"cold, byte bound us, the library depthwise route's ms, error / tolerance (the whole "
        f"table in chiprun_out/fir_k11.json): " + json.dumps(summary))
    return out


def fir_blind_run(dev, wrappers) -> tuple:
    """Run (a): ``Tester.do_test()`` in blind mode, B=8 x 65536, full width
    with FIR resampling and both residual pyramids, float32 body, full
    guidance, 10 operator updates a step, WPE warm init, T=FIR_STEPS:
    the counts set to 0 just before the second run and read just after,
    five WAV sets of 8 finite files, K1 and K11 (forward and input vjp)
    launched in every step, every K11 launch recorded by its geometry; then
    one more run profiled (device ms, launches and idle a step; K11's
    device ms and launches a step by kernel name; no FIR-shaped library
    convolution).  Returns the results and the record."""
    import torch
    from buddy_tpu_torch.ops import resample as R
    args, net, tester, sampler_s, run = blind_tester(
        dev, steps=FIR_STEPS, network=FIR_NET, run_name="fir_residual")
    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    R.upfirdn2d.launches = R.upfirdn2d_backward.launches = 0
    R.upfirdn2d.record = {}
    torch.cuda.reset_peak_memory_stats()
    try:
        run()
    finally:
        record, R.upfirdn2d.record = R.upfirdn2d.record, None
    launches = {name: w.launches for name, w in wrappers.items()}
    k11 = [R.upfirdn2d.launches / FIR_STEPS, R.upfirdn2d_backward.launches / FIR_STEPS]
    check_outputs(tester, "blind_dereverberation", 8, 65536, blind=True)
    k1_per_step = launches["groupnorm_silu_fwd"] / FIR_STEPS
    if not k1_per_step > 0 or not launches["groupnorm_silu_bwd"] > 0:
        raise AssertionError(f"run (a): K1 launches {launches}")
    if not min(k11) > 0:
        raise AssertionError(f"run (a): K11 launches a step (forward, vjp) {k11}")
    by_row = {}
    for (direction, _, _, ay, _, _), n in record.items():
        row = k11_kind(direction, ay)
        by_row[row] = by_row.get(row, 0) + n
    if sorted(by_row) != sorted(K11_ROWS) or not min(by_row.values()) > 0:
        raise AssertionError(f"run (a): K11 launches by pass and direction {by_row}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with device_profile(cpu=True, record_shapes=True) as prof:
        t1 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t1) * 1e3
    library_fir = fir_ops(prof)
    if library_fir:
        raise AssertionError(f"run (a): {len(library_fir)} FIR-shaped library convolutions in "
                             f"the profile (K11 should run every FIR call)")
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    with open(os.path.join(OUT_DIR, "profile_fir_residual.txt"), "w") as f:
        for name, ms, count in sorted(rows, key=lambda r: -r[1]):
            f.write(f"{ms:12.3f} ms {count:8d}x  {name}\n")
    device = sum(r[1] for r in rows)
    fir = k11_profile_ms(rows)
    if not fir:
        raise AssertionError("run (a): the profile shows no K11 launch")
    fir_ms = sum(v[0] for v in fir.values())
    res = {"sampler_ms_per_step": round(sampler_s[1] / FIR_STEPS * 1e3, 1),
           "device_ms_per_step": round(device / FIR_STEPS, 3),
           "launches_per_step": round(sum(r[2] for r in rows) / FIR_STEPS, 1),
           "idle_share": round(1 - device_busy_ms(prof) / wall, 4),
           "k1_launches_per_step": [k1_per_step, launches["groupnorm_silu_bwd"] / FIR_STEPS],
           "k11_launches_per_step": k11,
           "k11_launches_by_row": by_row,
           "fir_device_ms_per_step": round(fir_ms / FIR_STEPS, 3),
           "fir_share_of_device": round(fir_ms / device, 4), "peak_gib": round(peak, 2),
           "cold_run_s": round(cold, 1)}
    log(f"run (a): Tester.do_test(), blind, B=8 x 65536, NCSN++ nf={args['network']['nf']} "
        f"{' '.join(FIR_NET)} ({net.num_params / 1e6:.2f} M params, float32 body), T={FIR_STEPS}, "
        f"full guidance, 10 updates/step, WPE warm init: 5 directories x 8 finite WAVs, "
        f"metrics.jsonl 8 lines; no FIR-shaped library convolution in the profile; "
        + json.dumps(res))
    log("run (a): the port's kernels' launches in the counted run: " + json.dumps(launches))
    log("run (a) profile: K11's device ms a step by kernel [ms, launches a step]: "
        + json.dumps({k: [round(v[0] / FIR_STEPS, 3), v[1] / FIR_STEPS]
                      for k, v in sorted(fir.items(), key=lambda kv: -kv[1][0])})
        + "; K11 launches recorded by geometry [direction, x, channels_last, up, down, pad, "
        "count]: " + json.dumps([[d, list(s), c, ay.up, ay.down, [ay.pad0, ay.pad1], n]
                                 for (d, s, c, ay, _, _), n in sorted(record.items(), key=str)]))
    del net, tester
    torch.cuda.empty_cache()
    return res, record


def remat_training(dev, wrappers) -> dict:
    """Run (b): the ddpm network at full width trained at the shipped exp
    (batch 16 x 65536, float32, deterministic cuDNN) for REMAT_STEPS steps
    with ``remat=false``, then anew from the same weights (seed), batches
    and draws with ``remat=true``: a finite loss, the gradients (as Adam
    took them), parameters, EMA and moments after every step bit for bit
    between the two; K1 launched in every step; ms a step and peak memory
    of each."""
    import numpy as np
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    data = os.path.join(OUT_DIR, "train")
    if not os.path.isdir(data):
        write_train_set(data)
    model_dir = os.path.join(OUT_DIR, "train_runs", "remat")
    shutil.rmtree(model_dir, ignore_errors=True)
    over = [f"dset.train.path={data}", "dset.train.speakers_test=[]",
            "dset.train.speakers_discard=[]", f"exp.batch_size={TRAIN_BATCH}",
            "exp.grad_accum=1", "exp.resume=False", "logging.log=False",
            "tester=only_unconditional", f"model_dir={model_dir}", *DDPM_NET]
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs, batches = {}, None
    for remat in (False, True):
        torch.cuda.empty_cache()
        trainer, loader = build_trainer(
            dev, over + [f"network.remat={str(remat).lower()}"],
            loader=None if batches is None else ReplayLoader(batches),
            noise=NoiseSource(torch.Generator().manual_seed(9)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps, ms, k1 = [], [], []
        for _ in range(REMAT_STEPS):
            before = wrappers["groupnorm_silu_fwd"].launches, wrappers["groupnorm_silu_bwd"].launches
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            k1.append((wrappers["groupnorm_silu_fwd"].launches - before[0],
                       wrappers["groupnorm_silu_bwd"].launches - before[1]))
            snap = {"grads": {k: p.grad.detach().cpu().clone() for k, p in trainer.params.items()
                              if p.grad is not None}}
            for what in ("params", "ema", "mu", "nu"):
                snap[what] = {k: v.detach().cpu().clone() for k, v in getattr(trainer, what).items()}
            snap["loss"] = float(trainer._metrics_acc["loss"])
            steps.append(snap)
            trainer.it += 1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        blocks = sum(getattr(m, "remat", False) for m in trainer.module.modules())
        if remat != (blocks > 0):
            raise AssertionError(f"run (b): remat={remat} but {blocks} ResBlocks recompute")
        if batches is None:
            batches = loader.batches[:REMAT_STEPS]
            loader.close()
        runs[remat] = {"steps": steps, "ms": ms, "peak_gib": peak, "k1": k1,
                       "params": trainer.total_params, "blocks": blocks}
        del trainer
    torch.backends.cudnn.deterministic = False
    a, b = runs[False], runs[True]
    losses = [s["loss"] for s in a["steps"]]
    if not np.isfinite(losses).all() or any(min(c) == 0 for r in runs.values() for c in r["k1"]):
        raise AssertionError(f"run (b): losses {losses}, K1 launches {a['k1']} / {b['k1']}")
    for i, (sa, sb) in enumerate(zip(a["steps"], b["steps"])):
        for what in ("grads", "params", "ema", "mu", "nu"):
            if sa[what].keys() != sb[what].keys() or not sa[what] or \
                    not all(torch.equal(sa[what][k], sb[what][k]) for k in sa[what]):
                raise AssertionError(f"run (b): {what} after step {i} differ with remat")
        if sa["loss"] != sb["loss"]:
            raise AssertionError(f"run (b): loss after step {i}: {sa['loss']} / {sb['loss']}")
    res = {f"remat_{str(r).lower()}": {
        "ms_per_step": [round(v, 1) for v in runs[r]["ms"]],
        "ms_per_step_after_the_first": round(float(np.mean(runs[r]["ms"][1:])), 1),
        "peak_gib": round(runs[r]["peak_gib"], 2),
        "k1_launches_per_step": runs[r]["k1"][-1]} for r in (False, True)}
    log(f"run (b): the ddpm network ({' '.join(DDPM_NET)}; {a['params'] / 1e6:.2f} M params) "
        f"trained at batch {TRAIN_BATCH} x 65536, float32, deterministic cuDNN, {REMAT_STEPS} "
        f"steps with remat=false, then {REMAT_STEPS} from the same weights, batches and draws "
        f"with remat=true ({b['blocks']} ResBlocks recomputed): losses (summed) "
        f"{[round(v, 6) for v in losses]}, finite; gradients, parameters, EMA and moments after "
        f"every step bit for bit equal; " + json.dumps(res))
    return res


def config_space_card_vs_cpu(dev) -> None:
    """Run (c): (a)'s configuration at nf=16 (float32): the network's
    forward and its vjp w.r.t. the waveform on the card (kernels) and on
    the CPU (plain versions), the same weights (seed), inputs and
    cotangent, to 1e-4 of the peak as the CPU parity tests hold a float32
    network; and (b)'s configuration (with remat) at nf=16: one train step
    card vs CPU, as phase 7's."""
    import torch
    from buddy_tpu_torch.config import compose, instantiate
    gen = torch.Generator().manual_seed(14)
    x = torch.from_numpy(load_wavs("degraded", 2, 16384))
    cnoise = torch.tensor([-1.0, 0.3])
    ct = torch.randn(x.shape, generator=gen)
    from buddy_tpu_torch.ops import resample as R
    outs = []
    k11 = [R.upfirdn2d.launches, R.upfirdn2d_backward.launches]
    for d in (dev, torch.device("cpu")):
        args = compose("conf_VCTK.yaml", SMALL_NET + FIR_NET)
        net = instantiate(args["network"], device=d, seed=3)
        xd = x.to(d).requires_grad_(True)
        y = net(xd, cnoise.to(d))
        (g,) = torch.autograd.grad(y, xd, ct.to(d))
        outs.append((y.detach().cpu(), g.cpu()))
        if d == dev:
            k11 = [R.upfirdn2d.launches - k11[0], R.upfirdn2d_backward.launches - k11[1]]
    if not min(k11) > 0:
        raise AssertionError(f"run (c): K11 launches on the card (forward, vjp) {k11}")
    (yc, gc), (yp, gp) = outs
    e_y, e_g = max_err(yc, yp), max_err(gc, gp)
    check("run (c): FIR residual network forward, card vs CPU", e_y, 1e-4 * float(yp.abs().max()))
    check("run (c): FIR residual network input vjp, card vs CPU", e_g,
          1e-4 * float(gp.abs().max()))
    log(f"run (c): {' '.join(FIR_NET)} at nf=16 (B=2 x 16384, float32): forward and input vjp, "
        f"card (K11: {k11[0]} + {k11[1]} launches) vs CPU (the plain route), max abs error {e_y:.3e} / {e_g:.3e} ({e_y / float(yp.abs().max()):.2e} / "
        f"{e_g / float(gp.abs().max()):.2e} of the peak; tolerance 1e-4 of the peak)")
    train_step_card_vs_cpu(dev, SMALL_NET + DDPM_NET + ["network.remat=true"],
                           "nf=16, ddpm, remat")

# ---------------------------------------------------------------------------
# phase 10: the device mesh over torch.distributed
# ---------------------------------------------------------------------------
# (a) the CLIs under torchrun at world 1 (NCCL); (b) two ranks on the one
# card over gloo (CUDA tensors) training the full-width network, against one
# process at the same global batch and draws; (c) the blind tester and
# unconditional sampling on the two ranks against one process running each
# rank's utterances with its draws; (d) the spectrogram's log magnitude.
MESH_DIR = os.path.join(OUT_DIR, "mesh_runs")
MESH_BATCH = 4                  # run (b)'s global batch of 65536 samples, float32
MESH_TRAIN = {"dp2": (["exp.mesh.dp=2"], 2, 21),          # overrides, steps, noise seed
              "sp2": (["exp.mesh.dp=1", "exp.mesh.sp=2"], 1, 22)}
MESH_TESTER_SEEDS = (42, 43)    # the tester's noise and reset noise (testing/tester.py)
MESH_TIMEOUT = 600
# (e): overrides, steps, noise seed, first of mesh_batches(); (f) likewise, in a world of four
MESH_TP = (["exp.mesh.dp=1", "exp.mesh.tp=2"], 2, 23, 0)
MESH_TP4 = (["exp.mesh.dp=2", "exp.mesh.tp=2", "network.nf=16", "network.remat=true"], 1, 24, 2)
# (e)'s limit on a rank's parameter + Adam + EMA bytes over one process's: of
# the shipped network's 27,736,590 parameters, 24,677,636 are conv kernels
# whose output channels divide by 2, so the rule gives 0.555
TP_STATE_RATIO = 0.56
# run (b)'s limit on the parameters' and the EMA's largest difference from one
# process: ten times the largest that sound runs read (dp=2 after 2 steps:
# parameters 3.4886e-6, EMA 3.4872e-6; sp=2: 0; NVIDIA H100 80GB HBM3, 700 W),
# well under one Adam step of lr = 1e-4, which a wrong update moves by
MESH_PARAM_TOL = 3.5e-5
# (e) and (f): the gathered state against one process.  Each rank's
# half-width convolutions take cuDNN algorithms of their own, so the
# gradients' rounding is not dp's: limits of ten times the largest readings
# of sound runs (NVIDIA H100 80GB HBM3, 700 W) on the largest error over
# mesh_compare's gradient rule (grads, mu, nu; (e) read 2.5473 at
# all_modules.23.Conv_1's weight, (f) 0.1406) and on the parameters' and the
# EMA's largest difference ((e) 2.5702e-6, (f) 1.9076e-7), which a wrong
# update moves by up to lr = 1e-4
TP_GRAD_LIMIT = 25.0
TP_PARAM_TOL = 2.6e-5


def mesh_train_overrides(extra) -> list:
    return [f"exp.batch_size={MESH_BATCH}", "exp.grad_accum=1", "exp.resume=False",
            "logging.log=False", "tester=only_unconditional",
            f"model_dir={os.path.join(MESH_DIR, 'train')}", *extra]


def mesh_batches():
    """Run (b)'s global batches: the 8 clean utterances, 4 a batch, in turn."""
    import numpy as np
    clean = load_wavs("clean", 8, 65536)[:, 0]
    return [np.ascontiguousarray(clean[(4 * i + np.arange(4)) % 8]) for i in range(3)]


def mesh_steps(trainer, steps: int, batches_from: int = 0) -> list:
    """``steps`` train steps; for each the loss, the pre-clip norm, ms (CUDA
    events around the step), and K1's and K2's launches in it."""
    import torch
    from buddy_tpu_torch.ops import groupnorm as K1
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    counters = (K1.group_norm_act, K1.group_norm_act_backward, K2.stft_analysis,
                K2.stft_synthesis)
    out = []
    for _ in range(steps):
        before = [c.launches for c in counters]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step()
        end.record()
        torch.cuda.synchronize()
        m = trainer._metrics_acc
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "ms": start.elapsed_time(end),
                    "launches": [c.launches - b for c, b in zip(counters, before)]})
        trainer._metrics_acc = None
        trainer.it += 1
    return out


def mesh_state(trainer) -> dict:
    grads = {k: p.grad.detach().clone() for k, p in trainer.params.items() if p.grad is not None}
    state = {w: {k: v.detach().clone() for k, v in getattr(trainer, w).items()}
             for w in ("params", "ema", "mu", "nu")}
    return {"grads": grads, **state}


def mesh_compare(ours: dict, ref: dict, checked: bool = True) -> dict:
    """The state after the last step against one process's: gradients (of
    the last step) at ``gradient_tolerances``' rule (1e-4 of each leaf's
    peak, no less than 1e-6 of the largest leaf's), mu at that rule of its
    own leaves, nu at twice it (nu ~ g^2), parameters and EMA within
    MESH_PARAM_TOL.  Returns the
    largest error / tolerance of each and the largest parameter and EMA
    differences; raises beyond a tolerance unless not ``checked`` (the
    caller then holds the readings to limits of its own)."""
    return _compare(ours, ref, check if checked else lambda *a: None)


def _compare(ours: dict, ref: dict, check) -> dict:
    worst = {}
    for what, factor in (("grads", 1.0), ("mu", 1.0), ("nu", 2.0)):
        top = max(float(v.abs().max()) for v in ref[what].values())
        w, leaf = 0.0, None
        if ours[what].keys() != ref[what].keys():
            raise AssertionError(f"mesh train: {what} leaves differ")
        for k, r in ref[what].items():
            tol = factor * max(1e-4 * float(r.abs().max()), 1e-6 * top)
            e = max_err(ours[what][k], r)
            check(f"mesh train {what} {k}", e, tol)
            if tol and e / tol > w:
                w, leaf = e / tol, k
        worst[what], worst[what + "_leaf"] = round(w, 4), leaf
    for what in ("params", "ema"):
        d = max(max_err(ours[what][k], r) for k, r in ref[what].items())
        check(f"mesh train {what}", d, MESH_PARAM_TOL)
        worst[what + "_max_diff"] = d
    return worst


def state_bytes(trainer) -> int:
    """The bytes of this rank's parameters, Adam's moments and EMA."""
    return sum(t.numel() * t.element_size()
               for st in (trainer.params, trainer.mu, trainer.nu, trainer.ema) for t in st.values())


def gn1_shapes(module, batch: int, dev) -> list:
    """[(B, C, H, W), G, silu] of each ResBlock's GroupNorm_1 at ``batch`` x
    65536, whole (one no-grad forward, pre-hooks on those modules)."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.models.layers import _ResBlock
    calls = []
    hooks = [m.GroupNorm_1.register_forward_pre_hook(
        lambda m, a: calls.append((list(a[0].shape), m.num_groups, m.act is F.silu)))
        for m in module.modules() if isinstance(m, _ResBlock)]
    try:
        with torch.no_grad():
            module(torch.zeros((batch, 1, 65536), device=dev), torch.zeros((batch,), device=dev))
    finally:
        for h in hooks:
            h.remove()
    return sorted({(tuple(s), g, a) for s, g, a in calls})


class TpCollectives:
    """A stand-in for ``torch.distributed`` in ``parallel.mesh`` that times
    (between synchronisations) and counts the bytes each rank sends in the
    all-gathers and all-reduces on the tp group; every other call passes."""

    def __init__(self, inner, group):
        self.inner, self.group = inner, group
        self.bytes = self.gathers = self.reduces = 0
        self.ms = 0.0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _timed(self, fn, t, args, group, kwargs, what):
        import torch
        if group is not self.group:
            return fn(*args, group=group, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, group=group, **kwargs)
        torch.cuda.synchronize()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.bytes += t.numel() * t.element_size()
        setattr(self, what, getattr(self, what) + 1)
        return out

    def all_gather(self, parts, t, group=None, **kw):
        return self._timed(self.inner.all_gather, t, (parts, t), group, kw, "gathers")

    def all_reduce(self, t, group=None, **kw):
        return self._timed(self.inner.all_reduce, t, (t,), group, kw, "reduces")


def tp_whole_state(trainer):
    """The gradients, parameters, EMA and moments gathered over the tp line
    (CPU tensors, the port's names) on its first rank, None on the others;
    every rank of the line must call it."""
    from buddy_tpu_torch.models.convert import from_jax_params
    grads = {k: p.grad for k, p in trainer.params.items() if p.grad is not None}
    trees = {w: trainer.whole(st) for w, st in (("grads", grads), ("params", trainer.params),
                                                 ("ema", trainer.ema), ("mu", trainer.mu),
                                                 ("nu", trainer.nu))}
    if trees["params"] is None:
        return None
    return {w: from_jax_params(t) for w, t in trees.items()}


def replicated_digest(trainer) -> str:
    """A digest of the leaves every rank of a tp line holds whole."""
    import hashlib
    h = hashlib.sha256()
    for st in (trainer.params, trainer.ema, trainer.mu, trainer.nu):
        for k in sorted(st):
            if not trainer.shardings[k].spec:
                h.update(st[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def record_gn_calls(module) -> tuple:
    """Pre-hooks on every GroupNormAct that append (C, groups, sharded) of
    each call to the returned list: the channels and groups K1 runs at."""
    from buddy_tpu_torch.models.layers import GroupNormAct
    calls = []

    def hook(m, a):
        tp = a[1] if len(a) > 1 else None
        calls.append((int(a[0].shape[1]), m.num_groups // (tp.size if tp else 1), tp is not None))
    return calls, [m.register_forward_pre_hook(hook) for m in module.modules()
                   if isinstance(m, GroupNormAct)]


def mesh_tp_rank(dev, rank: int, world: int) -> dict:
    """(e) (world 2) or (f) (world 4) on one rank: the trainer from the same
    weights, global batches and draws as the one-process run; per step the
    loss, norm, ms, K1 and K2 launches, the GroupNorm calls' channels and
    groups, and the tp collectives' bytes, count and ms; this rank's state
    bytes and peak memory; the gathered state against the one process's
    (on each tp line's first rank), the replicated leaves' digest; (e) then
    writes a checkpoint (the first rank), (f) counts a no-grad forward's
    all-gathers beside the step's (the recomputation's)."""
    import numpy as np
    import torch
    from buddy_tpu_torch.parallel import mesh as pmesh
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    case = "tp2" if world == 2 else "tp4"
    extra, steps, seed, first = MESH_TP if world == 2 else MESH_TP4
    t_start = time.perf_counter()
    with np.load(os.path.join(MESH_DIR, "batches.npz")) as f:
        batches = [f[k] for k in sorted(f.files)]
    torch.cuda.reset_peak_memory_stats()
    trainer, _ = build_trainer(dev, mesh_train_overrides(extra),
                               loader=ReplayLoader(batches[first:first + steps]),
                               noise=NoiseSource(torch.Generator().manual_seed(seed)))
    inner, coll = pmesh.dist, TpCollectives(pmesh.dist, trainer.mesh.tp.group)
    calls, hooks = record_gn_calls(trainer.module)
    pmesh.dist = coll
    rows = []
    try:
        for _ in range(steps):
            calls.clear()
            before = (coll.bytes, coll.ms, coll.gathers, coll.reduces)
            row = mesh_steps(trainer, 1)[0]
            row.update(gn=sorted(set(calls)), tp_bytes=coll.bytes - before[0],
                       tp_ms=coll.ms - before[1], tp_gathers=coll.gathers - before[2],
                       tp_reduces=coll.reduces - before[3])
            rows.append(row)
        if world == 4:          # the forward alone: the step's extra gathers are remat's
            g0 = coll.gathers
            with torch.no_grad():
                trainer._net(torch.zeros((2, 65536), device=dev), torch.ones((2,), device=dev))
            forward_gathers = coll.gathers - g0
    finally:
        pmesh.dist = inner
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    whole = tp_whole_state(trainer)
    res = {"steps": rows, "mesh": trainer.mesh.shape, "coords": trainer.mesh.coords,
           "state_bytes": state_bytes(trainer), "peak_gib": peak,
           "replicated_digest": replicated_digest(trainer), "whole": whole is not None}
    if world == 4:
        res["forward_gathers"] = forward_gathers
    if whole is not None:
        ref = torch.load(os.path.join(MESH_DIR, f"ref_{case}.pt"), map_location="cpu")
        res["compare"] = mesh_compare(whole, ref, checked=False)
        res["digest"] = mesh_digest(whole)
        if world == 2:
            torch.save(whole, os.path.join(MESH_DIR, "tp2_whole.pt"))
    if world == 2:
        trainer.save_checkpoint()
        res["checkpoint"] = trainer.latest_checkpoint
    res["seconds"] = time.perf_counter() - t_start
    del trainer
    torch.cuda.empty_cache()
    return res


def mesh_digest(state: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for what in ("params", "ema", "mu", "nu"):
        for k in sorted(state[what]):
            h.update(state[what][k].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mesh_train_reference(dev, batches) -> dict:
    """Run (b)'s one-process runs: each case's steps at the global batch,
    deterministic cuDNN; the state after the last step to MESH_DIR."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    out = {}
    cases = {case: (["exp.mesh.dp=1"], steps, seed, 0 if case == "dp2" else 2)
             for case, (_, steps, seed) in MESH_TRAIN.items()}
    cases["tp2"] = (["exp.mesh.dp=1"], *MESH_TP[1:])
    cases["tp4"] = (["exp.mesh.dp=1", *MESH_TP4[0][2:]], *MESH_TP4[1:])
    for case, (extra, steps, seed, first) in cases.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        trainer, _ = build_trainer(dev, mesh_train_overrides(extra),
                                   loader=ReplayLoader(batches[first:first + steps]),
                                   noise=NoiseSource(torch.Generator().manual_seed(seed)))
        out[case] = mesh_steps(trainer, steps)
        torch.save(mesh_state(trainer), os.path.join(MESH_DIR, f"ref_{case}.pt"))
        out[case + "_params"] = trainer.total_params
        out[case + "_state_bytes"] = state_bytes(trainer)
        out[case + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if case == "tp2":
            out["gn_shapes"] = gn1_shapes(trainer.module, MESH_BATCH, dev)
        del trainer
        torch.cuda.empty_cache()
        out[case + "_s"] = time.perf_counter() - t0
    return out


def mesh_train_rank(dev, rank: int) -> dict:
    """Run (b) on one rank: each case from the same weights (seed), global
    batches and draws as the one-process run; the all-reduce's ms a step,
    timed between two synchronisations."""
    import numpy as np
    import torch
    from buddy_tpu_torch.parallel import mesh as pmesh
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    with np.load(os.path.join(MESH_DIR, "batches.npz")) as f:
        batches = [f[k] for k in sorted(f.files)]
    all_reduce_ms, inner = [], pmesh.all_reduce_sum

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(*a, **k)
        torch.cuda.synchronize()
        all_reduce_ms.append((time.perf_counter() - t0) * 1e3)
    pmesh.all_reduce_sum = timed
    res = {}
    for case, (extra, steps, seed) in MESH_TRAIN.items():
        all_reduce_ms.clear()
        first = 0 if case == "dp2" else 2
        trainer, _ = build_trainer(dev, mesh_train_overrides(extra),
                                   loader=ReplayLoader(batches[first:first + steps]),
                                   noise=NoiseSource(torch.Generator().manual_seed(seed)))
        rows = mesh_steps(trainer, steps)
        state = mesh_state(trainer)
        ref = torch.load(os.path.join(MESH_DIR, f"ref_{case}.pt"), map_location=dev)
        res[case] = {"steps": rows, "mesh": trainer.mesh.shape, "coords": trainer.mesh.coords,
                     "compare": mesh_compare(state, ref), "digest": mesh_digest(state),
                     "all_reduce_ms": list(all_reduce_ms)}
        del trainer, state, ref
        torch.cuda.empty_cache()
    return res


MESH_TESTER = ["tester.sampling_params.T=2", "network.compute_dtype=bfloat16",
               "tester.posterior_sampling.guidance_jacobian=full",
               "tester.posterior_sampling.blind_hp.op_updates_per_step=10",
               "tester.posterior_sampling.warm_initialization.mode=wpe_scaled",
               "tester.batched.use=True", "tester.batched.batch_size=8"]


def mesh_capture(tester) -> dict:
    """Keep the first (prediction, estimated RIR) the tester writes for
    each file."""
    got = {}
    inner = tester._write_item_outputs

    def keep(mode, seg, y, pred, rir, filename, est_rir=None):
        got.setdefault(os.path.basename(filename), (pred.copy(), est_rir.copy()))
        return inner(mode, seg, y, pred, rir, filename, est_rir=est_rir)
    tester._write_item_outputs = keep
    return got


def mesh_unconditional_tester(dev, net, model_dir):
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.testing.tester import Tester
    args = compose("conf_VCTK.yaml", [
        "tester=only_unconditional", "network.compute_dtype=bfloat16",
        "tester.sampling_params.T=2", "tester.unconditional.num_samples=2",
        "tester.unconditional.audio_len=65536", f"model_dir={model_dir}",
        "tester.overriden_name=mesh_unconditional"])
    return Tester(args, net, instantiate(args["diff_params"]), device=dev)


def mesh_tester_rank(dev, rank: int) -> dict:
    """Run (c) on one rank: the blind ``do_test()`` of the 8 utterances
    (batch 8, this rank's 4) twice, then 2 unconditional samples (one a
    rank); the outputs the first rank writes in the first run (the
    gathered batch), the sampler's ms a step on this rank, cold and warm."""
    import numpy as np
    import torch
    model_dir = os.path.join(MESH_DIR, f"tester_rank{rank}")
    args, net, tester = build_tester(dev, "blind_dereverberation_BUDDy",
                                     os.path.join(MESH_DIR, "data"), "mesh",
                                     [*MESH_TESTER, f"model_dir={model_dir}"])
    got = mesh_capture(tester)
    sampler_s, inner = [], tester.sampler.predict_conditional_batched

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        sampler_s.append(time.perf_counter() - t0)
        return out
    tester.sampler.predict_conditional_batched = timed
    tester.do_test()                # compared; the second run is timed warm
    torch.cuda.synchronize()
    if rank == 0:
        check_outputs(tester, "blind_dereverberation", 8, 65536, blind=True)
    tester.do_test()
    torch.cuda.synchronize()
    unc = mesh_unconditional_tester(dev, net, model_dir).do_test()
    arrays = {f"pred/{k}": v[0] for k, v in got.items()}
    arrays.update({f"est/{k}": v[1] for k, v in got.items()})
    if unc is not None:
        arrays["unconditional"] = unc
    np.savez(os.path.join(MESH_DIR, f"tester_rank{rank}.npz"), **arrays)
    files = sorted(os.path.relpath(os.path.join(d, f), model_dir)
                   for d, _, fs in os.walk(model_dir) for f in fs)
    return {"written": len(got), "files": files, "sampler_ms_per_step_cold_warm":
            [round(s / tester.sampler.T * 1e3, 1) for s in sampler_s],
            "mesh": None if tester.mesh is None else tester.mesh.shape}


def mesh_tester_reference(dev) -> dict:
    """Run (c)'s one-process runs: for each rank r, its 4 utterances as one
    batch with the draws of rows r of the global batch (``ShardedNoise``
    over the tester's seeds); its unconditional row likewise."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource, ShardedNoise
    out = {"pred": {}, "est": {}, "unconditional": []}
    for r in range(2):
        args, net, tester = build_tester(dev, "blind_dereverberation_BUDDy",
                                         os.path.join(MESH_DIR, "data"), f"mesh_ref{r}",
                                         [*MESH_TESTER, f"model_dir={MESH_DIR}"])
        tester.test_set = [tester.test_set[i] for i in range(4 * r, 4 * r + 4)]
        tester.noise, tester.reset_noise = (
            ShardedNoise(NoiseSource(torch.Generator().manual_seed(s)), r, 2)
            for s in MESH_TESTER_SEEDS)
        got = mesh_capture(tester)
        tester.do_test()
        for k, (p, e) in got.items():
            out["pred"][k], out["est"][k] = p, e
        unc = mesh_unconditional_tester(dev, net, MESH_DIR)
        out["unconditional"].append(unc.sampler.predict_unconditional(
            (1, 65536), noise=ShardedNoise(unc.noise, r, 2)).cpu().numpy())
        del net, tester, unc
        torch.cuda.empty_cache()
    return out


def mesh_rank_main(argv) -> int:
    """A rank of one of phase 10's worlds (``chip_smoke.py --mesh-rank <rank>
    <world>``): gloo on the one card; the world of two runs (b), (c) and
    (e), the world of four (f); results to MESH_DIR."""
    import datetime
    import torch
    import torch.distributed as dist
    rank, world = int(argv[0]), int(argv[1])
    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    from buddy_tpu_torch.device import resolve_device
    dev = resolve_device(None)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(MESH_DIR, f'store{world}')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        res = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}
        if world == 2:
            res.update(train=mesh_train_rank(dev, rank), tester=mesh_tester_rank(dev, rank))
        res["tp"] = mesh_tp_rank(dev, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(MESH_DIR, f"world{world}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def mesh_clis(dev) -> float:
    """(a): the training CLI under ``torchrun --standalone --nproc_per_node=1``
    (NCCL, world 1, exp.mesh.dp=-1) at nf=8 for 2 steps, then the testing CLI
    under torchrun on its checkpoint."""
    import numpy as np
    t0 = time.perf_counter()
    model_dir = os.path.join(MESH_DIR, "cli")
    if not os.path.isdir(os.path.join(OUT_DIR, "train")):
        write_train_set(os.path.join(OUT_DIR, "train"))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node=1", "-m"]
    cmd = [*torchrun, "buddy_tpu_torch.training", "--config-name=conf_VCTK.yaml",
           *TINY_TRAIN, f"dset.train.path={os.path.join(OUT_DIR, 'train')}",
           "dset.train.speakers_test=[]", "exp.batch_size=4", "exp.max_iters=2",
           "exp.mesh.dp=-1", "logging.save_interval=2", "logging.log_interval=1",
           "logging.heavy_log_interval=2", "tester.sampling_params.T=2",
           "tester.unconditional.num_samples=1", f"model_dir={model_dir}"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=MESH_TIMEOUT)
    if run.returncode != 0 or "it=2 loss=" not in run.stdout or "nccl" not in run.stdout \
            or NATIVE_CLI not in run.stdout:
        raise AssertionError(f"torchrun training CLI exited with {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    loader_line = [ln.strip() for ln in run.stdout.splitlines() if ln.startswith("Loader:")]
    ranks_line = [ln for ln in run.stdout.splitlines() if ln.startswith("Ranks:")]
    ckpt = os.path.join(model_dir, "VCTK_16k_4s_time-2.ckpt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"torchrun training CLI wrote {sorted(os.listdir(model_dir))}")
    cmd = [*torchrun, "buddy_tpu_torch.testing", "--config-name=conf_VCTK.yaml",
           "tester=blind_dereverberation_BUDDy", f"tester.checkpoint={ckpt}", *TINY_TRAIN,
           "dset=vctk_16k_4s_test-benchmark", f"dset.test.path={os.path.join(MESH_DIR, 'data')}",
           'dset.test.speakers_test=["p226"]', "dset.test.num_examples=2",
           "tester.sampling_params.T=2", "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
           "tester.batched.use=True", "tester.batched.batch_size=2", "tester.overriden_name=cli",
           f"model_dir={model_dir}"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=MESH_TIMEOUT)
    if run.returncode != 0 or "(it=2)" not in run.stdout or "nccl" not in run.stdout:
        raise AssertionError(f"torchrun testing CLI exited with {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    from buddy_tpu_torch.data.audio_io import read_wav
    rec = read_wav(os.path.join(model_dir, "cli", "blind_dereverberation", "VCTK_16k_4s_time",
                                "reconstructed", "utt0.wav"))[0]
    if len(rec) != 65536 or not np.isfinite(rec).all():
        raise AssertionError("torchrun testing CLI: reconstructed/utt0.wav is not 65536 finite "
                             "samples")
    s = time.perf_counter() - t0
    log(f"(a) torchrun --standalone --nproc_per_node=1: the training CLI (nf=8, batch 4 x 65536, "
        f"exp.mesh.dp=-1, max_iters=2; {ranks_line[0] if ranks_line else ''}; "
        f"{loader_line[0]}): exit 0, "
        f"checkpoint at it=2; the testing CLI under torchrun on it (blind, 2 items): exit 0, "
        f"finite WAVs; {s:.1f} s")
    return s


def mesh_spectrogram(dev) -> None:
    """(d): ``log_spectrogram`` (n_fft 1024, hop 256, constant padding) of an
    utterance on the card (K2) against the CPU's (its plain version), the
    magnitudes to 1e-4 of their peak."""
    import torch
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")
    from buddy_tpu_torch.utils.log import log_spectrogram
    x = torch.from_numpy(load_wavs("clean", 1, 65536)[0, 0])
    cfg = {"win_size": 1024, "hop_size": 256}
    before = K2.stft_analysis.launches
    card = log_spectrogram(x.to(dev), cfg)
    launched = K2.stft_analysis.launches - before
    cpu = log_spectrogram(x, cfg, device="cpu")
    mag, mag_ref = 10.0 ** (card / 20), 10.0 ** (cpu / 20)
    e = max_err(torch.from_numpy(mag), torch.from_numpy(mag_ref))
    check("log_spectrogram card vs CPU (magnitudes)", e, 1e-4 * float(mag_ref.max()))
    if launched != 1 or card.shape != (513, 257):
        raise AssertionError(f"log_spectrogram: {launched} K2 launches, shape {card.shape}")
    log(f"(d) log_spectrogram (1024 / 256, constant padding) of 65536 samples: {card.shape}, one "
        f"K2 analysis launch on the card; magnitudes card vs CPU within {e:.3e} "
        f"({e / float(mag_ref.max()):.2e} of the peak; tolerance 1e-4 of the peak)")


def mesh_world(world: int = 2) -> list:
    """Start a world of ``world`` ranks (``chip_smoke.py --mesh-rank <r>
    <world>``), wait for every rank (killed at the time limit), and return
    their results."""
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mesh-rank",
                               str(r), str(world)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r}: exit {p.returncode}\n{o[0][-1500:]}\n{o[1][-3000:]}"
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"phase 10's world of {world} failed:\n" + "\n".join(bad))
    ranks = []
    for r in range(world):
        with open(os.path.join(MESH_DIR, f"world{world}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def k1_tp_checks(dev, shapes) -> list:
    """(g): K1 at each local shape of (e) ((B, C / 2, H, W) in G / 2 groups,
    float32, forward and backward with d weight and d bias) against the
    plain version (k1_training_checks' tolerances), its ms beside the plain
    version's and F.group_norm's, and the device us a launch (cold) there
    and at the whole width (B, C, H, W) in G groups."""
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.ops import groupnorm as K1
    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (B, C, H, W), G, silu in shapes:
        row = {"shape": [B, C // 2, H, W], "groups": G // 2, "silu": silu}
        for what, (c, groups) in (("local", (C // 2, G // 2)), ("whole", (C, G))):
            x = (torch.randn((B, c, H, W), generator=g, device=dev) * 2 + 0.3).contiguous(
                memory_format=torch.channels_last)
            dy = torch.randn((B, c, H, W), generator=g, device=dev).contiguous(
                memory_format=torch.channels_last)
            w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
            b = 0.1 * torch.randn(c, generator=g, device=dev)
            if what == "local":
                xp, wp, bp = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
                yp = K1.group_norm_act_plain(xp, wp, bp, groups, 1e-6, silu=silu)
                dxp, dwp, dbp = torch.autograd.grad(yp, (xp, wp, bp), dy, retain_graph=True)
                y_k, mr = K1._launch_forward(x, w, b, groups, 1e-6, silu)
                dx, dw, db = K1.group_norm_act_backward(x, dy, w, b, mr, silu, True)
                where = f"(g) K1 at the local shape {row['shape']} in {groups} groups"
                err = {"y": max_err(y_k, yp.detach()), "dx": max_err(dx, dxp),
                       "dweight": max_err(dw, dwp), "dbias": max_err(db, dbp)}
                for k, ref, rel in (("y", yp.detach(), 1e-5), ("dx", dxp, 1e-5),
                                    ("dweight", dwp, 1e-4), ("dbias", dbp, 1e-4)):
                    check(f"{where} {k}", err[k], rel * float(ref.abs().max()))
                row["err"] = err
                # ms (cold) [kernel, plain, library] forward and backward, as
                # k1_training_checks times them at the whole widths
                act = F.silu if silu else (lambda v: v)
                xl, wl, bl = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
                yl = act(F.group_norm(xl, groups, wl, bl, 1e-6))
                with torch.no_grad():
                    row["fwd_ms"] = [round(cuda_ms(f, 10), 4) for f in (
                        lambda: K1.group_norm_act(x, w, b, groups, 1e-6, silu=silu),
                        lambda: K1.group_norm_act_plain(x, w, b, groups, 1e-6, silu=silu),
                        lambda: act(F.group_norm(x, groups, w, b, 1e-6)))]
                    bwd_k = cuda_ms(lambda: K1.group_norm_act_backward(x, dy, w, b, mr, silu,
                                                                       True), 10)
                row["bwd_ms"] = [round(t, 4) for t in (
                    bwd_k,
                    cuda_ms(lambda: torch.autograd.grad(yp, (xp, wp, bp), dy, retain_graph=True),
                            10),
                    cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True),
                            10))]
                n = x.numel()
                row["bound_ms"] = [round(bound_ms(8 * n, 10 * n)[0], 4),
                                   round(bound_ms(12 * n, 20 * n)[0], 4)]
                del xp, yp, dxp, dwp, dbp, y_k, dx, dw, db, xl, yl
            with torch.no_grad():
                mr = K1._launch_forward(x, w, b, groups, 1e-6, silu)[1]
                fwd = device_us_per_launch(lambda: K1._launch_forward(x, w, b, groups, 1e-6, silu),
                                           ("gn_stats_kernel", "gn_apply_kernel"), 10)
                bwd = device_us_per_launch(
                    lambda: K1.group_norm_act_backward(x, dy, w, b, mr, silu, True),
                    ("gn_bwd_stats_kernel", "gn_bwd_apply_kernel"), 10)
                row[what + "_device_us"] = [round(sum(fwd.values()), 1),
                                            round(sum(bwd.values()), 1)]
            del x, dy, mr
            torch.cuda.empty_cache()
        rows.append(row)
    return rows


def tp_state_checks(where: str, worst: dict) -> None:
    """A tp run's gathered state against one process: ``mesh_compare``'s
    readings held to TP_GRAD_LIMIT and TP_PARAM_TOL."""
    for what in ("grads", "mu", "nu"):
        check(f"{where} {what}: largest error over the gradient rule", worst[what],
              TP_GRAD_LIMIT)
    for what in ("params", "ema"):
        check(f"{where} {what}: largest difference", worst[what + "_max_diff"], TP_PARAM_TOL)


def mesh_tp_phase(dev, ref, ranks2) -> None:
    """(e), (f) and (g): the tp runs' checks against the one-process runs,
    the tp=2 checkpoint resumed at tp=1, the world of four, K1 at the local
    shapes; their seconds on a line of their own."""
    import torch
    t0 = time.perf_counter()
    # (e): each rank's steps against the one process, its K1 calls at the local shapes
    tp = [rk["tp"] for rk in ranks2]
    whole_shapes = {(s[1], g) for s, g, _ in ref["gn_shapes"]}
    local_shapes = {(c // 2, g // 2) for c, g in whole_shapes}
    if tp[0]["replicated_digest"] != tp[1]["replicated_digest"]:
        raise AssertionError("(e) the ranks' replicated leaves differ")
    if not tp[0]["whole"] or tp[1]["whole"]:
        raise AssertionError("(e) the gathered state is not on the first rank alone")
    for r, rk in enumerate(tp):
        if rk["mesh"] != {"dp": 1, "tp": 2} or rk["coords"] != {"dp": 0, "tp": r}:
            raise AssertionError(f"(e) rank {r}: mesh {rk['mesh']} coords {rk['coords']}")
        for i, (s, s_ref) in enumerate(zip(rk["steps"], ref["tp2"])):
            for what in ("loss", "grad_norm"):
                check(f"(e) tp2 rank {r} step {i} {what} (relative)",
                      abs(s[what] - s_ref[what]) / abs(s_ref[what]), 1e-4)
            sharded = {(c, g) for c, g, on in s["gn"] if on}
            if min(s["launches"]) == 0 or not local_shapes <= sharded:
                raise AssertionError(f"(e) rank {r} step {i}: K1 / K2 launches {s['launches']}, "
                                     f"K1 sharded at {sorted(sharded)}, expected "
                                     f"{sorted(local_shapes)}")
    tp_state_checks("(e)", tp[0]["compare"])
    ratio = tp[0]["state_bytes"] / ref["tp2_state_bytes"]
    if ratio > TP_STATE_RATIO:
        raise AssertionError(f"(e) a rank's parameter + Adam + EMA bytes are {ratio:.4f} of one "
                             f"process's")
    # the tp=2 checkpoint at tp=1, bit for bit with the gathered state
    whole = torch.load(os.path.join(MESH_DIR, "tp2_whole.pt"))
    one, _ = build_trainer(dev, mesh_train_overrides([
        "exp.mesh.dp=1", "exp.resume=True", f"exp.resume_checkpoint={tp[0]['checkpoint']}"]),
        loader=ReplayLoader([]))
    same = one.it == MESH_TP[1] and one.count == MESH_TP[1] and all(
        torch.equal(getattr(one, w)[k].cpu(), v) for w in ("params", "ema", "mu", "nu")
        for k, v in whole[w].items())
    if not same:
        raise AssertionError("(e) the checkpoint written at tp=2 does not resume at tp=1 bit for "
                             "bit")
    del one, whole
    torch.cuda.empty_cache()
    e = {"loss": [round(s["loss"], 6) for s in tp[0]["steps"]],
         "loss_one_process": [round(s["loss"], 6) for s in ref["tp2"]],
         "grad_norm": [round(s["grad_norm"], 6) for s in tp[0]["steps"]],
         "ms_per_step_by_rank": [[round(s["ms"], 1) for s in rk["steps"]] for rk in tp],
         "ms_per_step_one_process": [round(s["ms"], 1) for s in ref["tp2"]],
         "tp_collectives_a_step_rank0": [{"MB": round(s["tp_bytes"] / 1e6, 1),
                                          "ms": round(s["tp_ms"], 1),
                                          "all_gathers": s["tp_gathers"],
                                          "all_reduces": s["tp_reduces"]}
                                         for s in tp[0]["steps"]],
         "k1_fwd_bwd_k2_an_syn_launches_a_step": [s["launches"] for s in tp[0]["steps"]],
         "k1_local_channels_groups": sorted(local_shapes),
         "state_bytes_by_rank": [rk["state_bytes"] for rk in tp],
         "state_bytes_one_process": ref["tp2_state_bytes"], "state_ratio": round(ratio, 4),
         "peak_gib_by_rank": [round(rk["peak_gib"], 2) for rk in tp],
         "peak_gib_one_process": round(ref["tp2_peak_gib"], 2),
         "worst_error_over_tolerance": tp[0]["compare"],
         "rank_seconds": [round(rk["seconds"], 1) for rk in tp]}
    log(f"(e) the full-width network ({ref['tp2_params'] / 1e6:.2f} M params) trained at "
        f"exp.mesh.dp=1 x tp=2 on two ranks of the one card over gloo (CUDA tensors), float32, "
        f"a global batch of {MESH_BATCH} x 65536, deterministic cuDNN, 2 steps against one process "
        f"at the same batches and draws: loss and grad norm every step (1e-4 relative), the "
        f"gradients, moments, parameters and EMA gathered to rank 0 after the last "
        f"(within {TP_GRAD_LIMIT} times gradient_tolerances' rule; {TP_PARAM_TOL}), the "
        f"replicated leaves bit for bit "
        f"between the ranks, K1 forward and backward at the local channels and groups and K2 in "
        f"every rank's step, the checkpoint written at tp=2 resumed at tp=1 bit for bit; two "
        f"processes share one card, so these ms are not a two-card figure: " + json.dumps(e))

    # (f): a world of four at dp=2 x tp=2, nf=16, remat
    t1 = time.perf_counter()
    ranks4 = mesh_world(4)
    t_world4 = time.perf_counter() - t1
    f4 = [rk["tp"] for rk in ranks4]
    lines = [r for r, rk in enumerate(f4) if rk["whole"]]
    tp_state_checks("(f)", f4[0]["compare"])
    if lines != [0, 2] or f4[0]["digest"] != f4[2]["digest"]:
        raise AssertionError(f"(f) the tp lines' first ranks {lines} and their gathered states "
                             f"differ")
    if len({rk["replicated_digest"] for rk in f4}) != 1:
        raise AssertionError("(f) the ranks' replicated leaves differ")
    for r, rk in enumerate(f4):
        s, s_ref = rk["steps"][0], ref["tp4"][0]
        for what in ("loss", "grad_norm"):
            check(f"(f) rank {r} {what} (relative)", abs(s[what] - s_ref[what]) / abs(s_ref[what]),
                  1e-4)
        if min(s["launches"]) == 0 or s["tp_gathers"] <= rk["forward_gathers"]:
            raise AssertionError(f"(f) rank {r}: launches {s['launches']}, all-gathers "
                                 f"{s['tp_gathers']} a step against {rk['forward_gathers']} a "
                                 f"forward")
    log(f"(f) nf=16 with remat at exp.mesh.dp=2 x tp=2 on four ranks of the one card over gloo, "
        f"one step at a global batch of {MESH_BATCH} x 65536 against one process: loss and grad "
        f"norm on every rank (1e-4 relative), the state gathered on each tp line's first rank "
        f"(ranks 0 and 2, equal digests) against the one process's, the replicated leaves bit "
        f"for bit on all four; the step's tp all-gathers {f4[0]['steps'][0]['tp_gathers']} "
        f"against a forward's {f4[0]['forward_gathers']} (remat's recomputation gathers again): "
        + json.dumps({"loss": [round(rk["steps"][0]["loss"], 6) for rk in f4],
                      "loss_one_process": round(ref["tp4"][0]["loss"], 6),
                      "worst_error_over_tolerance": f4[0]["compare"],
                      "ms_by_rank": [round(rk["steps"][0]["ms"], 1) for rk in f4],
                      "world_s": round(t_world4, 1)}))

    # (g): K1 at the local shapes beside the whole width
    t1 = time.perf_counter()
    rows = k1_tp_checks(dev, ref["gn_shapes"])
    t_g = time.perf_counter() - t1
    log("(g) K1 float32 at the local shapes of (e) (C/2 channels in G/2 groups) against its "
        "plain version (y, dx at 1e-5, d weight and d bias at 1e-4 of their peaks); device us a "
        "launch cold [fwd, bwd], local beside whole width; at the local shape ms cold [kernel, "
        "plain, library] forward and backward and the byte bound [fwd, bwd]: " + json.dumps(rows))
    log(f"phase 10 (e)-(g): {time.perf_counter() - t0 + ref['tp2_s'] + ref['tp4_s'] + max(tp[0]['seconds'], tp[1]['seconds']):.1f} s "
        f"(one-process references {ref['tp2_s'] + ref['tp4_s']:.1f} s, (e) in the world of two "
        f"{max(tp[0]['seconds'], tp[1]['seconds']):.1f} s a rank, the world of four "
        f"{t_world4:.1f} s, (g) {t_g:.1f} s)")


def mesh_phase(dev) -> None:
    """Phase 10: (a) the CLIs under torchrun; (b) and (c) on two ranks of
    the one card (gloo on CUDA tensors, spawned here) against one process;
    (d) the spectrogram."""
    import numpy as np
    import torch
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    write_paired_set(os.path.join(MESH_DIR, "data"), load_wavs("clean", 8, 65536)[:, 0], seed=11)
    batches = mesh_batches()
    np.savez(os.path.join(MESH_DIR, "batches.npz"), **{f"b{i}": b for i, b in enumerate(batches)})
    mesh_clis(dev)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    t0 = time.perf_counter()
    ref_train = mesh_train_reference(dev, batches)
    ref_tester = mesh_tester_reference(dev)
    t_ref = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_world()
    t_world = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False

    # (b): each rank against the one process, and the ranks' bits
    train = {}
    for case, (_, steps, _) in MESH_TRAIN.items():
        a, b = ranks[0]["train"][case], ranks[1]["train"][case]
        if a["digest"] != b["digest"]:
            raise AssertionError(f"(b) {case}: the ranks' parameters, EMA and moments differ "
                                 f"({a['digest']} / {b['digest']})")
        for r, rk in enumerate((a, b)):
            for i, (s, s_ref) in enumerate(zip(rk["steps"], ref_train[case])):
                for what in ("loss", "grad_norm"):
                    check(f"(b) {case} rank {r} step {i} {what} (relative)",
                          abs(s[what] - s_ref[what]) / abs(s_ref[what]), 1e-4)
                if min(s["launches"]) == 0:
                    raise AssertionError(f"(b) {case} rank {r} step {i}: K1 / K2 launches "
                                         f"{s['launches']}")
        train[case] = {
            "mesh": a["mesh"], "loss": [round(s["loss"], 6) for s in a["steps"]],
            "loss_one_process": [round(s["loss"], 6) for s in ref_train[case]],
            "grad_norm": [round(s["grad_norm"], 6) for s in a["steps"]],
            "ms_per_step_by_rank": [[round(s["ms"], 1) for s in rk["steps"]] for rk in (a, b)],
            "ms_per_step_one_process": [round(s["ms"], 1) for s in ref_train[case]],
            "all_reduce_ms_by_rank": [[round(v, 1) for v in rk["all_reduce_ms"]]
                                      for rk in (a, b)],
            "k1_fwd_bwd_k2_an_syn_launches_a_step": [s["launches"] for s in a["steps"]],
            "worst_error_over_tolerance_rank0": a["compare"],
            "worst_error_over_tolerance_rank1": b["compare"], "digest": a["digest"]}
    log(f"(b) the full-width network ({ref_train['dp2_params'] / 1e6:.2f} M params) trained "
        f"at a global batch of {MESH_BATCH} x 65536, float32, deterministic cuDNN, on two "
        f"ranks of the one card over gloo (CUDA tensors): 2 steps at dp=2, 1 at dp=1 x sp=2, "
        f"each against one process at the same global batch and draws: loss and grad norm "
        f"every step (1e-4 relative), gradients, moments, parameters and EMA after the last "
        f"(gradient_tolerances' rule; {MESH_PARAM_TOL}), both ranks bit for bit; K1 and K2 in "
        f"every rank's step; two processes share one card, so these ms are not a two-card figure: "
        + json.dumps(train))

    # (c): the first rank's gathered outputs against the one-process runs
    t0_, t1_ = ranks[0]["tester"], ranks[1]["tester"]
    if t0_["written"] != 8 or t1_["written"] != 0 or t1_["files"]:
        raise AssertionError(f"(c) rank 0 wrote {t0_['written']} items, rank 1 {t1_['written']} "
                             f"and files {t1_['files'][:4]}")
    blind = [f for f in t0_["files"] if f.startswith("mesh/blind_dereverberation/")]
    n_wav = sum(f.endswith(".wav") for f in blind)
    unc_files = [f for f in t0_["files"] if f.endswith(".wav") and "unconditional" in f]
    if n_wav != 40 or len(unc_files) != 2:
        raise AssertionError(f"(c) rank 0's files: {n_wav} blind WAVs, {unc_files}")
    with np.load(os.path.join(MESH_DIR, "tester_rank0.npz")) as f:
        got = {k: f[k] for k in f.files}
    for kind in ("pred", "est"):
        for name, ref in ref_tester[kind].items():
            ours = got[f"{kind}/{name}"]
            if not np.array_equal(ours, ref):
                raise AssertionError(f"(c) {kind} {name}: the two ranks' run differs from the "
                                     f"one process's (max {float(np.abs(ours - ref).max()):.3e})")
    if len(ref_tester["pred"]) != 8:
        raise AssertionError(f"(c) the one-process runs wrote {sorted(ref_tester['pred'])}")
    for r in range(2):
        if not np.array_equal(got["unconditional"][r], ref_tester["unconditional"][r][0]):
            raise AssertionError(f"(c) unconditional row {r} differs from the one process's")
    if not np.isfinite(got["unconditional"]).all():
        raise AssertionError("(c) unconditional samples not finite")
    sampler_ms = [t0_["sampler_ms_per_step_cold_warm"], t1_["sampler_ms_per_step_cold_warm"]]
    log(f"(c) Tester.do_test() blind on two ranks of the one card over gloo (full width, bf16, "
        f"batch 8 x 65536 split 4 a rank, T=2, 10 updates a step, WPE warm init, deterministic "
        f"cuDNN): the first rank's gathered 8 predictions and estimated RIRs bit for bit equal "
        f"to one process running each rank's 4 utterances with that rank's draw rows; rank 0 "
        f"wrote 5 directories of 8 finite WAVs (+ metrics), rank 1 none; 2 unconditional "
        f"samples at dp=2, each rank's row bit for bit equal to one process's; sampler ms a "
        f"step by rank, cold and warm (two processes on one card): {sampler_ms}; the "
        f"one-process references took {t_ref:.1f} s, the world of two {t_world:.1f} s")
    mesh_spectrogram(dev)
    mesh_tp_phase(dev, ref_train, ranks)
    # only the ranks' results are kept: the state files, checkpoints, WAV
    # sets and arrays would take chiprun_out/ past what a run brings back
    for name in os.listdir(MESH_DIR):
        p = os.path.join(MESH_DIR, name)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif not (name.startswith("world") and name.endswith(".json")):
            os.remove(p)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "buddy_tpu_torch")):
        print("chip_smoke: buddy_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(LOG_PATH):
        os.remove(LOG_PATH)
    from buddy_tpu_torch.device import resolve_device
    from buddy_tpu_torch.ops import (_build, filter_design as K6, groupnorm as K1, minphase as K5,
                                     spec_loss as K4, subband_conv as K3, wpe_solve as K7)
    K2 = importlib.import_module("buddy_tpu_torch.ops.stft")

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(_build.build_host)       # g++ beside the nvcc processes
        built = _build.build()
        host_s = host.result()
    regs = []
    for name in _build.SOURCES:
        with open(_build.library_path(name)[:-3] + ".log") as f:
            regs += [ln.strip() for ln in f if "registers" in ln]
    log(f"build: nvcc sm_90a {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(parallel); ptxas: {' | '.join(regs)}")
    log(f"build: the data pipeline's host library (csrc/wavio.cpp, csrc/loader.cpp; "
        f"{' '.join(_build.HOST_FLAGS)}) "
        + (f"in {host_s:.1f} s" if host_s is not None else "already built")
        + f": {os.path.relpath(_build.host_library_path(), REPO)}")

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
        "int8_conv": ("cuda", "buddy_tpu_torch/csrc/qconv.cu", "buddy_tpu/ops/qconv.py:97"),
        "int8_conv_sm90": ("cuda", "buddy_tpu_torch/csrc/qconv_sm90.cu",
                           "buddy_tpu/ops/qconv.py:97"),
        "quantize_act": ("cuda", "buddy_tpu_torch/csrc/qconv.cu", "buddy_tpu/ops/qconv.py:65"),
        "quantize_weight": ("cuda", "buddy_tpu_torch/csrc/qconv.cu",
                            "buddy_tpu/ops/qconv.py:81"),
    }
    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    checks.update(fused_kernel_checks(dev))
    lengths = new_lengths(dev)
    check_digests(dev)
    added = {}                                      # the fast profile's and functional STFT's seconds
    t1 = time.perf_counter()
    functional = functional_stft_checks(dev)
    added["functional stft/istft (phase 3)"] = time.perf_counter() - t1
    log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checks.update(k10_checks(dev))
    log(f"K10 and K8 checks done in {time.perf_counter() - t0:.1f} s")
    checks["stft_analysis"]["extra"]["chirp_route"] = {
        n: {"device_us": v["device_us_cold"][0], "err": v["err"][0]}
        for n, v in lengths["stft"].items()}
    checks["stft_synthesis"]["extra"]["chirp_route"] = {
        n: {"device_us": v["device_us_cold"][1], "err": v["err"][1]}
        for n, v in lengths["stft"].items()}
    for i, what in enumerate(("minphase_fwd", "minphase_bwd")):
        checks[what]["extra"]["other_lengths"] = {
            L: {"route": v["route"], "device_us": v["device_us_cold"][i], "err": v["err"][i]}
            for L, v in lengths["minphase"].items()}

    checks["stft_analysis"]["extra"]["functional"] = functional
    checks["stft_synthesis"]["extra"]["functional"] = {
        k: functional[k] for k in ("launches", "torch_istft_refused", "ms_cold")}

    launches, _ = main_path(dev, wrappers)
    added["informed identity (phase 5)"] = other_modes(dev)
    runs = serving_and_int8_runs(dev, wrappers)
    added["fast serving profile (phase 8)"] = runs["serving_identity"]["seconds"]
    train = training_path(dev, wrappers)
    training_clis(dev)
    small = {"full": small_reference(dev)}
    t1 = time.perf_counter()
    small["identity"] = small_reference(dev, "identity")
    apart = [max_err(small["identity"][i], small["full"][i]) / float(small["full"][i].abs().max())
             for i in (0, 1)]
    if min(apart) < 1e-2:
        raise AssertionError(f"small program: identity and full guidance {apart} of the peak "
                             f"apart (card, CPU): the switch does not act")
    log(f"small blind program: identity and full guidance end {apart[0]:.3f} (card) and "
        f"{apart[1]:.3f} (CPU) of the peak apart")
    added["small identity program card vs CPU (phase 7)"] = time.perf_counter() - t1
    log("the fast serving profile's and the functional STFT's parts, seconds: "
        + json.dumps({k: round(v, 1) for k, v in added.items()})
        + f", {sum(added.values()):.1f} in all")
    small_int8 = small_reference_int8(dev)
    train_step_card_vs_cpu(dev)
    t0 = time.perf_counter()
    fir_run, fir_record = fir_blind_run(dev, wrappers)
    t1 = time.perf_counter()
    fir = fir_op_checks(dev, fir_record)
    k11_s = time.perf_counter() - t1
    remat_training(dev, wrappers)
    config_space_card_vs_cpu(dev)
    log(f"phase 9 (the rest of NCSN++'s configuration space) in {time.perf_counter() - t0:.1f} s, "
        f"of which K11's checks {k11_s:.1f} s")
    t0 = time.perf_counter()
    mesh_phase(dev)
    log(f"phase 10 (the device mesh over torch.distributed) in {time.perf_counter() - t0:.1f} s")

    # K10's launches are those of the int8 dynamic run (quantize_bwd, fused
    # up-blocks: every wrapper; the sm90 route), the static run's beside
    # them; the mma route's those of the small int8 program
    for name in ("int8_conv_sm90", "quantize_act", "quantize_weight"):
        launches[name] = runs["int8_dynamic"]["k10_launches"][name]
        checks[name]["extra"]["launches_int8_static"] = runs["int8_static"]["k10_launches"][name]
    launches["int8_conv"] = small_int8["launches"]
    checks["int8_conv"]["extra"]["launches_from"] = "the small int8 program (phase 7, nf=16)"
    checks["int8_conv"]["extra"]["own_shapes"] = small_int8["shapes"]

    # K1's float32 rows come from the training path, its launches from the
    # training loop's run; K2 also reports its launches a train step
    checks.update(train["entries"])
    for name in ("groupnorm_silu_fwd", "groupnorm_silu_bwd"):
        meta[name + "_f32"] = meta[name]
        launches[name + "_f32"] = train["launches"][name]
    for name in ("stft_analysis", "stft_synthesis"):
        checks[name]["extra"]["training_launches_per_step"] = train["per_step"][name]
        what = name.split("_")[1]
        checks[name]["extra"]["training_shape"] = {k: train["k2"][k]
                                                   for k in (what, what + "_bwd")}
    for name, count in runs["serving_identity"]["port_launches"].items():
        checks[name]["extra"]["launches_fast_serving"] = count
    # K11's rows: the top blocks of phase 9, their launches those of run (a)
    for name, (label, i) in K11_ROWS.items():
        c, d = fir[label], fir[label]["vjp" if i else "fwd"]
        meta[name] = ("cuda", "buddy_tpu_torch/csrc/upfirdn.cu", "buddy_tpu/ops/resample.py:33")
        launches[name] = fir_run["k11_launches_by_row"][name]
        checks[name] = {"err": c["err"][i], "tol": c["tol"][i], "bound": d["bound"],
                        "times": (d["ms"], d["plain_ms"], d["library_ms"]),
                        "shape": c["y"] if i else c["x"],
                        "extra": {"kernel": K11_KERNEL, "device_us": d["device_us"],
                                  "device_us_warm": d["device_us_warm"],
                                  "launches_from": "phase 9 run (a), T=2",
                                  "library": "the depthwise library convolution the port "
                                             "ran before K11"}}
    checks["upfirdn_up"]["extra"]["device_us_other_geometries"] = {
        k: [v["fwd"]["device_us"], v["vjp"]["device_us"]] for k, v in fir.items()}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        c = checks[name]
        ms, plain_ms, lib_ms = c["times"]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": c["err"], "tolerance": c["tol"],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": c["bound"][0],
                        "bound_by": c["bound"][1], "library_ms": lib_ms, "shape": c["shape"],
                        **c.get("extra", {})})
    log(f"profiler windows: {_PROFILE['windows']} ({PROFILE_PAD_S} s idle at each end), taken "
        f"again (launches missing): {_PROFILE['retaken']}; calls timed with CUDA events after "
        f"{PROFILE_TRIES} such windows: {_PROFILE['events']}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(main())
