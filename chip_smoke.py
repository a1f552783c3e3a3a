#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``buddy_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card

Phases, each printing one line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. building the CUDA kernels (K2, K3) from ``buddy_tpu_torch/csrc`` with
   nvcc, one process per source, all at once (Triton's K1 compiles at its
   first launch, in phase 3);
3. each kernel at the main path's shapes and dtypes (K2 at its three
   geometries: operator, model, WPE), forward and backward,
   against its plain PyTorch version on the same inputs, with the stated
   tolerance, and timed beside its plain version and a PyTorch library call
   (the yardstick; the port never calls it);
4. the main path: blind BUDDy dereverberation of the 8 in-repo degraded
   utterances (65536 samples) with the full-width network of
   conf/network/ncsnpp.yaml (random weights from a seed, bf16 body), full
   guidance, 10 operator updates per step, T cut to 4 steps, built with the
   port's compose + instantiate; every kernel's launch count must be > 0;
   then one more run under torch.profiler: device time of each of the
   port's kernels and of the rest, and the device's idle share (the
   per-kernel table goes to chiprun_out/);
5. the same program at a small size on the card (kernels) and on the CPU
   (plain versions) with the same weights and noise: the outputs must agree.

A JSON line of the kernels' results precedes the last line, which is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero without that line.  It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_STEPS = 4                     # diffusion steps of the main-path run (T=201 in the tester)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Device time of fn() in ms (CUDA events): the median over ``repeats``
    of the mean over ``reps`` back-to-back launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_checks(dev):
    import torch
    import torch.nn.functional as F
    from buddy_tpu_torch.ops import groupnorm as K1, stft as K2, subband_conv as K3
    from buddy_tpu_torch.ops.dft import good_fft_size
    from buddy_tpu_torch.ops.stft import STFT, hann_window
    import numpy as np

    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, dtype=torch.float32: torch.randn(s, generator=g, device=dev, dtype=dtype)
    crand = lambda *s: torch.complex(rand(*s), rand(*s))
    entries = {}

    # --- K1 GroupNorm + SiLU, the U-Net's four GN shapes, bf16 ----------------
    gn_shapes = [(8, 128, 256, 528), (8, 256, 128, 264), (8, 256, 64, 132), (8, 256, 32, 66)]
    for i, (B, C, H, W) in enumerate(gn_shapes):
        x = (rand(B, C, H, W) * 2 + 0.3).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w, b = 1 + 0.1 * rand(C), 0.1 * rand(C)
        G = min(C // 4, 32)
        dy = rand(B, C, H, W).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        y_k = K1.group_norm_act(x, w, b, G, 1e-6, silu=True)
        y_p = K1.group_norm_act_plain(x, w, b, G, 1e-6, silu=True)
        # both normalise in float32 and round once to bf16: <= 1 bf16 ulp
        # (2^-7 relative) at the largest output
        tol = 2.0 ** -7 * float(y_p.abs().max())
        err_f = max_err(y_k.float(), y_p.float())
        check(f"groupnorm fwd {x.shape}", err_f, tol)
        xk = x.detach().requires_grad_(True)
        xp = x.detach().requires_grad_(True)
        wk, wp = w.clone().requires_grad_(True), w.clone().requires_grad_(True)
        K1.group_norm_act(xk, wk, b, G, 1e-6, silu=True).backward(dy)
        K1.group_norm_act_plain(xp, wp, b, G, 1e-6, silu=True).backward(dy)
        # dx: float32 inside both, rounded to bf16; 2 ulps of the largest
        tol_b = 2.0 ** -6 * float(xp.grad.abs().max())
        err_b = max_err(xk.grad.float(), xp.grad.float())
        check(f"groupnorm bwd dx {x.shape}", err_b, tol_b)
        check(f"groupnorm bwd dweight {x.shape}", max_err(wk.grad, wp.grad),
              1e-3 * float(wp.grad.abs().max()))
        if i == 0:
            n = x.numel()
            _, mean, rstd, a, sh = K1._launch_forward(x, w, b, G, 1e-6, True)
            yp_graph = K1.group_norm_act_plain(xp, w, b, G, 1e-6, silu=True)
            xl = x.detach().requires_grad_(True)
            wl, bl = w.to(x.dtype), b.to(x.dtype)      # F.group_norm wants one dtype
            yl = F.silu(F.group_norm(xl, G, wl, bl, 1e-6))
            with torch.no_grad():
                t_fwd = (cuda_ms(lambda: K1.group_norm_act(x, w, b, G, 1e-6, silu=True)),
                         cuda_ms(lambda: K1.group_norm_act_plain(x, w, b, G, 1e-6, silu=True)),
                         cuda_ms(lambda: F.silu(F.group_norm(x, G, wl, bl, 1e-6))))
            t_bwd = (cuda_ms(lambda: K1.group_norm_act_backward(x, dy, w, mean, rstd, a, sh, True)),
                     cuda_ms(lambda: torch.autograd.grad(yp_graph, xp, dy, retain_graph=True)),
                     cuda_ms(lambda: torch.autograd.grad(yl, xl, dy, retain_graph=True)))
            shape = list(x.shape)
            entries["groupnorm_silu_fwd"] = dict(
                err=err_f, tol=tol, times=t_fwd, shape=shape, bound=bound_ms(4 * n, 10 * n))
            entries["groupnorm_silu_bwd"] = dict(
                err=err_b, tol=tol_b, times=t_bwd, shape=shape, bound=bound_ms(6 * n, 20 * n))
    log(f"kernel K1 groupnorm+silu: fwd/bwd match the plain version at {gn_shapes}")

    # --- K2 STFT / ISTFT at the main path's three geometries -----------------
    # operator: 1024/128, hann(512) right-padded, constant, on apply_stft's
    # win_length-right-padded signal; model: 510/128 reflect, the synthesis
    # at the 528 frames of pad_spec_frames; WPE warm init: 512/128 constant
    geometries = {
        "operator": (1024, np.pad(hann_window(512), (0, 512)), "constant", 65536 + 512, None),
        "model": (510, hann_window(510), "reflect", 65536, 528),
        "wpe": (512, hann_window(512), "constant", 65536, None),
    }
    for gname, (n_fft, window, pad_mode, length, frames) in geometries.items():
        geom = STFT(n_fft, 128, window, pad_mode=pad_mode, device=dev)
        wt = torch.as_tensor(window, device=dev)
        x = rand(8, length)
        blocks, T = geom.frame_blocks(x)
        spec_k = K2.stft_analysis(blocks, geom.A, geom.A_adj, T)
        spec_a = K2.analysis_plain(blocks, geom.A, T).contiguous()
        tol_a = 1e-4 * float(spec_a.abs().max())   # float32 sums of ~512 products
        err_a = max_err(torch.view_as_real(spec_k), torch.view_as_real(spec_a))
        check(f"stft_analysis {gname}", err_a, tol_a)
        spec = F.pad(spec_a, (0, frames - T)) if frames else spec_a
        y_k = K2.stft_synthesis(spec, geom.V, geom.V_adj)
        y_p = K2.synthesis_plain(spec, geom.V)
        tol_s = 1e-4 * float(y_p.abs().max())      # float32 sums of 4 x 2F products
        err_s = max_err(y_k, y_p)
        check(f"stft_synthesis {gname}", err_s, tol_s)
        # backward: each kernel's adjoint is the other kernel, against autograd of the plain
        gspec = crand(*spec_a.shape)
        bk, bp = blocks.detach().requires_grad_(True), blocks.detach().requires_grad_(True)
        K2.stft_analysis(bk, geom.A, geom.A_adj, T).backward(gspec)
        K2.analysis_plain(bp, geom.A, T).backward(gspec)
        err_ab = max_err(bk.grad, bp.grad)
        check(f"stft_analysis bwd {gname}", err_ab, 1e-4 * float(bp.grad.abs().max()))
        gy = rand(*y_p.shape)
        sk, sp = spec.detach().requires_grad_(True), spec.detach().requires_grad_(True)
        K2.stft_synthesis(sk, geom.V, geom.V_adj).backward(gy)
        K2.synthesis_plain(sp, geom.V).backward(gy)
        err_sb = max_err(torch.view_as_real(sk.grad), torch.view_as_real(sp.grad))
        check(f"stft_synthesis bwd {gname}", err_sb, 1e-4 * float(sp.grad.abs().max()))
        # the synthesis's library call: the transposed conv over hop-blocks
        # that the TPU's _istft_conv is built on, with V as its weight
        z = torch.cat([spec.real, spec.imag], 1).contiguous()            # (N, 2F, T)
        wct = geom.V.permute(1, 0, 2).reshape(2 * geom.n_bins, 1, -1).contiguous()
        conv_t = lambda: F.conv_transpose1d(z, wct, stride=geom.hop)
        check(f"stft_synthesis {gname} (library)", max_err(conv_t()[:, 0], y_p),
              1e-3 * float(y_p.abs().max()))
        with torch.no_grad():
            t_a = (cuda_ms(lambda: K2.stft_analysis(blocks, geom.A, geom.A_adj, T)),
                   cuda_ms(lambda: K2.analysis_plain(blocks, geom.A, T)),
                   cuda_ms(lambda: torch.stft(x, n_fft, 128, window=wt, center=True,
                                              pad_mode=pad_mode, return_complex=True)))
            t_s = (cuda_ms(lambda: K2.stft_synthesis(spec, geom.V, geom.V_adj)),
                   cuda_ms(lambda: K2.synthesis_plain(spec, geom.V)), cuda_ms(conv_t))
            # torch.istft refuses the operator's half-zero window (its
            # overlap-add check), so it is timed at the other two geometries
            t_istft = None if gname == "operator" else cuda_ms(
                lambda: torch.istft(spec, n_fft, 128, window=wt, center=True, length=length))
        flops = 2.0 * 8 * T * 2 * geom.n_bins * geom.taps * geom.hop
        log(f"kernel K2 stft, {gname} geometry ({n_fft}/128, {pad_mode}): blocks "
            f"{list(blocks.shape)} -> spec {list(spec.shape)}; max abs err fwd {err_a:.3e}/{err_s:.3e} "
            f"bwd {err_ab:.3e}/{err_sb:.3e} (analysis/synthesis; tolerance 1e-4 of the peak); ms "
            f"kernel/plain/library: analysis {[round(t, 4) for t in t_a]} (torch.stft), synthesis "
            f"{[round(t, 4) for t in t_s]} (conv_transpose1d), torch.istft "
            f"{'refused' if t_istft is None else round(t_istft, 4)}")
        if gname == "operator":                    # the kernels line reports this geometry
            entries["stft_analysis"] = dict(
                err=err_a, tol=tol_a, shape=list(blocks.shape), times=t_a,
                bound=bound_ms(4 * blocks.numel() + 4 * geom.A.numel() + 8 * spec_a.numel(), flops))
            entries["stft_synthesis"] = dict(
                err=err_s, tol=tol_s, shape=list(spec.shape), times=t_s,
                bound=bound_ms(8 * spec.numel() + 4 * geom.V.numel() + 4 * y_p.numel(), flops))

    # --- K3 subband convolution (B=8, F=513, T=517, Nf=100, pre=1) ----------------
    Bn, Fb, Tf, Nf, pre = 8, 513, 517, 100, 1      # Tf: the operator geometry's frames
    X, Hf, Gy = crand(Bn, Fb, Tf), crand(Bn, Fb, Nf), crand(Bn, Fb, Tf)
    outs = {
        "subband_conv": (lambda: K3.subband_conv(X, Hf, pre),
                         lambda: K3.subband_conv_plain(X, Hf, pre)),
        "subband_conv_adjoint": (lambda: K3.subband_conv_adjoint(Gy, Hf, pre),
                                 lambda: K3.subband_conv_adjoint_plain(Gy, Hf, pre)),
        "subband_conv_filter_grad": (lambda: K3.subband_conv_filter_grad(Gy, X, Nf, pre),
                                     lambda: K3.subband_conv_filter_grad_plain(Gy, X, Nf, pre)),
    }
    n_fft = good_fft_size(Tf + Nf - 1)
    fft, ifft = torch.fft.fft, torch.fft.ifft
    library = {   # FFT convolution / correlation with torch.fft
        "subband_conv": lambda: ifft(fft(X, n_fft) * fft(Hf, n_fft))[..., pre:pre + Tf],
        "subband_conv_adjoint": lambda: torch.roll(
            ifft(fft(Gy, n_fft) * fft(Hf, n_fft).conj()), pre, -1)[..., :Tf],
        "subband_conv_filter_grad": lambda: torch.roll(
            ifft(fft(Gy, n_fft) * fft(X, n_fft).conj()), pre, -1)[..., :Nf],
    }
    t_idx = np.arange(Tf)
    pairs = float(np.sum(np.minimum(Nf - 1, t_idx + pre) - np.maximum(0, t_idx + pre - Tf + 1) + 1))
    flops = 8.0 * Bn * Fb * pairs                  # complex MAC = 8 real operations
    nbytes = {"subband_conv": 8 * (2 * X.numel() + Hf.numel()),
              "subband_conv_adjoint": 8 * (2 * Gy.numel() + Hf.numel()),
              "subband_conv_filter_grad": 8 * (Gy.numel() + X.numel() + Hf.numel())}
    with torch.no_grad():
        for name, (kern, plain) in outs.items():
            ok, op = kern(), plain()
            tol = 1e-4 * float(op.abs().max())     # float32 sums of 100 complex products
            err = max_err(torch.view_as_real(ok), torch.view_as_real(op))
            check(name, err, tol)
            check(f"{name} (library)", max_err(torch.view_as_real(library[name]()),
                                                torch.view_as_real(op)), 1e-3 * float(op.abs().max()))
            entries[name] = dict(err=err, tol=tol, shape=[Bn, Fb, Tf, Nf],
                                 times=(cuda_ms(kern), cuda_ms(plain), cuda_ms(library[name])),
                                 bound=bound_ms(nbytes[name], flops))
    log(f"kernel K3 subband conv: fwd/adjoint/filter-grad match the plain version at "
        f"X {list(X.shape)}, H {list(Hf.shape)}")
    return entries


# ---------------------------------------------------------------------------
# phases 4 and 5: the blind program
# ---------------------------------------------------------------------------
def load_degraded(n_utt: int, length: int):
    import numpy as np
    from buddy_tpu_torch.data.audio_io import read_wav
    ys = []
    for i in range(n_utt):
        y, sr = read_wav(os.path.join(REPO, "quality_out_heldout", f"degraded_utt{i}.wav"))
        if sr != 16000 or len(y) < length:
            raise ValueError(f"degraded_utt{i}.wav: {len(y)} samples at {sr} Hz")
        ys.append(y[:length])
    return np.stack(ys)[:, None].astype(np.float32)


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
    return args, net, sampler, op


_PORT_KERNELS = ("gn_stats_kernel", "gn_apply_kernel", "gn_bwd_stats_kernel",
                 "gn_bwd_apply_kernel", "analysis_kernel", "synthesis_kernel", "fir_kernel",
                 "fir_dh_kernel")                 # the device functions of K1, K2, K3


def profile_main_path(run, n_steps: int) -> None:
    """One more main-path run under torch.profiler: device ms per step of
    each of the port's kernels (by exact function name) and of all other
    kernels together, and the device's busy share of the wall time.  The
    full per-kernel table goes to chiprun_out/profile_main_path.txt."""
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
    for name, ms, _ in rows:
        fn = name.removeprefix("(anonymous namespace)::").split("(")[0]
        if fn in ours:
            ours[fn] += ms
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_main_path.txt"), "w") as f:
        for name, ms, count in sorted(rows, key=lambda r: -r[1]):
            f.write(f"{ms:12.3f} ms {count:8d}x  {name}\n")
    per_step = {k: round(v / n_steps, 3) for k, v in ours.items()}
    per_step["other kernels"] = round((busy - sum(ours.values())) / n_steps, 3)
    log(f"profile (main path, {n_steps} steps, profiler on): wall {wall * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 * (1 - busy / (wall * 1e3)):.1f}%; device ms per step: " + json.dumps(per_step))


def main_path(dev, wrappers):
    import torch
    args, net, sampler, op = build_program([
        f"tester.sampling_params.T={N_STEPS}",
        "network.compute_dtype=bfloat16",
        "tester.posterior_sampling.guidance_jacobian=full",
        "tester.posterior_sampling.blind_hp.op_updates_per_step=10",
    ], dev)
    log(f"main path: NCSN++ nf={args['network']['nf']} ch_mult={list(args['network']['ch_mult'])} "
        f"({net.num_params / 1e6:.2f} M params, bf16 body), B=8 x 65536 samples, "
        f"T={sampler.T} steps, 10 operator updates/step, full guidance")
    ys = torch.from_numpy(load_degraded(8, 65536)).to(dev)
    params, H = op.reset_batched(8, generator=torch.Generator(device=dev).manual_seed(3))

    def run():
        out = sampler.predict_conditional_batched(ys, op, blind=True, noise=sampler.default_noise(0),
                                                  op_params_batch=params, H_batch=H)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()                                           # cold: Triton/cuDNN first launches
    cold = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if tuple(out.shape) != (8, 1, 65536) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"main path output {tuple(out.shape)} finite="
                             f"{bool(torch.isfinite(out).all())}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    log(f"main path: output {list(out.shape)} finite, std {float(out.std()):.4g}; wall "
        f"{wall:.3f} s for {sampler.T} steps incl. WPE warm init ({wall / sampler.T * 1e3:.1f} "
        f"ms/step), cold run {cold:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("main path launches: " + json.dumps(launches))
    profile_main_path(run, sampler.T)
    return launches, wall


def small_reference(dev):
    """The blind program at a small size, kernels on the card against plain
    versions on the CPU, same weights (same seed) and noise."""
    import torch
    from buddy_tpu_torch.sampling.euler_heun import NoiseSource
    overrides = ["network.nf=16", "network.ch_mult=[1,2,2,2]", "tester.sampling_params.T=2",
                 "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
                 "tester.posterior_sampling.warm_initialization.mode=reverb_scaled"]
    ys = torch.from_numpy(load_degraded(2, 16384))
    outs = []
    for d in (dev, torch.device("cpu")):
        _, _, sampler, op = build_program(overrides, d)
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
    from buddy_tpu_torch.ops import _build, groupnorm as K1, stft as K2, subband_conv as K3

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
    }
    meta = {
        "groupnorm_silu_fwd": ("triton", "buddy_tpu_torch/csrc/groupnorm.py",
                               "scripts/tpu_pallas_gn_probe.py:61"),
        "groupnorm_silu_bwd": ("triton", "buddy_tpu_torch/csrc/groupnorm.py",
                               "buddy_tpu/models/layers.py:62"),
        "stft_analysis": ("cuda", "buddy_tpu_torch/csrc/stft.cu", "buddy_tpu/ops/stft.py:154"),
        "stft_synthesis": ("cuda", "buddy_tpu_torch/csrc/stft.cu", "buddy_tpu/ops/stft.py:317"),
        "subband_conv": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                         "buddy_tpu/operators/subband.py:76"),
        "subband_conv_adjoint": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                                 "buddy_tpu/operators/subband.py:76"),
        "subband_conv_filter_grad": ("cuda", "buddy_tpu_torch/csrc/subband_conv.cu",
                                     "buddy_tpu/operators/subband.py:76"),
    }
    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

    launches, _ = main_path(dev, wrappers)
    small_reference(dev)

    kernels = []
    for name, (route, source, replaces) in meta.items():
        c = checks[name]
        ms, plain_ms, lib_ms = c["times"]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": c["err"], "tolerance": c["tol"],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": c["bound"][0],
                        "bound_by": c["bound"][1], "library_ms": lib_ms, "shape": c["shape"]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
