"""The EDM trainer (``buddy_tpu/training/trainer.py``) on one device.

An endless loop of {denoising loss -> gradients -> global-norm clip -> Adam
-> EMA with a linear rampup}, with checkpoints every ``save_interval``
iterations (the JAX package's ``.ckpt`` layout, ``training/checkpoint.py``),
resume from the latest of them, the loss and gradient norm per log interval
with the loss binned by sigma into ``num_sigma_bins`` log bins, unconditional
samples from the EMA weights per heavy-log interval, and a profiler on the
reference's wait/warmup/active/repeat schedule.

The arithmetic of one step follows the JAX package's optax chain exactly,
written out in PyTorch (``torch._foreach_*``; no library optimizer):

* clip (``optax.clip_by_global_norm``): with g_norm the global norm of the
  gradients, they are left as they are where g_norm < max_norm, else each
  becomes (g / g_norm) * max_norm;
* Adam (``optax.adam``): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
  an int32 count incremented first, the update
  -lr (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps);
* EMA, after the update: ema = ema s + p (1 - s), with
  s = clip(it * batch / rampup, 0, rate) while it * batch < rampup, else
  s = rate.

The frozen Fourier features (``GaussianFourierProjection.W``) take no
gradient: their moments stay zero and they stay bit for bit as initialised,
as the JAX package's stop_gradient leaves them; the EMA covers them too.
``exp.grad_accum`` splits each batch into microbatches after the noise
levels and the noise of the whole batch are drawn; their gradients are
averaged before the one clip, Adam and EMA.  The metrics (loss, pre-clip
gradient norm, sums by sigma bin) accumulate on the device and reach the host
at log time only.

The randomness comes from a noise source (``sampling/euler_heun.py::
NoiseSource``) over a CPU ``torch.Generator`` seeded with ``exp.seed``, so a
run on the card and one on the CPU draw the same numbers; its state is saved
with each checkpoint.  ``exp.lr_rampup_it``, ``exp.scheduler_*`` and
``exp.precision`` are read by neither package's trainer: the learning rate is
constant.  The JAX package's device mesh (``exp.mesh``) is not ported: the
trainer runs on one device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.models.convert import from_jax_params, to_jax_params
from buddy_tpu_torch.sampling.euler_heun import NoiseSource
from buddy_tpu_torch.training import checkpoint as ckpt
from buddy_tpu_torch.training import stats
from buddy_tpu_torch.utils import log as utils_logging


class Trainer:
    def __init__(self, args=None, dset=None, network=None, diff_params=None,
                 tester=None, device=None, noise=None):
        assert args is not None and dset is not None
        assert network is not None and diff_params is not None
        self.args = args
        self.dset = dset              # batch iterator (yields (B, T) float32)
        self.network = network        # NetworkBundle
        self.module = network.module
        self.diff_params = diff_params
        self.tester = tester
        self.device = resolve_device(device)

        exp = args["exp"]
        self.batch_size = int(exp["batch_size"])
        self.ema_rate = float(exp["ema_rate"])
        self.ema_rampup = float(exp["ema_rampup"])
        self.use_grad_clip = bool(exp["use_grad_clip"])
        self.max_grad_norm = float(exp["max_grad_norm"])
        self.seed = int(exp["seed"])
        self.grad_accum = int(exp.get("grad_accum", 1) or 1)
        assert self.batch_size % self.grad_accum == 0, \
            f"batch_size {self.batch_size} % grad_accum {self.grad_accum}"
        mesh = exp.get("mesh", {})
        if any(int(mesh.get(k, 1) or 1) > 1 for k in ("dp", "tp", "sp")):
            raise NotImplementedError(
                f"exp.mesh {dict(mesh)}: the device mesh is not ported (ROADMAP.md, parallel); "
                "the trainer runs on one device")
        opt_cfg = exp["optimizer"]
        self.lr = float(opt_cfg["lr"])
        self.b1, self.b2 = float(opt_cfg["betas"][0]), float(opt_cfg["betas"][1])
        self.eps = float(opt_cfg["eps"])
        self.noise = noise if noise is not None else \
            NoiseSource(torch.Generator().manual_seed(self.seed))

        # the module holds the trained weights; the EMA and Adam's moments
        # cover every parameter, the frozen ones too (their moments stay 0),
        # and a static int8 network's calibrated scales, as the JAX
        # package's optimizer and EMA cover its "quant" collection
        self.params = dict(self.module.named_parameters())
        self.params.update((n, b) for n, b in self.module.named_buffers()
                           if n.endswith("a_scale"))
        wrong = [n for n, p in self.params.items() if p.device.type != self.device.type]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]}... are not on {self.device}")
        self.trainable = [n for n, p in self.params.items() if p.requires_grad]
        with torch.no_grad():
            self.ema = {n: p.detach().clone() for n, p in self.params.items()}
            self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0                # Adam's step count (int32 in the checkpoint)
        self.it = 0

        self.total_params = self.network.num_params
        print("total_params: ", self.total_params / 1e6, "M")
        log_cfg = args["logging"]
        if log_cfg.get("print_model_summary", False):
            raise NotImplementedError("logging.print_model_summary: utils/summary.py is not "
                                      "ported (ROADMAP.md, utilities)")

        # sigma bins for the loss-by-sigma statistics
        dp_hp = args["diff_params"]["sde_hp"]
        self.num_sigma_bins = int(log_cfg["num_sigma_bins"])
        self.sigma_bins = np.logspace(np.log10(float(dp_hp["sigma_min"])),
                                      np.log10(float(dp_hp["sigma_max"])),
                                      num=self.num_sigma_bins, base=10)
        self._bins = torch.as_tensor(self.sigma_bins, dtype=torch.float32, device=self.device)

        self.latest_checkpoint: Optional[str] = None
        if exp.get("resume", False):
            rc = exp.get("resume_checkpoint", "None")
            if self.resume_from_checkpoint(None if rc in (None, "None") else rc):
                print(f"Resuming from iteration {self.it}")
            else:
                print("Could not resume from checkpoint\ntraining from scratch")

        self._metrics_acc = None
        self._log_rows = []
        self.stats_collector = stats.Collector(keep_previous=True)

        self.wandb_run = None
        self._wandb = None
        if log_cfg.get("log", False) and log_cfg.get("wandb", {}).get("entity"):
            try:        # optional, as in the JAX package
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                self.wandb_run = wandb.init(
                    project=log_cfg["wandb"]["project"],
                    config=args.to_dict() if hasattr(args, "to_dict") else dict(args))

        prof = log_cfg.get("profiling", {})
        self.profile = bool(prof.get("enabled", False))
        self.profile_wait = int(prof.get("wait", 5))
        self.profile_warmup = int(prof.get("warmup", 10))
        self.profile_active = int(prof.get("active", 2))
        self.profile_repeat = int(prof.get("repeat", 1))
        self._profiler = None
        self._profile_cycle = 0

    # ------------------------------------------------------------------
    def _net(self, x, cnoise):
        return self.module(x[:, None, :], cnoise)[:, 0, :]

    def _bin_stats(self, error, sigma):
        """Sums of the per-item mean error (and its square) and counts by
        sigma bin (left searchsorted, clipped to the last bin), over every
        item of the batch."""
        nb = self._bins.shape[0]
        per = error.mean(dim=tuple(range(1, error.dim())))
        idx = torch.searchsorted(self._bins, sigma.contiguous()).clamp_(0, nb - 1)
        one_hot = F.one_hot(idx, nb).to(per.dtype)
        return one_hot.T @ per, one_hot.T @ (per * per), one_hot.sum(0)

    def get_batch(self) -> torch.Tensor:
        batch = self.dset.next_batch() if hasattr(self.dset, "next_batch") \
            else next(self.dset)
        return torch.from_numpy(np.asarray(batch, np.float32)).to(self.device)

    def _gradients(self, batch):
        """Loss, (bin sums, bin sums of squares, bin counts) and the
        gradients (averaged over the microbatches) in the parameters' .grad."""
        diff, accum = self.diff_params, self.grad_accum
        t = diff.sample_time_training(self.noise, batch.shape[0], self.device)
        n = diff.sample_prior(self.noise, batch.shape, self.device)
        for name in self.trainable:
            self.params[name].grad = None
        loss, bins = 0.0, None
        for x_mb, t_mb, n_mb in zip(batch.chunk(accum), t.chunk(accum), n.chunk(accum)):
            inp, target, cnoise = diff.prepare_train_preconditioning(x_mb, t_mb, n_mb)
            error = (self._net(inp, cnoise) - target) ** 2
            loss_mb = error.mean()
            loss_mb.backward()
            with torch.no_grad():
                b = self._bin_stats(error.detach(), diff._std(t_mb))
                bins = b if bins is None else tuple(u + v for u, v in zip(bins, b))
                loss = loss + loss_mb.detach()
        if accum > 1:
            inv = float(np.float32(1.0 / accum))
            loss = loss * inv
            torch._foreach_mul_([self.params[n].grad for n in self.trainable], inv)
        return loss, bins

    @torch.no_grad()
    def _update(self, it: int):
        """Clip, Adam and the EMA; returns the pre-clip global norm."""
        params = [self.params[n] for n in self.trainable]
        grads = [p.grad for p in params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.use_grad_clip:
            # optax.clip_by_global_norm: g if g_norm < max_norm else (g / g_norm) * max_norm
            keep = g_norm < self.max_grad_norm
            one = torch.ones_like(g_norm)
            torch._foreach_div_(grads, torch.where(keep, one, g_norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_grad_norm))
        # optax.adam, its bias corrections in float32 as optax forms them
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        mu = [self.mu[n] for n in self.trainable]
        nu = [self.nu[n] for n in self.trainable]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -self.lr)
        torch._foreach_add_(params, step)
        # EMA with a linear rampup, in float32 as the JAX package forms s
        t = np.float32(it) * np.float32(self.batch_size)
        s = np.clip(t / np.float32(self.ema_rampup), np.float32(0.0), np.float32(self.ema_rate)) \
            if t < self.ema_rampup else np.float32(self.ema_rate)
        names = list(self.params)
        ema = [self.ema[n] for n in names]
        torch._foreach_mul_(ema, float(s))
        torch._foreach_add_(ema, torch._foreach_mul([self.params[n] for n in names],
                                                    float(np.float32(1.0) - s)))
        return g_norm

    def train_step(self):
        batch = self.get_batch()
        loss, bins = self._gradients(batch)
        g_norm = self._update(self.it)
        metrics = {"loss": loss, "loss_sq": loss * loss,
                   "bin_sum": bins[0], "bin_sumsq": bins[1], "bin_count": bins[2],
                   "count": torch.ones((), device=self.device),
                   "grad_norm": g_norm, "grad_norm_sq": g_norm * g_norm}
        if self._metrics_acc is None:
            self._metrics_acc = metrics
        else:           # on the device; no host sync until log time
            self._metrics_acc = {k: self._metrics_acc[k] + v for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def opt_leaves(self) -> list:
        """The optimizer state as the JAX package's leaves: the int32 count,
        then the first and the second moments in the JAX tree's order."""
        return ([np.asarray(self.count, np.int32)]
                + ckpt.tree_leaves(to_jax_params(self.mu))
                + ckpt.tree_leaves(to_jax_params(self.nu)))

    def _check_layout(self, state: dict) -> None:
        """ValueError unless ``state`` holds every parameter in its shape."""
        if set(state) != set(self.params) or any(
                tuple(v.shape) != tuple(self.params[k].shape) for k, v in state.items()):
            raise ValueError("the checkpoint's parameters do not match the network's")

    @staticmethod
    def _load_state(state: dict, into: dict) -> None:
        with torch.no_grad():
            for name, value in state.items():
                into[name].copy_(value)

    def save_checkpoint(self):
        exp_name = self.args["exp"]["exp_name"]
        base = os.path.join(self.args["model_dir"], f"{exp_name}-{self.it}")
        gen = getattr(self.noise, "generator", None)
        path = ckpt.save_checkpoint(
            base, params=to_jax_params(self.params), ema_params=to_jax_params(self.ema),
            opt_leaves=self.opt_leaves(), it=self.it,
            generator_state=None if gen is None else gen.get_state().numpy(), args=self.args)
        print("saving", path)
        if self.args["logging"].get("remove_old_checkpoints", False):
            ckpt.remove_checkpoint(self.latest_checkpoint)
        self.latest_checkpoint = path

    def resume_from_checkpoint(self, checkpoint_path=None) -> bool:
        """Parameters, EMA, Adam's state, the iteration and the generator's
        state from a checkpoint of either package (the latest of model_dir
        when no path is given).  False where there is none, or where it does
        not load (the JAX package's fallback: training starts afresh)."""
        if checkpoint_path is None:
            checkpoint_path = ckpt.find_latest_checkpoint(
                self.args["model_dir"], self.args["exp"]["exp_name"])
            if checkpoint_path is None:
                return False
        try:
            params, it = ckpt.load_any_checkpoint(checkpoint_path, prefer_ema=False)
            ema, _ = ckpt.load_any_checkpoint(checkpoint_path, prefer_ema=True)
            params, ema = from_jax_params(params), from_jax_params(ema)
            self._check_layout(params)
            self._check_layout(ema)
            template = self.opt_leaves()
            restored = ckpt.load_opt_state(checkpoint_path, template)
        except (OSError, ValueError, KeyError) as e:
            print("Could not resume from checkpoint")
            print(e)
            return False
        self._load_state(params, self.params)
        self._load_state(ema, self.ema)
        if restored is not None:
            n = (len(template) - 1) // 2
            layout = to_jax_params(self.mu)
            self.count = int(restored[0])
            self._load_state(from_jax_params(ckpt.tree_like(layout, restored[1:1 + n])), self.mu)
            self._load_state(from_jax_params(ckpt.tree_like(layout, restored[1 + n:])), self.nu)
        else:
            self.count = 0
            for t in list(self.mu.values()) + list(self.nu.values()):
                t.zero_()
        extras = ckpt.load_extras(checkpoint_path)
        gen = getattr(self.noise, "generator", None)
        if gen is not None and "generator_state" in extras:
            gen.set_state(torch.from_numpy(extras["generator_state"]))
        self.it = it
        self.latest_checkpoint = checkpoint_path
        return True

    # ------------------------------------------------------------------
    def easy_logging(self):
        """Fetch the metric accumulator: the mean loss and gradient norm,
        the loss by sigma bin, through ``training.stats``, to
        ``<model_dir>/train_log.jsonl`` and the loss-by-sigma plot."""
        if self._metrics_acc is None:
            return
        acc = {k: v.detach().cpu().numpy() for k, v in self._metrics_acc.items()}
        n = max(float(acc["count"]), 1.0)
        loss_mean = float(acc["loss"] / n)
        count = np.maximum(acc["bin_count"], 1.0)
        means = acc["bin_sum"] / count
        stds = np.sqrt(np.maximum(acc["bin_sumsq"] / count - means ** 2, 0.0))
        means = np.where(acc["bin_count"] > 0, means, np.nan)

        grad_norm_mean = float(acc["grad_norm"] / n)
        stats.report_moments("loss", n=n, total=float(acc["loss"]),
                             total_sq=float(acc["loss_sq"]))
        stats.report_moments("grad_norm", n=n, total=float(acc["grad_norm"]),
                             total_sq=float(acc["grad_norm_sq"]))
        for i, s in enumerate(self.sigma_bins):
            if acc["bin_count"][i] > 0:
                stats.report_moments(f"error_sigma_{s}", n=float(acc["bin_count"][i]),
                                     total=float(acc["bin_sum"][i]),
                                     total_sq=float(acc["bin_sumsq"][i]))
        self.stats_collector.update()

        row = {"it": self.it, "loss": loss_mean, "grad_norm": grad_norm_mean}
        self._log_rows.append(row)
        print(f"it={self.it} loss={loss_mean:.6f} grad_norm={grad_norm_mean:.4f}")

        model_dir = self.args["model_dir"]
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "train_log.jsonl"), "a") as f:
            f.write(json.dumps({**row, "sigma_bins": self.sigma_bins.tolist(),
                                "bin_means": means.tolist()}) + "\n")
        plot_path = os.path.join(model_dir, "loss_by_sigma.png")
        try:
            utils_logging.plot_loss_by_sigma(means, stds, self.sigma_bins, out_path=plot_path)
        except ImportError:     # no matplotlib: no plot
            plot_path = None
        if self.wandb_run is not None:
            payload: dict[str, Any] = {"loss": loss_mean, "grad_norm": grad_norm_mean}
            for i, s in enumerate(self.sigma_bins):
                if acc["bin_count"][i] > 0:
                    payload[f"error_sigma_{s}"] = float(means[i])
            if plot_path is not None:
                payload["loss_by_sigma"] = self._wandb.Image(plot_path)
            self.wandb_run.log(payload, step=self.it)
        self._metrics_acc = None

    def heavy_logging(self):
        """Unconditional samples from the EMA weights of the latest
        checkpoint (the current EMA before the first), written to model_dir.

        The tester's network is called with those weights in place of its
        module's (``NetworkBundle.weights``): the trainer's module, which the
        tester may share, keeps the weights it trains, and the EMA tensors
        take no gradient."""
        if self.tester is None:
            return
        if self.latest_checkpoint is not None:
            tree, _ = ckpt.load_any_checkpoint(self.latest_checkpoint, prefer_ema=True)
            weights = {k: v.to(self.device) for k, v in from_jax_params(tree).items()}
        else:
            weights = {k: v.detach() for k, v in self.ema.items()}
        with self.tester.network.weights(weights):
            audio = self.tester.do_test(it=self.it)
        if audio is None:
            return
        fs = self.args["exp"]["sample_rate"]
        wandb_audio = {}
        for i, x in enumerate(np.asarray(audio)):
            utils_logging.write_audio_file(x, fs, f"sample_{i}_it{self.it}",
                                           path=self.args["model_dir"], normalize=True)
            if self.wandb_run is not None:
                m = np.abs(x).max() or 1.0
                wandb_audio[f"unconditional_{i}"] = self._wandb.Audio(
                    np.asarray(x / m, np.float32), sample_rate=fs)
        if self.wandb_run is not None and wandb_audio:
            self.wandb_run.log(wandb_audio, step=self.it)

    # ------------------------------------------------------------------
    def _profiler_hook(self):
        """torch.profiler over ``active`` iterations after ``wait`` +
        ``warmup``, ``repeat`` times; each trace goes to
        <model_dir>/tbprofile as a Chrome trace."""
        if not self.profile:
            return
        period = self.profile_wait + self.profile_warmup + self.profile_active
        start = self._profile_cycle * period + self.profile_wait + self.profile_warmup
        stop = start + self.profile_active
        trace_dir = os.path.join(self.args["model_dir"], "tbprofile")
        if self.it == start and self._profiler is None:
            os.makedirs(trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self.it == stop and self._profiler is not None:
            self._profiler.stop()
            self._profiler.export_chrome_trace(
                os.path.join(trace_dir, f"trace_it{start}-{stop}.json"))
            self._profiler = None
            self._profile_cycle += 1
            print(f"profiling cycle {self._profile_cycle}/{self.profile_repeat} done")
            if self._profile_cycle >= self.profile_repeat:
                self.profile = False
                if self.wandb_run is not None:
                    art = self._wandb.Artifact("trace", type="profile")
                    art.add_dir(trace_dir)
                    self.wandb_run.log_artifact(art)

    def training_loop(self):
        log_cfg = self.args["logging"]
        save_interval = int(log_cfg["save_interval"])
        heavy_interval = int(log_cfg["heavy_log_interval"])
        log_interval = int(log_cfg["log_interval"])
        max_iters = self.args["exp"].get("max_iters", None)

        while True:
            self.train_step()
            self._profiler_hook()

            if self.it > 0 and self.it % save_interval == 0 and \
                    log_cfg.get("save_model", False):
                self.save_checkpoint()
            if self.it > 0 and self.it % heavy_interval == 0 and \
                    log_cfg.get("log", False):
                self.heavy_logging()
            if self.it > 0 and self.it % log_interval == 0 and \
                    log_cfg.get("log", False):
                self.easy_logging()

            self.it += 1
            if max_iters is not None and self.it > int(max_iters):
                break
