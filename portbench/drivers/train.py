"""The train step: the port's ``Trainer.train_step`` at the shipped exp,
fed by its native loader from speech-like WAV files the benchmark writes
under ``TMPDIR``.

Set-up writes the files, builds the network (seed-made weights), the
loader (``make_train_loader`` over the port's ``VCTKTrain``) and the
``Trainer`` through ``instantiate``, with the port's own noise source over
a host generator seeded from the seed (as the trainer builds it, logged),
and drives three steps through ``train_step``: they build and warm
every kernel, and they are the steps the check compares. The same trainer
then trains on through the window, one ``train_step`` after another with
no synchronise between them, as its loop runs; the window closes with a
synchronise after the first step queued past its length.

The check, after the window: every row of the three batches is a window
of one of the files (the loader's crop or wrap, read back bit for bit),
and the rows differ; the three steps drew what the reference draws, in its
order; the window's steps each counted one Adam update and moved every
parameter and EMA leaf that the reference moves (``window_mismatch``,
exact: the window's steps are not followed by the reference); the
reference then runs the same three steps from the same weights, rows and
draws, made again on the host from the same seed. Each leaf's gap is the gap of the two norms
over the reference's, or the median leaf's where that is larger. The
numbers: each step's loss (relative gap, worst step); the norm of the
first clipped gradient as Adam holds it after one step (worst leaf); the
norms of the parameters' and the EMA's change after three steps, worst
leaf and median leaf. The cell's limits say which are compared: the
worst leaf's change is set by elements whose gradient is round-off, which
Adam moves by its step whatever their size, and it swings between two
runs of one seed (cuDNN's backward is not deterministic), so the median
leaf's is compared (PERF.md). Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the changes.
"""

from __future__ import annotations

import gc
import json
import tempfile
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.drivers.dps import reference_net, weight_shapes
from portbench.reference import strict_float32
from portbench.reference.ncsnpp import EDM
from portbench.reference.train import TrainReference

CHECKED_STEPS = 3


class RecordingLoader:
    """The port's loader, with a copy of the first batches it hands out."""

    def __init__(self, inner, keep: int):
        self.inner, self.keep, self.batches = inner, keep, []

    def next_batch(self):
        b = self.inner.next_batch()
        if len(self.batches) < self.keep:
            self.batches.append(np.array(b, copy=True))
        return b

    def close(self):
        self.inner.close()


def not_windows(rows, files) -> int:
    """How many of ``rows`` are not a cyclic window of one of ``files``
    (float32 arrays of 16-bit samples): every offset of every file is keyed
    by the three samples from it, each row is looked up by the three at its
    largest sample (silence would match everywhere), and each candidate is
    compared sample for sample."""
    code = lambda a: np.round(np.asarray(a, np.float64) * 32768.0).astype(np.int64) + 32768
    keys, where = [], []
    for f, x in enumerate(files):
        q = code(x)
        ext = np.concatenate([q, q[:2]])
        keys.append((ext[:-2] * 65536 + ext[1:-1]) * 65536 + ext[2:])
        where.append(np.stack([np.full(len(x), f), np.arange(len(x))], 1))
    keys, where = np.concatenate(keys), np.concatenate(where)
    order = np.argsort(keys, kind="stable")
    keys, where = keys[order], where[order]
    bad = 0
    for row in rows:
        j = int(np.argmax(np.abs(row[:-2])))
        r = code(row[j:j + 3])
        k = (r[0] * 65536 + r[1]) * 65536 + r[2]
        lo, hi = np.searchsorted(keys, k), np.searchsorted(keys, k, side="right")
        found = False
        for f, s in where[lo:hi]:
            x = files[f]
            s = (s - j) % len(x)
            if np.array_equal(x[(s + np.arange(len(row))) % len(x)], row):
                found = True
                break
        bad += not found
    return bad


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, extra=()):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        self.extra = list(extra)

    def setup(self):
        from buddy_tpu_torch.config import instantiate
        from buddy_tpu_torch.data.loader import make_train_loader
        tr = self.traffic
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        self.files = inputs.write_training_set(self._tmp.name, self.seed, tr, self.device)
        self.args = program.compose_args(self.config, self.cell, [
            f"dset.train.path={self._tmp.name}", "dset.train.speakers_test=[]",
            "dset.train.speakers_discard=[]", f"exp.batch_size={int(tr['batch'])}",
            f"exp.audio_len={int(tr['audio_len'])}",
            f"dset.train.segment_length={int(tr['audio_len'])}",
            f"exp.seed={inputs.stream_seed(self.seed, 'loader') % 2 ** 31}",
            "exp.resume=false", *self.extra])
        exp = self.args["exp"]
        weights = inputs.make_weights(weight_shapes(self.config), self.seed, self.device,
                                      float(self.config["network"]["fourier_scale"]))
        self.p0 = {k: v.to('cpu', copy=True) for k, v in weights.items()}
        self.network = program.build_network(self.args, self.device, weights, inference=False)
        del weights
        self.loader = RecordingLoader(make_train_loader(
            instantiate(self.args["dset"]["train"]), batch_size=int(exp["batch_size"]),
            num_workers=int(exp["num_workers"]), seed=int(exp["seed"])), CHECKED_STEPS)
        diff = instantiate(self.args["diff_params"])
        self.noise = inputs.LoggedNoise(program.noise_source(
            inputs.stream_seed(self.seed, "train")))
        self.trainer = instantiate(exp["trainer"], self.args, self.loader, self.network, diff,
                                   None, device=self.device, noise=self.noise)
        self.losses = []
        for i in range(CHECKED_STEPS):
            self.trainer._metrics_acc = None
            self._step()
            self.losses.append(self.trainer._metrics_acc["loss"].detach().clone())
            if i == 0:
                b1 = self.trainer.b1
                self.g1 = {k: (v / (1.0 - b1)).cpu() for k, v in self.trainer.mu.items()}
        # the snapshots wait on the host, so that the device's peak is the program's
        with torch.no_grad():
            self.p3 = {k: v.detach().to('cpu', copy=True) for k, v in self.trainer.params.items()}
            self.ema3 = {k: v.detach().to('cpu', copy=True) for k, v in self.trainer.ema.items()}
        self.trainer._metrics_acc = None
        self.setup_draws = list(self.noise.log)
        self.count3 = self.trainer.count
        self._sync()

    def expected_draws(self) -> list:
        """The draws of the three checked steps, in order: each step's noise
        levels, then its prior noise."""
        B, n = int(self.traffic["batch"]), int(self.traffic["audio_len"])
        return [("uniform", "sigma", (B,)), ("normal", "prior", (B, n))] * CHECKED_STEPS

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self):
        self.trainer.train_step()
        self.trainer.it += 1

    def run_window(self, seconds: float) -> dict:
        """Steps as the trainer's loop runs them, with no synchronise between
        them (the loader's upload paces the host); the window closes with
        one once a step has been queued past ``seconds``."""
        self._sync()
        t0 = time.perf_counter()
        k = 0
        while True:
            self._step()
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        self.window_steps = k
        return {"wall_s": wall, "steps": k, "items": k}

    def end_to_end(self, w: dict) -> dict:
        return {"train_step_ms": 1e3 * w["wall_s"] / w["steps"]}

    def failed(self) -> int:
        """Steps of the window whose loss was not finite (all of them where
        the window's summed loss is not)."""
        acc = self.trainer._metrics_acc
        return 0 if acc is not None and bool(torch.isfinite(acc["loss"])) else self.window_steps

    def trace_modules(self):
        return self.network.module

    def flops_mode(self) -> tuple:
        return "train", 1.0

    def free_program(self):
        with torch.no_grad():       # the state the window left, on the host
            self.pw = {k: v.detach().to('cpu', copy=True) for k, v in self.trainer.params.items()}
            self.emaw = {k: v.detach().to('cpu', copy=True) for k, v in self.trainer.ema.items()}
        self.counted = self.trainer.count - self.count3 - self.window_steps
        self.loader.close()
        del self.trainer, self.network
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        strict_float32()
        files = list(self.files.values())
        batches = self.loader.batches
        rows = [r for b in batches for r in b]
        bad = not_windows(rows, files)
        bad += len(rows) - len({r.tobytes() for r in rows})
        if len(batches) < CHECKED_STEPS:
            bad += 1
        self._tmp.cleanup()
        net = reference_net(self.config, self.device).to(self.device)
        net.load_state_dict(self.p0, strict=True)
        dev = lambda d: {k: v.to(self.device) for k, v in d.items()}
        self.p0, self.g1, self.p3, self.ema3 = dev(self.p0), dev(self.g1), dev(self.p3), \
            dev(self.ema3)
        hp = self.args["diff_params"]["sde_hp"]
        ref = TrainReference(self.args, net, EDM(**hp), int(self.traffic["check_block_rows"]))
        want = self.expected_draws()
        draw_bad = sum(a != b for a, b in zip(self.setup_draws, want)) \
            + abs(len(self.setup_draws) - len(want))
        replay = inputs.TableNoise(inputs.replay(inputs.stream_seed(self.seed, "train"), want,
                                                 self.device))
        ref_losses, g1 = [], None
        for i in range(CHECKED_STEPS):
            x = torch.as_tensor(batches[i], device=self.device)
            a = replay.uniform("sigma", (x.shape[0],))
            n = replay.normal("prior", tuple(x.shape))
            loss, grads = ref.step(x, a, n, i)
            ref_losses.append(float(loss))
            if i == 0:
                g1 = {k: v.clone() for k, v in grads.items()}
        loss_gap = max(abs(float(p) - r) / abs(r) for p, r in zip(self.losses, ref_losses))
        norms = {k: float(v.norm()) for k, v in g1.items()}
        med = float(np.median(list(norms.values())))
        moving = [k for k in g1 if norms[k] >= 1e-3 * med]

        self.detail = {}

        def worst(name: str, prog: dict, refd: dict, keys) -> float:
            pn = {k: float(prog[k].norm()) for k in keys}
            rn = {k: float(refd[k].norm()) for k in keys}
            m = float(np.median(list(rn.values())))
            gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], m) for k in keys}
            k = max(gaps, key=gaps.get)
            self.detail[name] = {"leaf": k, "program": pn[k], "reference": rn[k], "median": m}
            return gaps[k], float(np.median(list(gaps.values())))

        d_prog = {k: self.p3[k] - self.p0[k] for k in moving}
        d_ref = {k: ref.params[k].detach() - self.p0[k] for k in moving}
        e_prog = {k: self.ema3[k] - self.p0[k] for k in moving}
        e_ref = {k: ref.ema[k] - self.p0[k] for k in moving}
        self.detail["losses"] = {"program": [float(v) for v in self.losses],
                                 "reference": ref_losses, "left_out": sorted(set(g1) - set(moving))}
        grad, grad_med = worst("grad", self.g1, g1, list(g1))
        change, change_med = worst("change", d_prog, d_ref, moving)
        ema, ema_med = worst("ema", e_prog, e_ref, moving)
        unmoved = sum(torch.equal(self.pw[k], self.p3[k].cpu())
                      + torch.equal(self.emaw[k], self.ema3[k].cpu()) for k in moving)
        self.detail["window"] = {"steps": self.window_steps, "adam_count_off": self.counted,
                                 "leaves_unmoved": unmoved}
        return {"loss_gap": loss_gap, "grad_gap": grad, "change_gap": change, "ema_gap": ema,
                "grad_median_gap": grad_med, "change_median_gap": change_med,
                "ema_median_gap": ema_med, "bad_rows": float(bad),
                "draw_mismatch": float(draw_bad),
                "window_mismatch": float(abs(self.counted) + unmoved)}

    def detail_lines(self) -> list:
        """The worst leaf of each norm compared, and each step's losses."""
        return [f"{k}: {json.dumps(v)}" for k, v in getattr(self, "detail", {}).items()]
