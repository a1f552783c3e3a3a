"""Guided sampling: batches of reverberant utterances through the port's
DPS sampler, blind or informed, as the tester runs a batch.

Set-up builds the network (seed-made weights), the sampler through the
port's ``instantiate`` from the tester config and the blind subband
operator (or the known-RIR operator), and runs one short batch (2 steps) at the cell's batch and
length. The window runs whole batches of ``steps`` diffusion steps: a fresh
``reset_batched`` operator from the batch's phase noise (blind), then
``EulerHeunSamplerDPS.predict_conditional_batched``. It ends at the end of the first batch that finishes
after the window's length.

The window's draws come from the port's own noise source over a host
generator (``program.noise_source``), one seeded stream a batch, as the
tester draws them: on the host, then moved to the device.

The check: every output row of the window is finite and has the standard
deviation the speech-magnitude constraint sets; the program drew the
draws the reference draws, in its order; and for a sample of rows drawn
from the seed, ``check_rows`` of the window's first batch and as many of
its last, the reference follows the program step by step. The blind
operator's inner Adam moves each filter phase by the learning rate
whatever the size of its gradient, so the phases of two implementations
part at the first rounding difference: no two programs follow one
trajectory, and the reference takes up each step from the program's own
state (x, operator parameters, Adam's moments), recorded at the step's
start for the sampled rows. Compared: ``den_gap``, the relative L2 gap of
the constrained denoised estimate (worst step and row: the denoiser's
forward); ``guide_gap``, that of the update direction d = (x_next -
x_hat) / (t_next - t_hat) when the reference guides through the program's
own filter (the median over steps, worst row: the denoiser's vjp, the
guidance, the constraint and the Euler update); exact checks of the start
(the operator's reset decays and weights, an empty Adam state, the warm
start's draw and scale) and of each step's operator updates (Adam's
count, finite parameters inside the projection's box); and the rows and
draws of the window. The direction the reference gets from its own fit of
the filter, and that fit's loss against the program's, are printed
beside: the phases' chaos keeps them from any limit (PERF.md). The
informed program is checked the same way with ``d_gap`` (the direction's
gap, the median over steps, worst row) and ``d_gap_low_sigma`` (the worst
step and row of the second half of the steps, where the U-Net's output
decides the utterance).
"""

from __future__ import annotations

import gc
import json
import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import strict_float32
from portbench.reference.dps import BlindDPS, InformedDPS
from portbench.reference.ncsnpp import EDM, TimeNet

WARM_STEPS = 2
# the gap a non-finite answer reads: above any limit, and a number JSON holds
NOT_FINITE = 1e30


def reference_net(config: dict, device):
    net = {k: v for k, v in config["network"].items()}
    return TimeNet(n_fft=int(config["stft"]["n_fft"]), hop_length=int(config["stft"]["hop_length"]),
                   device=device, **net)


def weight_shapes(config: dict) -> dict:
    with torch.device("meta"):
        net = reference_net(config, "meta")
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device, extra=()):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        self.extra = list(extra)
        self.outputs = []          # x_den of each batch of the window
        self.records = {}          # batch -> the sampled rows' state at each step
        self.logs = {}             # batch -> the draws the program asked for

    def rows(self, k: int) -> list:
        """The rows of batch ``k`` that the check follows, drawn from the seed."""
        rng = np.random.default_rng(inputs.stream_seed(self.seed, "check", k))
        B, n = int(self.traffic["batch"]), int(self.traffic["check_rows"])
        return sorted(int(r) for r in rng.choice(B, size=min(n, B), replace=False))

    def checked(self) -> list:
        """The batches the check follows: the window's first and its last."""
        return sorted(self.records)

    # --- set-up -----------------------------------------------------------------
    def setup(self):
        from buddy_tpu_torch.config import instantiate
        from buddy_tpu_torch.operators.reverb import RIROperator
        from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
        tr = self.traffic
        self.args = program.compose_args(self.config, self.cell, [
            f"tester.sampling_params.T={int(tr['steps'])}", f"exp.audio_len={int(tr['audio_len'])}",
            *self.extra])
        ps = self.args["tester"]["posterior_sampling"]
        self.blind = "blind_dereverberation" in self.args["tester"]["modes"]
        self.scaling = float(ps["warm_initialization"]["scaling_factor"])
        csm = ps.get("constraint_speech_magnitude", {}) or {}
        self.csm = float(csm["speech_scaling"]) if csm.get("use", False) else None
        weights = inputs.make_weights(weight_shapes(self.config), self.seed, self.device,
                                      float(self.config["network"]["fourier_scale"]))
        self.network = program.build_network(self.args, self.device, weights, inference=True)
        del weights
        diff = instantiate(self.args["diff_params"])
        self.sampler = instantiate(self.args["tester"]["sampler"], self.network, diff, self.args,
                                   device=self.device)
        op_hp, fs = self.args["tester"]["informed_dereverberation"]["op_hp"], \
            int(self.args["exp"]["sample_rate"])
        self.operator = BlindSubbandFiltering(op_hp, sample_rate=fs, device=self.device) \
            if self.blind else RIROperator(op_hp, time_kernel_size=int(tr["rir_s"] * fs),
                                           sample_rate=fs, device=self.device)
        T = self.sampler.T
        self.sampler.T = WARM_STEPS
        self._batch(-1, keep=False)
        self.sampler.T = T
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _recorder(self, steps: list, rows):
        """Wrap the sampler's step so that it keeps the sampled rows' state
        before and after each step in ``steps``."""
        inner = type(self.sampler)._scan_step
        sampler = self.sampler

        def step(operator, blind, carry, *a):
            x, params, state, H = carry
            if x.shape[0] != int(self.traffic["batch"]):
                return inner(sampler, operator, blind, carry, *a)
            pick = lambda d: {k: v[rows].clone() for k, v in d.items()}
            entry = {"x": x[rows].clone(), "params": pick(params), "count": state[0],
                     "mu": pick(state[1]), "nu": pick(state[2]), "H_in": H[rows].clone()}
            out = inner(sampler, operator, blind, carry, *a)
            entry.update(x_next=out[0][0][rows].clone(), x_den=out[1][rows].clone(),
                         H=out[0][3][rows].clone())
            steps.append(entry)
            return out
        return step

    def _batch(self, k: int, keep: bool = True):
        B = int(self.traffic["batch"])
        if keep:
            steps = []
            self.sampler._scan_step = self._recorder(
                steps, torch.as_tensor(self.rows(k), device=self.device))
        y, rir = inputs.observations(self.seed, k, self.traffic, self.scaling, self.device)
        noise = inputs.LoggedNoise(program.noise_source(inputs.stream_seed(self.seed, "batch", k)))
        if self.blind:
            rn = inputs.reset_noise(self.seed, k, B, self.operator.length_rir, self.device)
            params, H = self.operator.reset_batched(B, noise=rn)
            x_den = self.sampler.predict_conditional_batched(
                y[:, None], self.operator, blind=True, noise=noise, op_params_batch=params,
                H_batch=H)
        else:
            x_den = self.sampler.predict_conditional_batched(
                y[:, None], self.operator, blind=False, noise=noise, H_batch=rir)
        if keep:
            self.outputs.append(x_den[:, 0].detach())
            del self.sampler._scan_step
            self.records[k], self.logs[k] = steps, noise.log
            for j in [j for j in self.records if j not in (min(self.records), k)]:
                del self.records[j], self.logs[j]     # keep the first batch's and the latest

    # --- the window ---------------------------------------------------------------
    def run_window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        k = 0
        while True:
            self._batch(k)
            self._sync()
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "batches": k, "steps": k * int(self.traffic["steps"]),
                "items": k * int(self.traffic["batch"])}

    def end_to_end(self, w: dict) -> dict:
        tr = self.traffic
        audio = int(tr["batch"]) * int(tr["audio_len"]) / int(tr["sample_rate"])
        return {"audio_s_per_s": audio * w["steps"] / (int(tr["tester_T"]) * w["wall_s"])}

    def failed(self) -> int:
        """Rows of the window that are not finite or break the constraint's
        standard deviation (1e-3 relative; blind mode); each is named in
        ``bad``."""
        self.bad = []
        for k, x in enumerate(self.outputs):
            std = x.std(dim=-1)
            ok = torch.isfinite(x).all(dim=-1)
            if self.csm is not None:
                ok &= (std - self.csm).abs() <= 1e-3 * self.csm
            for r in torch.nonzero(~ok).flatten().tolist():
                self.bad.append({"batch": k, "row": r, "finite": bool(torch.isfinite(x[r]).all()),
                                 "std": float(std[r])})
        return len(self.bad)

    def trace_modules(self):
        return self.network.module

    def flops_mode(self) -> tuple:
        """The U-Net's work in a step: "forward" (identity guidance) or
        "input_vjp", and the evaluations a step (Heun's second one on every
        step but the last)."""
        ps = self.args["tester"]["posterior_sampling"]
        mode = "forward" if ps.get("guidance_jacobian", "full") == "identity" else "input_vjp"
        T = int(self.traffic["steps"])
        order2 = int(self.args["tester"]["sampling_params"]["order"]) == 2
        return mode, (2 * T - 1) / T if order2 else 1.0

    # --- the check ---------------------------------------------------------------
    def free_program(self):
        self.bad_rows = self.failed()
        self.answer_mismatch = 0
        for k, steps in self.records.items():
            rows = self.rows(k)
            last = steps[-1]["x_den"] if steps else None
            got = self.outputs[k][torch.as_tensor(rows, device=self.device)]
            self.answer_mismatch += len(rows) if last is None or last.shape != got.shape \
                else int((got != last).any(dim=-1).sum())
        del self.network, self.sampler, self.operator
        self.outputs = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def detail_lines(self) -> list:
        """What the check saw, for the reader of a run that is not correct:
        the rows outside the constraint and the gaps of each step."""
        lines = [f"bad row: {b}" for b in getattr(self, "bad", [])]
        d = getattr(self, "detail", None)
        if d is not None:
            lines.append(f"rows {json.dumps(d['rows'])}; start {json.dumps(d['start'])}")
            lines += [f"step {i}: {json.dumps(p)}" for i, p in enumerate(d["steps"])]
        return lines

    def expected_draws(self) -> list:
        """The draws of one batch, in order: the initial noise, then each
        step's churn noise and each operator update's RIR noise."""
        B, n = int(self.traffic["batch"]), int(self.traffic["audio_len"])
        step = [("eps", (B, n))]
        if self.blind:
            op_hp = self.args["tester"]["informed_dereverberation"]["op_hp"]
            rir = int(op_hp["hop"]) * int(op_hp["Nf"]) + 1024
            ps = self.args["tester"]["posterior_sampling"]
            step += [("reg", (B, rir))] * int(ps["blind_hp"]["op_updates_per_step"])
        step = [("normal", kind, shape) for kind, shape in step]
        return [("normal", "init", (B, n))] + step * int(self.traffic["steps"])

    def check(self) -> dict:
        """{number: value} of the numbers the check computes."""
        strict_float32()
        weights = inputs.make_weights(weight_shapes(self.config), self.seed, self.device,
                                      float(self.config["network"]["fourier_scale"]))
        net = reference_net(self.config, self.device).to(self.device)
        net.load_state_dict(weights, strict=True)
        net.requires_grad_(False)
        del weights
        edm = EDM(**self.args["diff_params"]["sde_hp"])
        B = int(self.traffic["batch"])
        # the sampled rows of the checked batches side by side: their inputs,
        # their draws made again, and the program's state at each step
        checked = self.checked()
        cat = lambda make: torch.cat([make(k)[torch.as_tensor(self.rows(k), device=self.device)]
                                      for k in checked])
        obs = {k: inputs.observations(self.seed, k, self.traffic, self.scaling, self.device)
               for k in checked}
        y, rir = cat(lambda k: obs[k][0]), cat(lambda k: obs[k][1])
        del obs
        tables = [inputs.replay(inputs.stream_seed(self.seed, "batch", k), self.expected_draws(),
                                self.device, rows=self.rows(k)) for k in checked]
        keyed = inputs.TableNoise({key: torch.cat([t[key] for t in tables])
                                   for key in tables[0]} if tables else {})
        del tables
        self.steps, self.merge_bad = self._merged([self.records[k] for k in checked])
        self.reset_rows = lambda L: cat(lambda k: inputs.reset_noise(self.seed, k, B, L,
                                                                     self.device))
        noise = lambda kind, shape: keyed.normal(kind, shape)
        if not self.blind:
            return self._check_informed(InformedDPS(self.args, net, edm, self.device), y, rir,
                                        keyed, noise)
        ref = BlindDPS(self.args, net, edm, self.device)
        ref.prepare(y)
        upd = int(self.args["tester"]["posterior_sampling"]["blind_hp"]["op_updates_per_step"])
        return self._check_blind(ref, y, keyed, noise, upd)

    @staticmethod
    def _merged(batches: list) -> tuple:
        """The records of the checked batches joined step by step along the
        rows (as many steps as every batch recorded), and how many steps'
        Adam counts disagree between the batches."""
        n = min((len(b) for b in batches), default=0)
        join = lambda vs: {k: torch.cat([v[k] for v in vs]) for k in vs[0]} \
            if isinstance(vs[0], dict) else torch.cat(vs)
        steps, bad = [], 0
        for i in range(n):
            entries = [b[i] for b in batches]
            step = {k: join([e[k] for e in entries]) for k in entries[0] if k != "count"}
            counts = [e["count"] for e in entries]
            bad += any(c != counts[0] for c in counts)
            step["count"] = counts[0]
            steps.append(step)
        return steps, bad

    def _draw_mismatch(self) -> int:
        """Draws of the checked batches that are not the ones the reference
        makes, in kind, shape or order (each missing or extra one counted)."""
        want = self.expected_draws()
        return sum(sum(a != b for a, b in zip(self.logs[k], want))
                   + abs(len(self.logs[k]) - len(want)) for k in self.checked())

    def _steps_missing(self) -> int:
        T = int(self.traffic["steps"])
        return sum(T - len(self.records[k]) for k in self.checked()) + T * (not self.records)

    def _check_blind(self, ref, y, keyed, noise, upd) -> dict:
        rows_rel = lambda a, b: (a - b).norm(dim=-1) / b.norm(dim=-1)
        rel = lambda a, b: rows_rel(a, b).max().item()
        flat = lambda h: torch.view_as_real(h).reshape(h.shape[0], -1)
        per_step, start, den, guide, op_bad = [], {}, [], [], 0
        for i, rec in enumerate(self.steps):
            if i == 0:
                start = self._start(ref, rec, y, noise, keyed)
            else:
                op_bad += self._operator_mismatch(ref, self.steps[i - 1], rec, upd)
            keyed.counts = {"eps": i, "reg": i * upd}
            out = ref.step(i, rec["x"], rec["params"], (rec["count"], rec["mu"], rec["nu"]),
                           noise, H_guide=rec["H"])
            dt = float(np.float32(ref.times()[0][i + 1]) - ref.t_hat(i))
            d_prog = (rec["x_next"] - out["x_hat"]) / dt
            den.append(rows_rel(rec["x_den"], out["x_den"]))
            guide.append(rows_rel(d_prog, out["d_guide"]))
            con = out["x_den"] / out["x_den"].std(dim=-1, keepdim=True) \
                * rec["x_den"].std(dim=-1, keepdim=True)
            fit = lambda H: ref.fit_loss(con, H)
            per_step.append({"den": den[-1].max().item(), "d_guide": guide[-1].max().item(),
                             "d": rel(d_prog, out["d"]),
                             "fit": ((fit(rec["H"]) - fit(out["H"])).abs()
                                     / fit(out["H"])).max().item(),
                             "H": rel(flat(rec["H"]), flat(out["H"]))})
        self.detail = {"rows": {k: self.rows(k) for k in self.checked()}, "start": start,
                       "steps": per_step}
        nan_max = lambda t: float(torch.nan_to_num(t, nan=NOT_FINITE, posinf=NOT_FINITE).max())
        return {"den_gap": nan_max(torch.stack(den)) if den else 0.0,
                "guide_gap": nan_max(torch.stack(guide).median(dim=0).values) if guide else 0.0,
                "start_mismatch": float(start.get("mismatch", 0)),
                "operator_mismatch": float(op_bad + self.merge_bad),
                "bad_rows": float(self.bad_rows),
                "answer_mismatch": float(self.answer_mismatch),
                "draw_mismatch": float(self._draw_mismatch()),
                "steps_missing": float(self._steps_missing())}

    def _check_informed(self, ref, y, rir, keyed, noise) -> dict:
        """The informed program step by step from its own x: ``den_gap``
        (worst step and row), ``d_gap``, the update direction's gap (the
        median over steps, worst row) and ``d_gap_low_sigma`` (the worst
        step and row of the steps' second half), with the warm start
        checked exactly (the scaled observation plus the initial draw, 1e-5
        of it)."""
        ref.prepare(y, rir)
        rows_rel = lambda a, b: (a - b).norm(dim=-1) / b.norm(dim=-1)
        den, dgap, per_step, start_bad = [], [], [], 0
        for i, rec in enumerate(self.steps):
            if i == 0:
                keyed.counts = {}
                x0 = ref.start(y, noise)
                start_bad = int((rows_rel(rec["x"], x0) > 1e-5).sum())
            keyed.counts = {"eps": i}
            out = ref.step(i, rec["x"], noise)
            dt = float(np.float32(ref.times()[0][i + 1]) - ref.t_hat(i))
            den.append(rows_rel(rec["x_den"], out["x_den"]))
            dgap.append(rows_rel((rec["x_next"] - out["x_hat"]) / dt, out["d"]))
            per_step.append({"den": den[-1].max().item(), "d": dgap[-1].max().item()})
        self.detail = {"rows": {k: self.rows(k) for k in self.checked()},
                       "start": {"mismatch": start_bad}, "steps": per_step}
        nan_max = lambda t: float(torch.nan_to_num(t, nan=NOT_FINITE, posinf=NOT_FINITE).max())
        low = dgap[int(self.traffic["steps"]) // 2:]
        return {"den_gap": nan_max(torch.stack(den)) if den else 0.0,
                "d_gap": nan_max(torch.stack(dgap).median(dim=0).values) if dgap else 0.0,
                "d_gap_low_sigma": nan_max(torch.stack(low)) if low else 0.0,
                "start_mismatch": float(start_bad), "bad_rows": float(self.bad_rows),
                "answer_mismatch": float(self.answer_mismatch),
                "draw_mismatch": float(self._draw_mismatch()),
                "steps_missing": float(self._steps_missing())}

    @staticmethod
    def _operator_mismatch(ref, before: dict, after: dict, upd: int) -> int:
        """Exact checks of one step's operator updates: Adam counted ``upd``
        updates, and the decays and weights it left are finite and inside
        the projection's box (the reference's projection leaves them as
        they are)."""
        p = after["params"]
        bad = [after["count"] - before["count"] != upd]
        bad += [not bool(torch.isfinite(v).all()) for v in p.values()]
        proj = ref.op.project(p)
        bad += [not torch.equal(proj[k], p[k]) for k in ("decay", "weights")]
        return sum(bad)

    def _start(self, ref, rec, y, noise, keyed) -> dict:
        """The program's state before the first step against the start the
        reference makes: the operator's decays and weights exactly as
        configured, Adam's state empty, and the warm start the initial draw
        plus ``scaling`` times a unit-variance estimate (1e-4 of the
        scaling). The warm start's WPE estimate itself and the reset's
        filter are reported beside, not compared (PERF.md)."""
        rn = self.reset_rows(ref.op.length_rir)
        keyed.counts = {}
        x0, params0, _, H0 = ref.start(y, noise, rn)
        keyed.counts = {}
        t0 = float(ref.times()[0][0])
        z = rec["x"] - t0 * noise("init", rec["x"].shape)
        scale_err = ((z.std(dim=-1) - self.scaling).abs() / self.scaling).max().item()
        bad = [not torch.equal(rec["params"][k], params0[k]) for k in ("decay", "weights")]
        bad += [rec["count"] != 0] + [bool(v.abs().max() > 0) for d in (rec["mu"], rec["nu"])
                                      for v in d.values()]
        bad += [scale_err > 1e-4]
        rel = lambda a, b: ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        flat = lambda h: torch.view_as_real(h).reshape(h.shape[0], -1)
        return {"mismatch": sum(bad), "scale_err": scale_err, "init_gap": rel(rec["x"], x0),
                "reset_gap": rel(flat(rec["H_in"]), flat(H0))}
