"""The tester: unconditional sampling and informed / blind
dereverberation (``buddy_tpu/testing/tester.py``).

Mode dispatch over ``args.tester.modes``; per test item the clean input is
normalised to the sigma_data scale, the observation is synthesised with the
*true* RIR, (blind) a noise-initialised subband operator is built, guided
sampling runs, and the original / degraded / reconstructed / true-RIR /
estimated-RIR WAV sets go into a dated directory layout, with objective
metrics per utterance when ``tester.evaluate.use``.

Utterances are bucket-padded to a multiple of ``tester.bucket_pad`` samples;
``tester.batched.use`` groups them by (padded length, RIR bucket) and runs
each group through the batched sampler; utterances beyond
``tester.chunked.threshold`` samples take the chunked overlap-add path.

Randomness: the tester owns two noise sources, ``noise`` for the sampler's
draws and ``reset_noise`` for the phase noise of the operator resets, each a
``NoiseSource`` over a CPU generator made from ``seed`` (42 by default), so
a run on the card and a run on the CPU see the same draws.

Ranks (``parallel/mesh.py``): with more than one rank the tester holds a dp
mesh over the world (inside the trainer, the trainer's mesh, whose dp axis
it uses).  Where ``tester.batched.shard`` (the default) and the batch size
divides over dp, each rank runs its B/dp utterances of every batch that
divides, drawing the global batch's noise and phase noise and keeping its
rows (``ShardedNoise``), so that each utterance's result does not depend on
dp; the first rank of each dp line gathers the predictions and the
estimated RIRs (as CPU tensors).  A tail batch that does not divide, the
serial and the chunked paths run whole on every rank from the same draws,
as they run unsharded in the JAX package.  Unconditional sampling shards
when ``num_samples`` divides over dp, else every rank samples the whole
batch.  The first rank alone makes the directories and writes the WAV sets,
the metrics and the ``.argv``.
"""

from __future__ import annotations

import json
import os
from datetime import date

import numpy as np
import torch

from buddy_tpu_torch import evaluation
from buddy_tpu_torch.config import instantiate, save_config
from buddy_tpu_torch.device import resolve_device
from buddy_tpu_torch.operators.reverb import RIROperator
from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
from buddy_tpu_torch.parallel import mesh as pmesh
from buddy_tpu_torch.sampling.euler_heun import NoiseSource, ShardedNoise
from buddy_tpu_torch.utils.log import write_audio_file

_RIR_BUCKET = 4096      # true RIRs are zero-padded to a multiple of this many samples


def _std(x) -> float:
    return float(np.std(np.asarray(x), ddof=1))


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Tester:
    def __init__(self, args, network, diff_params, test_set=None, device=None,
                 seed: int = 42, in_training: bool = False):
        self.args = args
        self.network = network                      # NetworkBundle
        self.diff_params = diff_params
        self.device = resolve_device(device)
        self.test_set = test_set
        # inside the trainer: no directories, and no files for the
        # unconditional samples, which do_test returns
        self.in_training = in_training
        self.it = 0
        self.noise = NoiseSource(torch.Generator().manual_seed(seed))
        self.reset_noise = NoiseSource(torch.Generator().manual_seed(seed + 1))
        # bucket granularity for variable-length inference (samples)
        self.bucket = int(args["tester"].get("bucket_pad", 16384))
        self.sampler = instantiate(args["tester"]["sampler"], self.network, self.diff_params,
                                   self.args, device=self.device)
        # every rank builds its tester, so every rank makes the mesh's groups;
        # the trainer hands the in-training tester its own mesh
        self.mesh = pmesh.make_mesh(pmesh.world_size()) \
            if pmesh.world_size() > 1 and not in_training else None
        self.writer = pmesh.global_rank() == 0

    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["dp"]

    # --- checkpoints -----------------------------------------------------
    def load_checkpoint(self, path: str) -> bool:
        """Load network weights from a checkpoint of the JAX package
        (``.ckpt`` / ``.npz``); prefers the EMA weights."""
        from buddy_tpu_torch.training.checkpoint import load_any_checkpoint
        tree, it = load_any_checkpoint(path, prefer_ema=True)
        self.network.load_jax_params(tree)
        self.it = it
        print(f"loaded checkpoint {path} (it={it})")
        return True

    def load_latest_checkpoint(self) -> bool:
        from buddy_tpu_torch.training.checkpoint import find_latest_checkpoint
        path = find_latest_checkpoint(self.args["model_dir"], self.args["exp"]["exp_name"])
        if path is None:
            raise ValueError("No checkpoint found")
        return self.load_checkpoint(path)

    # --- unconditional sampling ---------------------------------------------
    def sample_unconditional(self, mode):
        tcfg = self.args["tester"]
        audio_len = int(tcfg["unconditional"].get("audio_len", self.args["exp"]["audio_len"]))
        shape = (int(tcfg["unconditional"]["num_samples"]), audio_len)
        sharding = None
        if self._dp() > 1 and shape[0] % self._dp() == 0:
            sharding = pmesh.batch_sharding(self.mesh)
        preds = self.sampler.predict_unconditional(shape, noise=self.noise, sharding=sharding)
        if sharding is not None:                    # the whole batch on the first rank
            preds = pmesh.gather_rows(self.mesh, preds)
        preds = None if preds is None else _numpy(preds)
        if not self.in_training and self.writer:
            for i in range(len(preds)):
                write_audio_file(preds[i], self.args["exp"]["sample_rate"],
                                 f"unconditional_{i}", path=self.paths["unconditional"])
        return preds

    # --- dereverberation ------------------------------------------------------
    def _bucket_pad(self, n: int) -> int:
        b = self.bucket
        return ((n + b - 1) // b) * b if b > 0 else n

    def _chunk_plan(self, n: int):
        """(chunk size, overlap, hop, number of chunks, padded length) of the
        overlap-add path for an utterance of n samples."""
        ccfg = self.args["tester"].get("chunked", {})
        cs = int(ccfg.get("chunk_size", 131072))
        ov = int(ccfg.get("overlap", 16384))
        hop = cs - ov
        n_chunks = max(1, int(np.ceil(max(n - ov, 1) / hop)))
        return cs, ov, hop, n_chunks, (n_chunks - 1) * hop + cs

    @staticmethod
    def _chunk_window(cs: int, ov: int, first: bool, last: bool, single: bool) -> np.ndarray:
        """Hann cross-fade ramps on both sides; no ramp where a chunk has no
        neighbour (the left of the first chunk, the right of a lone one)."""
        w = np.ones(cs, np.float32)
        if ov > 0:
            ramp = 0.5 * (1 - np.cos(np.pi * np.arange(ov) / ov))
            w[:ov] = ramp
            w[-ov:] = ramp[::-1]
            if first:
                w[:ov] = 1.0
            if last and single:
                w[-ov:] = 1.0
        return w

    def _predict_chunked(self, y, operator, blind: bool, n: int) -> np.ndarray:
        """Overlap-add chunked guided sampling of one long utterance, y (1, n').

        Fixed-size chunks with a hann cross-fade over the overlap.  In blind
        mode the subband filter is estimated on the FIRST chunk and reused
        (informed subband mode) for the rest: the RIR belongs to the room,
        not to the chunk.
        """
        cs, ov, hop, n_chunks, total = self._chunk_plan(n)
        y_np = np.zeros((1, total), np.float32)
        y_np[:, :n] = _numpy(y)[:, :n]
        out = np.zeros(total, np.float32)
        wsum = np.zeros(total, np.float32)
        for c in range(n_chunks):
            start = c * hop
            y_c = torch.from_numpy(y_np[:, start:start + cs]).to(self.device)
            pred_c = _numpy(self.sampler.predict_conditional(
                y_c, operator, blind=blind and c == 0, noise=self.noise))[0]
            w = self._chunk_window(cs, ov, c == 0, c == n_chunks - 1, n_chunks == 1)
            out[start:start + cs] += pred_c * w
            wsum[start:start + cs] += w
        out = out / np.maximum(wsum, 1e-8)
        return out[None, :n]

    def _prepare_item(self, i: int, scaling: float):
        """Normalise and degrade one test item.  Returns (seg, rir,
        rir_padded, y, filename, n, n_pad, operator_ref)."""
        exp, tcfg = self.args["exp"], self.args["tester"]
        original, rir, filename = self.test_set[i]
        seg = np.asarray(original, np.float32)
        seg = scaling * seg / _std(seg)                      # sigma_data scale
        rir = np.asarray(rir, np.float32)
        # zero-pad the RIR to a bucket so that RIRs of one bucket batch
        # together (the convolution is unchanged)
        rb = _RIR_BUCKET
        rir_padded = np.pad(rir, (0, ((len(rir) + rb - 1) // rb) * rb - len(rir)))
        operator_ref = RIROperator(tcfg["informed_dereverberation"]["op_hp"],
                                   time_kernel_size=rir.shape[-1],
                                   sample_rate=exp["sample_rate"], device=self.device)
        operator_ref.update_params(rir_padded)
        y = operator_ref.degradation(torch.from_numpy(seg).to(self.device)[None, :])
        n = seg.shape[-1]
        return seg, rir, rir_padded, _numpy(y), filename, n, self._bucket_pad(n), operator_ref

    def _blind_operator(self) -> BlindSubbandFiltering:
        tcfg = self.args["tester"]
        if tcfg["blind_dereverberation"]["operator"] != "subband_filtering":
            raise NotImplementedError(tcfg["blind_dereverberation"]["operator"])
        return BlindSubbandFiltering(tcfg["informed_dereverberation"]["op_hp"],
                                     sample_rate=self.args["exp"]["sample_rate"],
                                     device=self.device)

    def _reset(self, operator, batch: int | None = None, reset_noise=None):
        """Fresh operator state from the tester's reset noise (or
        ``reset_noise``): batched (params, H) for ``batch`` utterances, or in
        place for one."""
        shape = (batch or 1, operator.length_rir)
        noise = (reset_noise or self.reset_noise).normal("reset", shape, self.device)
        if batch is None:
            return operator.reset(noise=noise[0])
        return operator.reset_batched(batch, noise=noise)

    def _write_item_outputs(self, mode, seg, y, pred, rir, filename, est_rir=None):
        base = os.path.basename(filename)[:-4]
        fs = self.args["exp"]["sample_rate"]
        write_audio_file(seg, fs, base, path=self.paths[mode + "original"])
        write_audio_file(_numpy(y), fs, base, path=self.paths[mode + "degraded"])
        path_rec = write_audio_file(pred, fs, base, path=self.paths[mode + "reconstructed"])
        write_audio_file(rir, fs, base, path=self.paths[mode + "true_rir"])
        if est_rir is not None:
            write_audio_file(est_rir, fs, base, path=self.paths[mode + "estimated_rir"])
        print(path_rec)
        if self.args["tester"].get("evaluate", {}).get("use", False):
            self._write_metrics(mode, base, seg, y, pred, rir, est_rir)

    def _write_metrics(self, mode, base, seg, y, pred, rir, est_rir):
        """Objective metrics per utterance -> <mode dir>/metrics.jsonl."""
        m = evaluation.evaluate_utterance(
            seg, _numpy(pred).reshape(-1), degraded=_numpy(y).reshape(-1),
            true_rir=rir, est_rir=est_rir)
        m["file"] = base
        path = os.path.join(os.path.dirname(self.paths[mode + "reconstructed"]), "metrics.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                for k, v in m.items()}) + "\n")
        print(f"  metrics: si_sdr={m['si_sdr']:.2f} dB "
              f"(degraded {m['si_sdr_degraded']:.2f}), lsd={m['lsd']:.2f}")

    def _group_items(self, items, blind: bool, batch_size: int):
        """Batches of at most ``batch_size`` prepared items that share a
        padded length (and, when informed, an RIR bucket); a tail batch runs
        at its own size.  Yields (padded length, batch)."""
        groups: dict = {}
        for it in items:
            key = (it[6],) if blind else (it[6], it[2].shape[-1])
            groups.setdefault(key, []).append(it)
        for key, group in groups.items():
            for s in range(0, len(group), batch_size):
                yield key[0], group[s:s + batch_size]

    def test_dereverberation_batched(self, mode, blind: bool = False):
        """Batched full-test-set dereverberation: each group of utterances
        runs through ``predict_conditional_batched`` as one batch, split
        over the ranks where it divides (the module's docstring)."""
        tcfg = self.args["tester"]
        scaling = float(tcfg["posterior_sampling"]["warm_initialization"]["scaling_factor"])
        batch_size = int(tcfg["batched"].get("batch_size", 4))
        chunk_threshold = int(tcfg.get("chunked", {}).get("threshold", 163840))
        operator_blind = self._blind_operator() if blind else None
        dp = self._dp()
        mesh = self.mesh if tcfg["batched"].get("shard", True) and dp > 1 \
            and batch_size % dp == 0 else None

        items = [self._prepare_item(i, scaling) for i in range(len(self.test_set))]
        long_items = [it for it in items if it[5] > chunk_threshold]
        items = [it for it in items if it[5] <= chunk_threshold]

        for n_pad, batch in self._group_items(items, blind, batch_size):
            noise, reset_noise, mine = self.noise, self.reset_noise, batch
            shard = mesh is not None and len(batch) % dp == 0
            if shard:                       # this rank's rows, the global batch's draws
                r = mesh.coords["dp"]
                noise, reset_noise = ShardedNoise(noise, r, dp), ShardedNoise(reset_noise, r, dp)
                mine = batch[pmesh.batch_sharding(mesh).block((len(batch),))[0]]
            ys = np.zeros((len(mine), 1, n_pad), np.float32)
            for b, it in enumerate(mine):
                ys[b, :, :it[5]] = it[3][:, :it[5]]
            ys = torch.from_numpy(ys).to(self.device)
            if blind:
                operator = operator_blind
                op_params_b, H_b = self._reset(operator, len(mine), reset_noise)
                preds = self.sampler.predict_conditional_batched(
                    ys, operator, blind=True, noise=noise,
                    op_params_batch=op_params_b, H_batch=H_b)
                est = torch.stack([operator.get_time_RIR(H=operator.H[b])
                                   for b in range(len(mine))])
            else:
                operator = mine[0][7]                        # any RIROperator
                H_b = torch.from_numpy(np.stack([it[2] for it in mine])).to(self.device)
                preds = self.sampler.predict_conditional_batched(
                    ys, operator, blind=False, noise=noise, H_batch=H_b)
                est = None
            if shard:
                preds = pmesh.gather_rows(mesh, preds)
                est = None if est is None else pmesh.gather_rows(mesh, est)
            if not self.writer:
                continue
            preds = _numpy(preds)
            for b, it in enumerate(batch):
                seg, rir, _rp, y, filename, n, _np, _op = it
                self._write_item_outputs(mode, seg, y, preds[b, ..., :n], rir, filename,
                                         est_rir=None if est is None else _numpy(est[b]))

        for it in long_items:                                # serial chunked path
            seg, rir, _rp, y, filename, n, _npad, operator_ref = it
            operator = operator_blind if blind else operator_ref
            if blind:
                self._reset(operator)
            pred = self._predict_chunked(y, operator, blind, n)
            est = _numpy(operator.get_time_RIR(H=operator.H)) if blind else None
            if self.writer:
                self._write_item_outputs(mode, seg, y, pred, rir, filename, est_rir=est)

    def test_dereverberation(self, mode, blind: bool = False):
        if self.test_set is None:
            print("No test set specified")
            return
        if len(self.test_set) == 0:
            print("No samples found in test set")
            return
        tcfg = self.args["tester"]
        if tcfg.get("batched", {}).get("use", False):
            return self.test_dereverberation_batched(mode, blind=blind)
        scaling = float(tcfg["posterior_sampling"]["warm_initialization"]["scaling_factor"])
        chunk_threshold = int(tcfg.get("chunked", {}).get("threshold", 163840))
        # one blind operator for the whole set; its state is reset per item
        operator_blind = self._blind_operator() if blind else None

        for i in range(len(self.test_set)):
            seg, rir, _rp, y, filename, n, n_pad, operator_ref = self._prepare_item(i, scaling)
            operator = operator_blind if blind else operator_ref
            if blind:
                self._reset(operator)
            if n > chunk_threshold:
                pred = self._predict_chunked(y, operator, blind, n)
            else:
                y_padded = torch.from_numpy(np.pad(y, ((0, 0), (0, n_pad - n)))).to(self.device)
                pred = _numpy(self.sampler.predict_conditional(
                    y_padded, operator, blind=blind, noise=self.noise))[..., :n]
            est_rir = _numpy(operator.get_time_RIR(H=operator.H)) if blind else None
            if self.writer:
                self._write_item_outputs(mode, seg, y, pred, rir, filename, est_rir=est_rir)

    # --- directory layout ----------------------------------------------------
    def prepare_directories(self, mode, unconditional: bool = False):
        self.paths = {}
        overriden = self.args["tester"].get("overriden_name", None)
        if overriden is not None and overriden != "None":
            self.path_sampling = os.path.join(self.args["model_dir"], overriden)
        else:
            self.path_sampling = os.path.join(
                self.args["model_dir"], "test" + date.today().strftime("%d_%m_%Y"))
        os.makedirs(self.path_sampling, exist_ok=True)

        self.paths[mode] = os.path.join(self.path_sampling, mode, self.args["exp"]["exp_name"])
        os.makedirs(self.paths[mode], exist_ok=True)
        if unconditional:
            return
        subs = ["original", "degraded", "reconstructed"]
        if "dereverberation" in mode:
            subs.append("true_rir")
            if mode == "blind_dereverberation":
                subs.append("estimated_rir")
        for sub in subs:
            p = os.path.join(self.paths[mode], sub)
            os.makedirs(p, exist_ok=True)
            self.paths[mode + sub] = p

    def save_experiment_args(self, mode):
        save_config(self.args, os.path.join(self.paths[mode], ".argv"))

    # --- dispatch ----------------------------------------------------------------
    def do_test(self, it: int = 0):
        self.it = it
        for m in self.args["tester"]["modes"]:
            if m == "unconditional":
                print("testing unconditional")
                if not self.in_training and self.writer:
                    self.prepare_directories(m, unconditional=True)
                    self.save_experiment_args(m)
                return self.sample_unconditional(m)
            elif m == "informed_dereverberation":
                print("testing informed dereverberation")
                if not self.in_training and self.writer:
                    self.prepare_directories(m)
                    self.save_experiment_args(m)
                self.test_dereverberation(m)
            elif m == "blind_dereverberation":
                print("testing blind dereverberation")
                if not self.in_training and self.writer:
                    self.prepare_directories(m)
                    self.save_experiment_args(m)
                self.test_dereverberation(m, blind=True)
            else:
                print("Warning: unknown mode: ", m)
