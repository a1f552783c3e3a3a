"""One rank of the gloo worlds of ``tests/test_torch_parallel.py``, on the CPU.

    python tests/torch_parallel_worker.py <dir> <rank> <world>

Joins the world through a file store in ``<dir>``, reads ``<dir>/spec.json``
and ``<dir>/inputs.npz`` (written by the test), runs the spec's jobs in turn
and writes ``<dir>/rank<rank>.npz``:

* ``train``: for each case (a list of config overrides), the port's Trainer
  at TINY_NET on the given weights and batch, with the given global draws
  replayed; one ``train_step``, ``save_checkpoint`` into a directory of the
  rank's own, then a second Trainer on every rank resumed from the first
  rank's checkpoint; the metrics, gradients, parameters, EMA and Adam's
  leaves in the JAX tree's order.  Under tp the leaves are gathered to the
  first rank and sent to the others, and each rank also keeps its own
  blocks (``blocks/``); a Trainer at tp=1 resumes the first rank's
  checkpoint too;
* ``loader``: for each case, the training CLI's order: a ``VCTKTrain`` and
  its threaded loader, then the test set (whose constructor reseeds numpy's
  global generator while the loader's thread draws crops from it), the
  in-training tester, then the Trainer on that loader; what the loader
  handed the rank and what ``get_batch`` returned, for a few steps; then
  ``heavy_logging``'s samples and the files it wrote;
* ``tester``: ``Tester.do_test()`` for each case, outputs under a directory
  of the rank's own; the returned unconditional samples.

It imports no JAX: the test hands it numpy arrays.
"""

import datetime
import json
import os
import sys

import numpy as np

THREADS = 2             # two ranks beside the test run's other workers
# a collective that a rank never joins (ranks issuing them in different
# orders) raises after this, inside the test's own limit on each rank
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=240)


def _tree(flat: dict, prefix: str) -> dict:
    """Nested dicts from the '/'-joined keys under ``prefix``."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


class Replay:
    """The given global draws, in order, by kind."""

    def __init__(self, draws: dict):
        self.draws = {k: list(v) for k, v in draws.items()}

    def normal(self, kind, shape, device):
        import torch
        arr = self.draws[kind].pop(0)
        assert tuple(arr.shape) == tuple(shape), (kind, arr.shape, shape)
        return torch.as_tensor(np.asarray(arr, np.float32), device=device)

    uniform = normal


class FixedLoader:
    def __init__(self, batch):
        self.batch = batch

    def next_batch(self):
        return self.batch


def _bundle(overrides, tree):
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.models import NetworkBundle
    net = NetworkBundle(instantiate(compose("conf_VCTK.yaml", overrides)["network"],
                                    device="cpu"))
    net.load_jax_params(tree)
    return net


def train(spec, inputs, rank, out_dir) -> dict:
    import torch.distributed as dist
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.models.convert import to_jax_params
    from buddy_tpu_torch.training.checkpoint import tree_leaves
    tree = _tree(inputs, "tree/")
    batch = inputs["batch"]
    res = {}
    for case in spec["cases"]:
        name = case["name"]
        model_dir = os.path.join(out_dir, f"{name}_rank{rank}")
        os.makedirs(model_dir, exist_ok=True)

        def build(extra, noise):
            args = compose("conf_VCTK.yaml", case["overrides"] + [f"model_dir={model_dir}",
                                                                  *extra])
            args["exp"]["model_dir"] = args["model_dir"]
            return instantiate(args["exp"]["trainer"], args, FixedLoader(batch),
                               _bundle(case["overrides"], tree), instantiate(args["diff_params"]),
                               None, device="cpu", noise=noise)

        draws = {"sigma": [inputs[f"draws/{name}/sigma"]],
                 "prior": [inputs[f"draws/{name}/prior"]]}
        tr = build([], Replay(draws))
        tr.train_step()
        tr.save_checkpoint()
        grads = {k: (p.grad if p.grad is not None else p.detach() * 0)
                 for k, p in tr.params.items()}
        states = {"grads": grads, "params": tr.params, "ema": tr.ema}
        whole = {what: tr.whole(st) for what, st in states.items()}
        leaves = {what: None if t is None else tree_leaves(t) for what, t in whole.items()}
        leaves["opt"] = tr.opt_leaves()
        tp = tr.mesh.tp
        if tp is not None:          # the first rank's whole tree on every rank
            sent = [leaves]
            dist.broadcast_object_list(sent, src=0)
            leaves = sent[0]
            for what, st in {**states, "mu": tr.mu, "nu": tr.nu}.items():
                for k, v in st.items():
                    res[f"{name}/blocks/{what}/{k}"] = v.detach().numpy()
            res[f"{name}/tp"] = np.asarray([tp.size, tp.rank])
        for what, ls in leaves.items():
            for i, leaf in enumerate(ls):
                res[f"{name}/{what}/{i:04d}"] = np.asarray(leaf)
        for k, v in tr._metrics_acc.items():
            res[f"{name}/metrics/{k}"] = v.numpy()
        res[f"{name}/mesh"] = np.asarray([tr.mesh.shape.get("dp", 1),
                                          tr.mesh.shape.get("sp", 1)])
        res[f"{name}/coords"] = np.asarray([tr.mesh.coords.get("dp", 0),
                                            tr.mesh.coords.get("sp", 0)])
        res[f"{name}/files"] = np.asarray(sorted(os.listdir(model_dir)), dtype=str)
        axis = next(a for a in ("sp", "tp", "dp") if a in tr.mesh.axis_names)
        res[f"{name}/groups"] = np.asarray([tr.mesh.group is dist.group.WORLD,
                                            tr.mesh.groups[axis] is tr.mesh.group])
        # every rank resumes from the first rank's checkpoint
        first = os.path.join(out_dir, f"{name}_rank0", os.path.basename(tr.latest_checkpoint))
        again = build(["exp.resume=True", f"exp.resume_checkpoint={first}"], None)
        res[f"{name}/resumed"] = np.asarray(
            again.it == tr.it and again.count == tr.count
            and all(np.array_equal(a.detach().numpy(), tr.params[k].detach().numpy())
                    for k, a in again.params.items()))
        if tp is not None:          # the tp=2 checkpoint at tp=1: the whole tree
            one = build(["exp.resume=True", f"exp.resume_checkpoint={first}", "exp.mesh.tp=1"],
                        None)
            got = (tree_leaves(to_jax_params(one.params)) + tree_leaves(to_jax_params(one.ema))
                   + one.opt_leaves())
            want = leaves["params"] + leaves["ema"] + leaves["opt"]
            res[f"{name}/resumed_tp1"] = np.asarray(
                one.it == tr.it and one.count == tr.count and one.mesh.tp is None
                and len(got) == len(want)
                and all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want)))
    return res


def loader(spec, inputs, rank, out_dir) -> dict:
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.data.loader import make_train_loader
    from buddy_tpu_torch.testing.tester import Tester
    tree = _tree(inputs, "tree/")
    res = {}
    for case in spec["cases"]:
        name = case["name"]
        args = compose("conf_VCTK.yaml", case["overrides"] + [
            f"model_dir={os.path.join(out_dir, f'loader_{name}_rank{rank}')}"])
        args["exp"]["model_dir"] = args["model_dir"]
        os.makedirs(args["model_dir"])
        train_loader = make_train_loader(instantiate(args["dset"]["train"]),
                                         batch_size=int(args["exp"]["batch_size"]),
                                         num_workers=int(args["exp"]["num_workers"]),
                                         seed=int(args["exp"]["seed"]))
        test_set = instantiate(args["dset"]["test"])
        net, diff = _bundle(case["overrides"], tree), instantiate(args["diff_params"])
        args["tester"]["sampling_params"]["same_as_training"] = True
        tester = Tester(args, net, diff, test_set=test_set, device="cpu", in_training=True)
        read, inner = [], train_loader.next_batch

        def next_batch():
            read.append(inner())
            return read[-1]
        train_loader.next_batch = next_batch
        try:
            tr = instantiate(args["exp"]["trainer"], args, train_loader, net, diff, tester,
                             device="cpu")
            for i in range(spec["steps"]):
                res[f"{name}/batch{i}"] = tr.get_batch().numpy()
                res[f"{name}/read{i}"] = read[-1]
        finally:
            train_loader.close()
        sampled, do_test = [], tester.do_test
        tester.do_test = lambda **k: sampled.append(do_test(**k)) or sampled[-1]
        tr.heavy_logging()
        if sampled[0] is not None:
            res[f"{name}/samples"] = np.asarray(sampled[0])
        res[f"{name}/tester_mesh"] = np.asarray(tester.mesh is tr.mesh)
        res[f"{name}/files"] = np.asarray(sorted(os.listdir(args["model_dir"])), dtype=str)
    return res


def tester(spec, inputs, rank, out_dir) -> dict:
    from buddy_tpu_torch.config import compose, instantiate
    from buddy_tpu_torch.testing.tester import Tester
    tree = _tree(inputs, "tree/")
    res = {}
    for case in spec["cases"]:
        name = case["name"]
        root = os.path.join(out_dir, f"{name}_rank{rank}")
        os.makedirs(root, exist_ok=True)
        args = compose("conf_VCTK.yaml", case["overrides"] + [f"model_dir={root}"])
        test_set = instantiate(args["dset"]["test"]) if case.get("test_set") else None
        t = Tester(args, _bundle(case["overrides"], tree), instantiate(args["diff_params"]),
                   test_set, device="cpu")
        out = t.do_test()
        if out is not None:
            res[f"{name}/samples"] = np.asarray(out)
        res[f"{name}/files"] = np.asarray(sorted(
            os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs), dtype=str)
    return res


def main(argv) -> int:
    out_dir, rank, world = argv[0], int(argv[1]), int(argv[2])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(THREADS)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(out_dir, "inputs.npz")) as data:
        inputs = {k: data[k] for k in data.files}
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        res = {}
        for job in spec["jobs"]:
            res.update({"train": train, "loader": loader, "tester": tester}[job["job"]](
                job, inputs, rank, out_dir))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
