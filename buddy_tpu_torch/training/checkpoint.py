"""Checkpoints in the JAX package's ``.ckpt`` layout
(``buddy_tpu/training/checkpoint.py``), so that each package loads the
other's files.

A ``.ckpt`` is an npz of flattened trees: ``params/...`` and ``ema/...``
(the network's parameters in the JAX tree's layout, ``models/convert.py``),
``it``, ``opt/00000``... (the optimizer state's leaves in the order of
``jax.tree.leaves(opt.init(params))``: Adam's int32 count, then its first
moments, then its second, each tree with its keys sorted) and ``args_json``
(the config).  The JAX package also stores its PRNG key under ``rng``; the
port stores its ``torch.Generator``'s state under ``torch_generator_state``
instead, a key the JAX package does not read.

``load_any_checkpoint`` reads ``.ckpt`` / ``.npz`` files and the reference's
torch ``.pt`` files (converted by ``models/convert.py``).  Orbax checkpoint
directories, which the JAX package can also read, are not ported: they need
the ``orbax`` package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from glob import glob
from typing import Optional, Sequence, Tuple

import numpy as np

GENERATOR_KEY = "torch_generator_state"


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": leaf}, keys in sorted order at every level
    (the order of ``jax.tree.leaves``)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves`` order."""
    return list(_flatten(tree).values())


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def tree_like(tree, leaves: Sequence) -> dict:
    """Nested dicts shaped as ``tree`` holding ``leaves`` (in the order of
    ``tree_leaves(tree)``)."""
    return _unflatten(dict(zip(_flatten(tree), leaves)))


def save_checkpoint(path: str, *, params, ema_params, opt_leaves: Optional[Sequence] = None,
                    it: int = 0, generator_state=None, args=None) -> str:
    """Write ``<path>.ckpt``: ``params`` and ``ema_params`` as JAX trees
    (nested dicts of numpy arrays), the optimizer state's leaves in JAX's
    order, the iteration, the generator's state (a uint8 tensor or array)
    and the config."""
    path = path if path.endswith(".ckpt") else path + ".ckpt"
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"ema/{k}": v for k, v in _flatten(ema_params).items()})
    flat["it"] = np.asarray(it)
    for i, leaf in enumerate(opt_leaves or ()):
        flat[f"opt/{i:05d}"] = np.asarray(leaf)
    if generator_state is not None:
        flat[GENERATOR_KEY] = np.asarray(generator_state, np.uint8)
    if args is not None:
        cfg = args.to_dict() if hasattr(args, "to_dict") else dict(args)
        flat["args_json"] = np.asarray(json.dumps(cfg, default=str))
    with open(path, "wb") as f:      # np.savez would append .npz to the name
        np.savez(f, **flat)
    return path


def load_opt_state(path: str, template: Sequence) -> Optional[list]:
    """The optimizer state's leaves saved by ``save_checkpoint`` (either
    package's), cast and shaped as the arrays of ``template`` (the leaves of
    a fresh state, in JAX's order); None where the checkpoint holds none."""
    if not path.endswith((".ckpt", ".npz")):
        return None
    with np.load(path, allow_pickle=False) as data:
        keys = sorted(k for k in data.files if k.startswith("opt/"))
        if not keys:
            return None
        if len(keys) != len(template):
            raise ValueError(
                f"optimizer state mismatch: checkpoint has {len(keys)} leaves, "
                f"optimizer expects {len(template)} — was the optimizer config changed?")
        return [np.asarray(data[k]).astype(np.asarray(t).dtype).reshape(np.shape(t))
                for k, t in zip(keys, template)]


def load_extras(path: str) -> dict:
    """The generator state (``"generator_state"``), the JAX package's PRNG
    key (``"rng"``) and the config (``"args"``), those that the file holds."""
    out = {}
    if path.endswith((".ckpt", ".npz")):
        with np.load(path, allow_pickle=False) as data:
            if GENERATOR_KEY in data.files:
                out["generator_state"] = np.asarray(data[GENERATOR_KEY])
            if "rng" in data.files:
                out["rng"] = np.asarray(data["rng"])
            if "args_json" in data.files:
                out["args"] = json.loads(str(data["args_json"]))
    return out


def _load_npz(path: str, prefer_ema: bool) -> Tuple[dict, int]:
    with np.load(path, allow_pickle=False) as data:
        it = int(data["it"]) if "it" in data.files else 0
        for head in (("ema", "params") if prefer_ema else ("params", "ema")):
            sub = {k[len(head) + 1:]: data[k] for k in data.files if k.startswith(head + "/")}
            if sub:
                return _unflatten(sub), it
    raise ValueError(f"no params found in {path}")


def load_any_checkpoint(path: str, prefer_ema: bool = True) -> Tuple[dict, int]:
    """(parameter tree in the JAX layout, iteration) from a ``.ckpt`` /
    ``.npz`` checkpoint of either package or a reference ``.pt`` file; the
    EMA weights where present and preferred."""
    if path.endswith(".pt"):
        from buddy_tpu_torch.models.convert import load_torch_checkpoint
        return load_torch_checkpoint(path, prefer_ema=prefer_ema)
    if path.endswith((".ckpt", ".npz")):
        return _load_npz(path, prefer_ema)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: loading Orbax checkpoint directories is not ported (it needs the orbax "
            "package); save it as a .ckpt with the JAX package "
            "(buddy_tpu.training.checkpoint.save_checkpoint)")
    raise ValueError(f"unrecognized checkpoint format: {path}")


_CKPT_RE = r"-(\d+)\.(ckpt|pt)$"


def find_latest_checkpoint(model_dir: str, exp_name: str) -> Optional[str]:
    """The ``<exp_name>-<it>`` checkpoint of ``model_dir`` with the largest
    iteration, or None."""
    candidates = (glob(os.path.join(model_dir, f"{exp_name}-*.ckpt"))
                  + glob(os.path.join(model_dir, f"{exp_name}-*.pt")))
    best, best_it = None, -1
    for c in candidates:
        m = re.search(_CKPT_RE, c)
        if m and int(m.group(1)) > best_it:
            best, best_it = c, int(m.group(1))
    return best


def remove_checkpoint(path: Optional[str]) -> None:
    """Delete a checkpoint file (or directory); a failure is reported, not
    raised, as the JAX package does while rotating checkpoints."""
    if path and os.path.exists(path):
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            print("removed last checkpoint", path)
        except OSError:
            print("could not remove last checkpoint", path)
