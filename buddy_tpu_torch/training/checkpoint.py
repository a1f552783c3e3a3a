"""Checkpoint loading (the loading half of ``buddy_tpu/training/checkpoint.py``).

The JAX package saves its training state as an npz of flattened pytrees
(``params/...``, ``ema/...``, ``it``) under the name ``<exp>-<it>.ckpt``.
``load_any_checkpoint`` returns the network's parameter tree as nested dicts
of numpy arrays, which ``models/convert.py::from_jax_params`` turns into the
port's state dict (``NetworkBundle.load_jax_params``): a checkpoint written
by the JAX package loads into the port.  Saving, the reference's torch
``.pt`` files and Orbax directories are not ported yet.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Optional, Tuple

import numpy as np


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _load_npz(path: str, prefer_ema: bool) -> Tuple[dict, int]:
    with np.load(path, allow_pickle=False) as data:
        it = int(data["it"]) if "it" in data.files else 0
        for head in (("ema", "params") if prefer_ema else ("params", "ema")):
            sub = {k[len(head) + 1:]: data[k] for k in data.files if k.startswith(head + "/")}
            if sub:
                return _unflatten(sub), it
    raise ValueError(f"no params found in {path}")


def load_any_checkpoint(path: str, prefer_ema: bool = True) -> Tuple[dict, int]:
    """(parameter tree, iteration) from a ``.ckpt`` / ``.npz`` checkpoint of
    the JAX package; the EMA weights where present and preferred."""
    if path.endswith((".ckpt", ".npz")):
        return _load_npz(path, prefer_ema)
    if path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: loading the reference's torch .pt checkpoints is not ported; convert "
            "it to a .ckpt with the JAX package (buddy_tpu.training.checkpoint)")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: loading Orbax checkpoint directories is not ported; save it as a "
            ".ckpt with the JAX package (buddy_tpu.training.checkpoint.save_checkpoint)")
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
