"""JAX parameter tree -> the port's state dict.

The inverse of ``buddy_tpu/models/convert.py::_convert_leaf``:

    Conv   kernel (kH, kW, I, O)  -> weight (O, I, kH, kW)
    Dense  kernel (in, out)       -> weight (out, in)
    GroupNorm scale / bias        -> weight / bias
    NIN W / b, GaussianFourier W  -> unchanged

The tree is the JAX package's ``NetworkBundle.params`` as nested dicts of
numpy arrays (``{"params": {"unet": {"all_modules_{i}": ...,
"output_layer": ...}}}``); its keys become ``unet.all_modules.{i}.<sub>.<name>``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


def from_jax_params(tree: Mapping) -> dict:
    """Nested numpy dicts of the JAX parameter tree -> torch state dict."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, Mapping):
                part = key
                if key.startswith("all_modules_"):
                    part = "all_modules." + key[len("all_modules_"):]
                walk(value, path + [part])
            else:
                name, arr = _leaf(key, np.asarray(value, np.float32))
                out[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out
