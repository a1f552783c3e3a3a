"""Parameter layouts: the JAX package's tree, the port's state dict, and
the reference's torch ``.pt`` checkpoints.

``from_jax_params`` turns the JAX tree into the port's state dict, the
inverse of ``buddy_tpu/models/convert.py::_convert_leaf``, and
``to_jax_params`` turns it back:

    Conv   kernel (kH, kW, I, O)  <-> weight (O, I, kH, kW)
    Dense  kernel (in, out)       <-> weight (out, in)
    GroupNorm scale / bias        <-> weight / bias
    NIN W / b, GaussianFourier W  <-> unchanged

The tree is the JAX package's ``NetworkBundle.params`` as nested dicts of
numpy arrays (``{"params": {"unet": {"all_modules_{i}": ...,
"output_layer": ...}}}``); its keys are the port's
``unet.all_modules.{i}.<sub>.<name>``.  A static int8 network's variables
also hold a "quant" collection of calibrated scales, ``{"quant": {"unet":
{... "Conv_0": {"a_scale": (C_in,)}}}}``: the port's ``a_scale`` buffers
under the same paths.

``convert_torch_state_dict`` and ``load_torch_checkpoint`` do what the JAX
package's do: a reference ``.pt`` file, read with ``torch.load``, becomes
the JAX tree (the reference's module names are the port's, without the
``unet.`` of the time wrapper).
"""

from __future__ import annotations

from typing import Any, Mapping

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
    """Nested numpy dicts of the JAX variables (or of the parameter tree
    alone) -> torch state dict, the "quant" collection's scales included."""
    trees = [tree]
    if "params" in tree:
        trees = [tree["params"]] + ([tree["quant"]] if "quant" in tree else [])
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

    for t in trees:
        walk(t, [])
    return out


def _to_jax_leaf(name: str, value: np.ndarray):
    if name == "weight":
        if value.ndim == 4:
            return "kernel", value.transpose(2, 3, 1, 0)
        if value.ndim == 2:
            return "kernel", value.T
        return "scale", value
    return name, value


def to_jax_params(state: Mapping) -> dict:
    """The port's state dict (tensors) -> the JAX variables, nested dicts of
    float32 numpy arrays under ``{"params": ...}``, and the ``a_scale``
    buffers under ``{"quant": ...}`` where there are any."""
    trees: dict = {}
    for key, value in state.items():
        tree = trees.setdefault("quant" if key.endswith(".a_scale") else "params", {})
        parts = key.split(".")
        path, i = [], 0
        while i < len(parts) - 1:
            if parts[i] == "all_modules":
                path.append(f"all_modules_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        name, arr = _to_jax_leaf(parts[-1], np.asarray(arr, np.float32))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    trees.setdefault("params", {})
    return trees


# ---------------------------------------------------------------------------
# the reference's torch checkpoints (buddy_tpu/models/convert.py)
# ---------------------------------------------------------------------------
def convert_torch_state_dict(state_dict: Mapping[str, Any], *,
                             wrap_time: bool = True) -> dict:
    """A reference ``network``/``ema`` state dict -> the JAX tree.

    Keys ``all_modules.{i}[.{sub}].{param}`` map to
    ``all_modules_{i}[/{sub}]/{param'}``, ``output_layer.*`` likewise (the
    layouts of ``to_jax_params``), under ``unet`` with ``wrap_time`` (the
    time wrapper adds no parameters); other keys are skipped."""
    kept = {k: v for k, v in state_dict.items()
            if k.split(".")[0] in ("all_modules", "output_layer")}
    tree = to_jax_params(kept)["params"]
    return {"params": {"unet": tree} if wrap_time else tree}


def load_torch_checkpoint(path: str, *, prefer_ema: bool = True,
                          wrap_time: bool = True) -> tuple[dict, int]:
    """A reference ``.pt`` checkpoint -> (the JAX tree, iteration): the
    ``ema`` weights when present and preferred, else ``network`` /
    ``model``; the legacy ``{'model', 'ema_weights'}`` layout and the
    ``diffusion.`` / ``diffusion_ema.`` prefixes are handled as the
    reference's loaders handle them.  The file is unpickled in full (it
    holds the reference's config object): load only files you trust."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    it = int(state.get("it", 0)) if isinstance(state, dict) else 0
    if isinstance(state, dict):
        if prefer_ema and "ema" not in state and "ema_weights" in state \
                and "model" in state:
            model_sd = state["model"]
            ema_w = state["ema_weights"]
            if len(ema_w) == len(model_sd):
                state = {k: w for k, w in zip(model_sd.keys(), ema_w)}
            else:  # the EMA covers the trainable tensors only
                merged, i = {}, 0
                for k, tensor in model_sd.items():
                    if tensor.requires_grad and i < len(ema_w):
                        merged[k] = ema_w[i]
                        i += 1
                    else:
                        merged[k] = tensor
                state = merged
        else:
            for key in (("ema", "network", "model") if prefer_ema
                        else ("network", "model", "ema")):
                if key in state and isinstance(state[key], dict):
                    state = state[key]
                    break
        if any(k.startswith(("diffusion.", "diffusion_ema.")) for k in state):
            pref = "diffusion_ema." if prefer_ema and any(
                k.startswith("diffusion_ema.") for k in state) else "diffusion."
            state = {k[len(pref):]: v for k, v in state.items()
                     if k.startswith(pref)}
    return convert_torch_state_dict(state, wrap_time=wrap_time), it
