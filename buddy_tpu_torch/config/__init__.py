"""Hydra-compatible configuration: compose, instantiate, ConfigDict.

A copy of ``buddy_tpu/config/__init__.py`` (the port imports nothing of the
JAX package) over the port's own ``conf/`` tree, whose ``_target_`` entries
name ``buddy_tpu_torch``.  A root YAML with a ``defaults`` list pulls one file
per config group; ``group=name`` overrides swap a group's file, dotted
``key.path=value`` overrides set values, ``+key=value`` adds keys.

Public API:
    compose(config_name, overrides=[], config_dir=None) -> ConfigDict
    instantiate(cfg, *args, **kwargs) -> object
    parse_cli(argv) -> (config name, overrides, device) of the CLIs
    ConfigDict — attribute-access dict
"""

from __future__ import annotations

import argparse
import copy
import importlib
import os
from typing import Any, Iterable

import yaml

_DEFAULT_CONF_DIR = os.path.join(os.path.dirname(__file__), "conf")


class ConfigDict(dict):
    """A dict with attribute access, mirroring the OmegaConf node API surface
    used by the reference (``cfg.a.b``, ``cfg.get(k, d)``, ``k in cfg.keys()``).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, ConfigDict):
                super().__setitem__(k, _wrap(v))

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        """Recursively convert back to plain dicts (for YAML/JSON dumps)."""
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigDict) else x for x in v]
            else:
                out[k] = v
        return out


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, dict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _merge(dst: ConfigDict, src: dict) -> ConfigDict:
    """Deep-merge ``src`` into ``dst`` (src wins; dicts merge recursively)."""
    for k, v in src.items():
        if k in dst and isinstance(dst[k], ConfigDict) and isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = _wrap(v)
    return dst


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def compose(config_name: str, overrides: Iterable[str] = (), config_dir: str | None = None) -> ConfigDict:
    """Compose a config the way Hydra composes the reference's ``conf/`` tree.

    The root YAML's ``defaults`` list entries like ``{dset: vctk_16k_4s}`` load
    ``<config_dir>/dset/vctk_16k_4s.yaml`` under the ``dset`` key.  Overrides
    are ``key.path=value`` strings (``+key=value`` adds a new key, and a bare
    ``group=name`` swaps which file a config group is composed from, exactly
    like the reference's shell wrappers, e.g. ``tester=blind_dereverberation_BUDDy``
    in test_blind_dereverberation.sh).
    """
    config_dir = config_dir or _DEFAULT_CONF_DIR
    if not config_name.endswith((".yaml", ".yml")):
        config_name += ".yaml"
    root = _load_yaml(os.path.join(config_dir, config_name))
    defaults = root.pop("defaults", [])

    # Group swaps in overrides (e.g. "tester=blind_dereverberation_BUDDy")
    # take effect during composition; dotted/typed overrides apply afterwards.
    group_names = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, name), = entry.items()
            group_names[group] = name

    value_overrides = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        key = key.lstrip("+")
        if key in group_names and "." not in key:
            group_names[key] = value
        else:
            value_overrides.append((key, value))

    cfg = ConfigDict()
    for group, name in group_names.items():
        group_cfg = _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))
        _merge(cfg, {group: group_cfg})
    _merge(cfg, root)

    for key, value in value_overrides:
        _set_dotted(cfg, key, yaml.safe_load(value) if value != "" else None)
    return cfg


def _set_dotted(cfg: ConfigDict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], ConfigDict):
            node[p] = ConfigDict()
        node = node[p]
    node[parts[-1]] = _wrap(value)


def locate(target: str) -> Any:
    """Import a dotted ``module.Class`` path (hydra.utils.get_class analogue)."""
    module_path, _, attr = target.rpartition(".")
    module = importlib.import_module(module_path)
    return getattr(module, attr)


def instantiate(cfg: ConfigDict, *args: Any, **kwargs: Any) -> Any:
    """``hydra.utils.instantiate`` analogue: call ``_target_`` with the node's
    remaining keys as kwargs (nested ``_target_`` nodes are left as configs,
    matching the reference's usage where sub-configs are plain hyperparameter
    bags, e.g. train.py:23-47)."""
    if cfg is None:
        return None
    target = cfg["_target_"]
    node_kwargs = {k: v for k, v in cfg.items() if k != "_target_"}
    node_kwargs.update(kwargs)
    return locate(target)(*args, **node_kwargs)


def save_config(cfg: ConfigDict, path: str) -> None:
    """OmegaConf.save analogue (tester.py:205-207 writes the resolved config)."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def parse_cli(argv):
    """(config name, overrides, device) from the command line of
    ``python -m buddy_tpu_torch.testing`` and ``python -m
    buddy_tpu_torch.training``: ``--config-name=<yaml>`` and the reference's
    override grammar; the reference's ``+gpu=N`` is accepted and dropped,
    and ``device=<name>`` picks the device (None: the card) and is not part
    of the config."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config-name", default="conf_VCTK.yaml")
    known, rest = parser.parse_known_args(argv)
    overrides, device = [], None
    for o in rest:
        if "=" not in o:
            continue
        key, _, value = o.lstrip("+").partition("=")
        if key == "device":
            device = value
        elif key != "gpu":
            overrides.append(o)
    return known.config_name, overrides, device
