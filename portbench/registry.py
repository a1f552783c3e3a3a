"""Where the benchmark finds what belongs to one name: a cell in
``workloads/<cell>.json``, a configuration in ``configs/<config>.json``, a
driver in ``drivers/<driver>.py``, a per-layer reader in
``metrics/<metric>.py`` (or one shared by ``<quantity>.<part>`` names in
``metrics/<quantity>.py``), and the list of metrics of each cell in the
repository's ``BENCHMARK.json``. A later cell, configuration or metric is
a new file and a new entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, base: str = HERE) -> dict:
    cell = _json(os.path.join(base, "workloads", f"{name}.json"))
    cell["name"] = name
    return cell


def load_config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "configs", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def load_metric(name: str, base: str = HERE):
    """The reader of ``name``: a module with UNIT and read(record), in
    ``metrics/<name>.py``, else in ``metrics/<quantity>.py`` for a name
    ``<quantity>.<part>`` (``idle_share.train`` and ``idle_share.serve``
    share ``idle_share.py``: their layer and the metric they move are
    ``BENCHMARK.json``'s); in ``base`` first, then the benchmark's own."""
    for stem in (name, name.split(".")[0]):
        for root in (base, HERE):
            path = os.path.join(root, "metrics", f"{stem}.py")
            if os.path.exists(path):
                return _module(path, f"portbench_metric_{name}")
    raise FileNotFoundError(f"no reader for the metric {name!r}")


def metrics_of(cell: str, kind: str, benchmark: str | None = None) -> list:
    """[(name, unit)] of the ``kind`` ("end_to_end" or "per_layer") metrics
    that ``BENCHMARK.json`` gives the cell: those that list it; of those
    that list no cells, the end-to-end ones, and the per-layer ones whose
    end-to-end metric the cell reports."""
    spec = _json(benchmark or os.path.join(ROOT, "BENCHMARK.json"))
    listed = lambda m: cell in m["workloads"] if "workloads" in m else None
    e2e = [m["name"] for m in spec["end_to_end"] if listed(m) in (True, None)]
    if kind == "end_to_end":
        return [(m["name"], m["unit"]) for m in spec[kind] if m["name"] in e2e]
    return [(m["name"], m["unit"]) for m in spec[kind]
            if listed(m) or (listed(m) is None and m["moves"] in e2e)]
