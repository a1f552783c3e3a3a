"""Fixtures of the benchmark's own tests: tiny cells derived from the real
ones, and the ``card`` marker for the tests that need a CUDA device.

Run them from the repository's root:

    python -m pytest portbench/tests -q               # the CPU tests
    python -m pytest portbench/tests -q -m card       # on a machine with a card
"""

from __future__ import annotations

import json
import os

import pytest

from portbench import registry

# every cell and configuration the benchmark holds files for, whether or
# not BENCHMARK.json lists it
CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE, "workloads")))
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(registry.HERE, "configs")))
SMALL = {"dps": {"batch": 2, "audio_len": 16384, "steps": 2, "check_rows": 2},
         "train": {"batch": 4, "audio_len": 16384, "files": 6, "files_per_speaker": 3,
                   "file_s": 2.0, "check_block_rows": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


def write_small_cells(root: str, nf: int, profile: str | None = None) -> str:
    """Every cell of the benchmark's files at a small size under ``root``: the
    configurations at ``nf`` filters, the traffic cut to a few short rows
    (``SMALL``), the real cells' limits, and a BENCHMARK.json listing them.
    ``profile`` overrides the cells' precision profile. Returns ``root``."""
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    spec = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    for name in CONFIGS:
        cfg = registry.load_config(name)
        cfg["network"]["nf"] = nf
        if profile is not None:
            cfg["profiles"] = {profile: cfg["profiles"].get(profile, {"compute_dtype": None,
                                                                     "fuse_resample": False})}
        json.dump(cfg, open(os.path.join(root, "configs", f"{name}.json"), "w"))
    for name in CELLS:
        cell = registry.load_cell(name)
        cell.pop("name")
        small = dict(SMALL[cell["driver"]])
        if "d_gap_low_sigma" in cell["limits"]:
            # it reads the rounding of the last steps, which grows as the
            # schedule shortens (float32 on both sides, nf=8: 1.2e-5 at the
            # cell's 8 steps, 6e-5 at 2): such a cell keeps its steps
            small.pop("steps")
        cell["traffic"].update(small)
        if profile is not None:
            cell["profile"] = profile
        json.dump(cell, open(os.path.join(root, "workloads", f"{name}.json"), "w"))
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


@pytest.fixture(scope="session")
def small_cpu(tmp_path_factory):
    """The cells at nf=8 in float32, for the CPU (the port's plain kernel
    paths)."""
    return write_small_cells(str(tmp_path_factory.mktemp("cells_cpu")), 8, "training")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
