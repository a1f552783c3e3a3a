"""On the card: each cell at its own size, one batch or step, sound and
with its control (the program one precision below the cell's). The sound
run is correct; the control is not. Skips without a CUDA device."""

from __future__ import annotations

import contextlib
import json
import os

import pytest

from portbench import control, registry, run

CELLS = [w["name"] for w in json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
         ["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    run.fixed_caches()
    r = run.run_cell(cell, 2 ** 31 + 101, 1.0, False, "cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    run.fixed_caches()
    spec = registry.load_cell(cell)["control"]
    with contextlib.ExitStack() as stack:
        if spec.get("tf32"):
            stack.enter_context(control.tf32_on())
        r = run.run_cell(cell, 2 ** 31 + 102, 1.0, False, "cuda",
                         extra=spec.get("overrides", []))
    assert not r["correct"], r["checks"]
