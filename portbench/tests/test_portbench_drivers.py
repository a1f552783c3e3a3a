"""(a) Each driver at a tiny network (nf=8) on the CPU, through the whole
run after the look for a chip (the port's plain kernel paths), held to the
frozen reference; and each fault a cell can have, planted in the port's
classes, turning ``correct`` false."""

from __future__ import annotations

import os

import pytest
from conftest import CELLS

from portbench import control, registry, run

SEED = 2 ** 31 + 11                 # above 32 signed bits, as the driver's seeds are


def _run(base, cell, seed=SEED, traced=False):
    return run.run_cell(cell, seed, 0.05, traced, "cpu", base=base,
                        benchmark=os.path.join(base, "BENCHMARK.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_matches_reference(small_cpu, cell):
    r = _run(small_cpu, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    gaps = {k: c["value"] for k, c in r["checks"].items() if k.endswith("_gap")}
    # float32 on both sides: only rounding parts them
    assert max(gaps.values()) < 1e-3, gaps
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(small_cpu, cell, fault):
    driver = registry.load_cell(cell, small_cpu)["driver"]
    with control.fault(fault, driver):
        r = _run(small_cpu, cell, seed=SEED + 1)
    assert not r["correct"], r["checks"]


def test_traced_run_reports_per_layer(small_cpu):
    r = _run(small_cpu, CELLS[0], traced=True)
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device events on the CPU: the readers of the trace return nothing
    assert "idle_share.serve" not in r["metrics"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith(("blind", "informed"))])
def test_first_and_last_batch_are_checked(small_cpu, cell):
    """A window of three batches: the check follows the sampled rows of the
    first and the last together, the middle one's record is dropped, and a
    sound run stays within the cell's limits."""
    spec = registry.load_cell(cell, small_cpu)
    config = registry.load_config(spec["config"], small_cpu)
    d = registry.load_driver(spec["driver"]).Driver(spec, config, SEED + 2, "cpu")
    d.setup()
    for k in range(3):
        d._batch(k)
    assert d.checked() == [0, 2]
    assert d.rows(0) != d.rows(2) or spec["traffic"]["batch"] <= spec["traffic"]["check_rows"]
    d.failed()
    d.free_program()
    numbers = d.check()
    assert len(d.steps[0]["x"]) == 2 * len(d.rows(0))
    assert all(numbers[k] <= lim for k, lim in spec["limits"].items()), numbers


def test_train_window_left_unchanged_is_not_correct(small_cpu):
    """The three checked steps sound, then every step of the window returns
    the state unchanged: the check of the window's state catches it."""
    from buddy_tpu_torch.training.trainer import Trainer
    spec = registry.load_cell("train_b16", small_cpu)
    config = registry.load_config(spec["config"], small_cpu)
    d = registry.load_driver("train").Driver(spec, config, SEED + 3, "cpu")
    d.setup()
    with control.patched(Trainer, "_update", lambda self, it: self.params[self.trainable[0]]
                         .new_zeros(())):
        d.run_window(0.0)
    d.failed()
    d.free_program()
    numbers = d.check()
    assert numbers["window_mismatch"] > 0, numbers
    assert numbers["loss_gap"] <= spec["limits"]["loss_gap"], numbers
