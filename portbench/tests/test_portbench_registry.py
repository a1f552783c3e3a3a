"""(e) A cell, a configuration and a per-layer metric dropped into a
directory as new files, with their entries in a BENCHMARK.json, are picked
up by name: no file of the benchmark changes."""

from __future__ import annotations

import json
import os

from portbench import registry, run

READER = '''"""Steps a window, from the traced run's record."""

UNIT = "steps"


def read(rec):
    return float(rec["steps"])
'''


def test_new_files_are_found(small_cpu, tmp_path):
    base = str(tmp_path)
    for sub in ("configs", "workloads", "metrics"):
        os.makedirs(os.path.join(base, sub))
    cfg = registry.load_config("buddy_ncsnpp", small_cpu)
    cfg["network"]["ch_mult"] = [1, 2, 2]
    json.dump(cfg, open(os.path.join(base, "configs", "new_net.json"), "w"))
    cell = registry.load_cell("blind_identity_b32", small_cpu)
    cell.pop("name")
    cell["config"] = "new_net"
    json.dump(cell, open(os.path.join(base, "workloads", "new_cell.json"), "w"))
    open(os.path.join(base, "metrics", "steps_per_window.py"), "w").write(READER)
    spec = json.load(open(os.path.join(small_cpu, "BENCHMARK.json")))
    spec["workloads"].append({"name": "new_cell", "config": "new_net", "traffic": "new_cell",
                              "chips": 1, "why": "a cell added as files"})
    spec["end_to_end"][0]["workloads"].append("new_cell")
    spec["per_layer"].append({"name": "steps_per_window.serve", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "sampler loop", "moves": "audio_s_per_s",
                              "workloads": ["new_cell"]})
    bench = os.path.join(base, "BENCHMARK.json")
    json.dump(spec, open(bench, "w"))

    assert registry.load_config("new_net", base)["network"]["ch_mult"] == [1, 2, 2]
    assert registry.load_cell("new_cell", base)["config"] == "new_net"
    assert ("steps_per_window.serve", "steps") in registry.metrics_of("new_cell", "per_layer",
                                                                      bench)
    assert [m for m, _ in registry.metrics_of("new_cell", "end_to_end", bench)] == \
        ["audio_s_per_s", "peak_mem_gib", "setup_s"]
    r = run.run_cell("new_cell", 3, 0.05, True, "cpu", base=base, benchmark=bench)
    assert r["metrics"]["steps_per_window.serve"]["value"] == 2.0
    assert r["correct"], r["checks"]


def test_metrics_of_the_benchmark():
    spec = json.load(open(os.path.join(registry.ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        e2e = [m for m, _ in registry.metrics_of(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(w["name"], "per_layer")
    for m in spec["per_layer"]:
        assert registry.load_metric(m["name"]).UNIT == m["unit"]
