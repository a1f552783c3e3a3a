"""(b) What a run loads and what the reference imports: no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``buddy_tpu`` (compared
as whole names: ``buddy_tpu_torch`` is the port), and nothing of the port
in ``portbench/reference/``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench import registry, run

REFERENCE = os.path.join(registry.HERE, "reference")


def test_whole_names():
    sys.modules.setdefault("buddy_tpu_torch_probe", sys)
    try:
        assert "buddy_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["buddy_tpu_torch_probe"]
    assert run.FORBIDDEN == {"jax", "jaxlib", "flax", "buddy_tpu"}


def test_a_run_loads_no_jax(small_cpu):
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"r = run.run_cell('blind_full_b32', 5, 0.05, False, 'cpu', base={small_cpu!r}, "
        f"benchmark={os.path.join(small_cpu, 'BENCHMARK.json')!r})\n"
        "print(json.dumps({'correct': r['correct'], 'top': sorted({m.split('.')[0] "
        "for m in sys.modules})}))\n")
    env = dict(os.environ, PYTHONPATH=registry.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=registry.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "buddy_tpu_torch" in res["top"]
    assert not set(res["top"]) & run.FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_port():
    files = [os.path.join(REFERENCE, f) for f in os.listdir(REFERENCE) if f.endswith(".py")]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in {"buddy_tpu_torch", "buddy_tpu", "jax", "jaxlib", "flax"}, (f, mod)
            assert top in {"torch", "numpy", "math", "__future__", "portbench"}, (f, mod)
            if top == "portbench":
                assert mod.startswith("portbench.reference"), (f, mod)


def test_no_result_without_a_card():
    """The command exits non-zero and prints no result where no CUDA device is."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "blind_full_b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=registry.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
