"""Readings that set a cell's limits: the numbers the check compares, for
sound runs of the program, for its control and for planted faults, over
several seeds in one process. The benchmark's own runs never run this.

    python3 -m portbench.control --workload <cell> --mode program|control|<fault> \\
        --seconds 1 --seeds 11 12 13 ...

``control`` runs the program with its own path one precision below the
cell's: the cell's ``control`` entry gives the overrides (the int8
convolutions for a bfloat16 network) or ``tf32`` (TF32 switched on for a
float32 one). A fault is planted in the program's classes for the whole
run (set-up included): ``unchanged`` (a step returns its state unchanged),
``half_batch`` (half of the batch left out, the mean taken over the rest),
``altered`` (the answers altered where they are produced: each step's
result scaled by 1.02). One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import sys
import time

from portbench import registry


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def tf32_on():
    """The port's float32 switch turned the other way: TF32 on wherever the
    port sets its precision."""
    import torch
    from buddy_tpu_torch import device as dev

    def on():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    with patched(dev, "set_float32_precision", on):
        yield


@contextlib.contextmanager
def fault(kind: str, driver: str):
    """Plant ``kind`` in the port's sampler (driver dps) or trainer (train)."""
    import torch
    if driver == "dps":
        from buddy_tpu_torch.sampling.dps import EulerHeunSamplerDPS as S
        inner_step, inner_pred = S._scan_step, S.predict_conditional_batched
        if kind == "unchanged":
            def step(self, operator, blind, carry, *a):
                _, x_den = inner_step(self, operator, blind, carry, *a)
                return carry, x_den
            with patched(S, "_scan_step", step):
                yield
        elif kind == "half_batch":
            def pred(self, ys, operator, **kw):
                h = ys.shape[0] // 2
                if kw.get("op_params_batch") is not None:
                    kw["op_params_batch"] = {k: v[:h] for k, v in kw["op_params_batch"].items()}
                kw["H_batch"] = kw["H_batch"][:h]
                out = inner_pred(self, ys[:h], operator, **kw)
                if getattr(operator, "H", None) is not None:
                    operator.H = torch.cat([operator.H, operator.H.new_zeros(operator.H.shape)])
                return torch.cat([out, out.new_zeros(out.shape)])
            with patched(S, "predict_conditional_batched", pred):
                yield
        elif kind == "altered":
            def step(self, operator, blind, carry, *a):
                (x, *rest), x_den = inner_step(self, operator, blind, carry, *a)
                return (x * 1.02, *rest), x_den * 1.02
            with patched(S, "_scan_step", step):
                yield
        else:
            raise ValueError(kind)
        return
    from buddy_tpu_torch.training.trainer import Trainer as T
    if kind == "unchanged":
        def update(self, it):
            return torch.zeros((), device=self.device)
        with patched(T, "_update", update):
            yield
    elif kind == "half_batch":
        inner = T.get_batch

        def get_batch(self):
            b = inner(self)
            return b[:b.shape[0] // 2]
        with patched(T, "get_batch", get_batch):
            yield
    elif kind == "altered":
        inner = T._update

        def update(self, it):
            big = max(self.trainable, key=lambda n: self.params[n].numel())
            self.params[big].grad.mul_(1.1)
            return inner(self, it)
        with patched(T, "_update", update):
            yield
    else:
        raise ValueError(kind)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    from portbench import run
    run.fixed_caches()
    cell = registry.load_cell(a.workload)
    for seed in a.seeds:
        faulthandler.dump_traceback_later(run.HANG_S, exit=True)
        t0 = time.perf_counter()
        extra = cell["control"].get("overrides", []) if a.mode == "control" else []
        with contextlib.ExitStack() as stack:
            if a.mode == "control" and cell["control"].get("tf32"):
                stack.enter_context(tf32_on())
            elif a.mode not in ("program", "control"):
                stack.enter_context(fault(a.mode, cell["driver"]))
            numbers = {}
            result = run.run_cell(a.workload, seed, a.seconds, False, "cuda", extra=extra,
                                  numbers=numbers)
        line = {"workload": a.workload, "mode": a.mode, "seed": seed,
                "seconds": round(time.perf_counter() - t0, 1), "numbers": numbers,
                "correct": result["correct"], "metrics": result["metrics"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
