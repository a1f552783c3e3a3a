"""The parameter-count table of ``logging.print_model_summary``
(``buddy_tpu/utils/summary.py``).

The network's parameters are walked in the JAX package's tree
(``models/convert.py::to_jax_params``), so that the rows carry the JAX
package's module names and the table is the one it prints for the same
weights.
"""

from __future__ import annotations

import numpy as np

from buddy_tpu_torch.models.convert import to_jax_params


def print_model_summary(params, max_depth: int = 2) -> int:
    """Print a parameter-count table grouped to ``max_depth`` levels of the
    JAX tree, and return the total.  ``params``: the port's parameters by
    name (``dict(module.named_parameters())``)."""
    rows: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            key = "/".join(path[:max_depth])
            rows[key] = rows.get(key, 0) + int(np.prod(np.shape(node)))

    walk(to_jax_params(params)["params"], ())

    width = max((len(k) for k in rows), default=10) + 2
    print(f"{'Module':<{width}}{'Parameters':>12}")
    print("-" * (width + 12))
    total = 0
    for k in sorted(rows):
        print(f"{k:<{width}}{rows[k]:>12,}")
        total += rows[k]
    print("-" * (width + 12))
    print(f"{'Total':<{width}}{total:>12,}")
    return total
