"""Write the tiny checkpoint of the port's CLI runs
(tests/goldens/torch_tiny.ckpt.npz).

A 4-level NCSN++ (nf=8, ch_mult [1,2,2,2], one ResBlock per level) with
seeded random parameters, saved by the JAX package's ``save_checkpoint`` in
its ``.ckpt`` layout (an npz of ``params/...``, ``ema/...`` and ``it``): the
file a JAX training run would leave.  ``chip_smoke.py`` and
tests/test_torch_tester.py hand it to ``python -m buddy_tpu_torch.testing``
with the network overrides of ``TINY_CKPT_NET`` below.  The EMA tree is the
parameter tree scaled by 0.5, so a test can tell which of the two a loader
took.  The name ends in ``.npz`` because ``*.ckpt`` is git-ignored.

Run from the repo root:
    JAX_PLATFORMS=cpu python tests/make_torch_tiny_ckpt.py
"""
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_CKPT_NET = ["network.nf=8", "network.ch_mult=[1,2,2,2]", "network.num_res_blocks=1"]
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "torch_tiny.ckpt.npz")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from buddy_tpu.config import compose, instantiate
    from buddy_tpu.training.checkpoint import save_checkpoint
    from test_torch_common import randomize_tree

    module = instantiate(compose("conf_VCTK.yaml", TINY_CKPT_NET)["network"])
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 16384)),
                            jnp.zeros((1,)))
    params = randomize_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), struct), seed=5)
    ema = jax.tree.map(lambda a: (0.5 * a).astype(np.float32), params)
    path = save_checkpoint(OUT[:-len(".npz")], params=params, ema_params=ema, it=7)
    shutil.move(path, OUT)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    print(f"{OUT}: {n} parameters, {os.path.getsize(OUT) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
