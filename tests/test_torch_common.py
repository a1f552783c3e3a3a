"""Shared helpers of the port's parity tests, and the port's guard tests.

The parity tests hold ``buddy_tpu_torch`` against the JAX package on the
CPU: inputs are made with numpy from a seed and fed to both; the port runs
the plain PyTorch versions of its kernels (a CUDA kernel runs only on the
card, where ``chip_smoke.py`` holds it against its plain version).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_NET = [
    "network.nf=8",
    "network.ch_mult=[1,2]",
    "network.num_res_blocks=1",
    "network.image_size=256",
]

# the blind program at test size (tests/test_batched.py:28-40)
BLIND_SMALL = [
    "tester=blind_dereverberation_BUDDy",
    *TINY_NET,
    "tester.sampling_params.T=2",
    "tester.posterior_sampling.blind_hp.op_updates_per_step=2",
    "tester.posterior_sampling.warm_initialization.wpe.taps=10",
]


def jax_compose(overrides):
    from buddy_tpu.config import compose
    return compose("conf_VCTK.yaml", list(overrides))


def torch_compose(overrides):
    from buddy_tpu_torch.config import compose
    return compose("conf_VCTK.yaml", list(overrides))


def op_hp(args):
    return args["tester"]["informed_dereverberation"]["op_hp"]


def randomize_tree(tree, seed: int):
    """Replace every leaf of a JAX parameter tree with seeded numpy values of
    a scale that keeps activations O(1): kernels ~ N(0, 1/fan_in), GroupNorm
    scales ~ 1 + N(0, 0.1^2), other vectors ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32) * 0.1
        return v + 1.0 if name == "scale" else v

    return walk(tree)


def jax_tiny_bundle(n: int, seed: int = 0, dtype=None):
    """The JAX package's TINY_NET network with randomized parameters (the
    tree's shapes come from tracing ``init``, which is much cheaper on the
    CPU than running it)."""
    from buddy_tpu.config import instantiate
    from buddy_tpu.models import NetworkBundle
    extra = [f"network.compute_dtype={dtype}"] if dtype else []
    module = instantiate(jax_compose(TINY_NET + extra)["network"])
    struct = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, n)),
                            jnp.zeros((1,)))
    tree = randomize_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), struct), seed)
    return NetworkBundle(module, jax.tree.map(jnp.asarray, tree)), tree


def torch_tiny_bundle(tree, dtype=None):
    """The port's TINY_NET network on the CPU, loaded from ``tree``."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.models import NetworkBundle
    extra = [f"network.compute_dtype={dtype}"] if dtype else []
    args = torch_compose(TINY_NET + extra)
    net = NetworkBundle(instantiate(args["network"], device="cpu"))
    net.load_jax_params(tree)
    return net


class ReplayNoise:
    """A noise source for the port's sampler that hands out given arrays in
    order, per kind ("init", "eps", "reg")."""

    def __init__(self, draws):
        self.draws = {k: list(v) for k, v in draws.items()}

    def normal(self, kind, shape, device):
        arr = self.draws[kind].pop(0)
        assert tuple(arr.shape) == tuple(shape), (kind, arr.shape, shape)
        return torch.as_tensor(np.asarray(arr, np.float32), device=device)


def jax_step_draws(rng, n_updates: int, x_shape, rir_len: int, reg: bool):
    """The draws of one JAX DPS step from carry key ``rng``
    (dps.py:224 k_eps, :150 k_reg); returns (next carry key, eps, [reg])."""
    rng, k_eps = jax.random.split(rng)
    eps = np.asarray(jax.random.normal(k_eps, x_shape, jnp.float32))
    regs = []
    k = rng
    for _ in range(n_updates):
        k, k_reg = jax.random.split(k)
        if reg:
            regs.append(np.asarray(jax.random.normal(k_reg, (rir_len,))))
    return k, eps, regs


def jax_program_draws(key, B: int, n: int, T: int, n_updates: int, rir_len: int, reg: bool,
                      split: bool = True):
    """All draws of JAX's ``predict_conditional_batched(rng=key)`` for B
    utterances (dps.py:357 split, :277 k_init, :224 k_eps, :150 k_reg),
    stacked batch-first as the port's sampler asks for them.  ``split=False``
    gives the draws of the serial ``predict_conditional(rng=key)`` (B = 1,
    the key is used as it is)."""
    per = [[] for _ in range(B)]
    inits = []
    for b, rng in enumerate(jax.random.split(key, B) if split else [key]):
        rng, k_init = jax.random.split(rng)
        inits.append(np.asarray(jax.random.normal(k_init, (1, n))))
        for _ in range(T):
            rng, eps, regs = jax_step_draws(rng, n_updates, (1, n), rir_len, reg)
            per[b].append((eps, regs))
    draws = {"init": [np.concatenate(inits)], "eps": [], "reg": []}
    for i in range(T):
        draws["eps"].append(np.concatenate([per[b][i][0] for b in range(B)]))
        for u in range(len(per[0][i][1])):
            draws["reg"].append(np.stack([per[b][i][1][u] for b in range(B)]))
    return draws


def jax_unconditional_draws(key, shape, T: int):
    """The draws of JAX's ``EulerHeunSampler.predict(shape, rng=key)``
    (euler_heun.py:137 k_init, :103 k_eps)."""
    rng, k_init = jax.random.split(key)
    draws = {"init": [np.asarray(jax.random.normal(k_init, shape))], "eps": []}
    for _ in range(T):
        rng, k_eps = jax.random.split(rng)
        draws["eps"].append(np.asarray(jax.random.normal(k_eps, shape, jnp.float32)))
    return draws


def jax_reset_noise(k_op, length: int, batch=None):
    """The phase noise of JAX's operator reset: ``reset(k_op)`` (one
    utterance, (1, length)) or ``reset_batched(k_op, batch)`` ((batch,
    length), subband.py:453 split)."""
    keys = [k_op] if batch is None else jax.random.split(k_op, batch)
    return np.stack([np.asarray(jax.random.normal(k, (length,))) for k in keys])


def merge_draws(*draws):
    """Concatenate replay dictionaries in the order the port will ask."""
    out: dict = {}
    for d in draws:
        for k, v in d.items():
            out.setdefault(k, []).extend(v)
    return out


def jax_tester_draws(mode: str, n_items: int, n_pad: int, T: int, n_updates: int, rir_len: int,
                     length_rir: int, *, batched: bool = False, samples: int = 1, seed: int = 42):
    """The draws of the JAX ``Tester(rng=PRNGKey(seed)).do_test()`` for one
    mode, as (sampler draws, reset draws) for the port's ``Tester.noise`` and
    ``Tester.reset_noise``: unconditional (tester.py:83 split), serial
    dereverberation per item (:364 k_op when blind, :374 k_pred) or one
    batch of all items (:279 split in three)."""
    rng = jax.random.PRNGKey(seed)
    blind = mode == "blind_dereverberation"
    if mode == "unconditional":
        rng, k = jax.random.split(rng)
        return jax_unconditional_draws(k, (samples, n_pad), T), {}
    if batched:
        rng, k_op, k_pred = jax.random.split(rng, 3)
        resets = {"reset": [jax_reset_noise(k_op, length_rir, n_items)]} if blind else {}
        return jax_program_draws(k_pred, n_items, n_pad, T, n_updates if blind else 0,
                                 rir_len, reg=blind), resets
    draws, resets = [], {"reset": []}
    for _ in range(n_items):
        if blind:
            rng, k_op = jax.random.split(rng)
            resets["reset"].append(jax_reset_noise(k_op, length_rir))
        rng, k_pred = jax.random.split(rng)
        draws.append(jax_program_draws(k_pred, 1, n_pad, T, n_updates if blind else 0, rir_len,
                                       reg=blind, split=False))
    return merge_draws(*draws), resets


def to_torch(params):
    """A dict of arrays as (writable) torch tensors."""
    return {k: torch.tensor(np.asarray(v)) for k, v in params.items()}


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# ---------------------------------------------------------------------------
# guard tests
# ---------------------------------------------------------------------------
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "buddy_tpu")
_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|buddy_tpu)\b"
    r"|import_module\(\s*['\"](jax|jaxlib|flax|optax|buddy_tpu)\b", re.M)


def _port_files():
    pkg = os.path.join(REPO, "buddy_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return files


def test_port_files_import_no_jax():
    """No file of buddy_tpu_torch/ and not chip_smoke.py imports JAX, flax,
    optax or the JAX package."""
    offenders = []
    for path in _port_files():
        with open(path) as f:
            if _IMPORT_RE.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax, flax, optax
    and buddy_tpu cannot be imported (the Triton kernel sources under csrc/
    are skipped: they import triton, which exists only beside the card)."""
    code = f"""
import importlib, pkgutil, sys
BLOCKED = {_FORBIDDEN!r}
for k in list(sys.modules):
    if k.split('.')[0] in BLOCKED:
        del sys.modules[k]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import buddy_tpu_torch
n = 0
for m in pkgutil.walk_packages(buddy_tpu_torch.__path__, 'buddy_tpu_torch.'):
    if not m.name.startswith('buddy_tpu_torch.csrc.') and not m.name.endswith('__main__'):
        importlib.import_module(m.name)
        n += 1
assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]
print('imported', n)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 35


def test_entry_points_raise_without_cuda(monkeypatch):
    """Built without ``device=`` on a host with no CUDA, the sampler, the
    operator and the network raise instead of running on the CPU."""
    from buddy_tpu_torch.config import instantiate
    from buddy_tpu_torch.diffusion.edm import EDM
    from buddy_tpu_torch.operators.subband import BlindSubbandFiltering
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = torch_compose(BLIND_SMALL)
    edm = EDM(sde_hp=dict(args["diff_params"]["sde_hp"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        instantiate(args["tester"]["sampler"], lambda x, c: x, edm, args)
    with pytest.raises(RuntimeError, match="CUDA"):
        BlindSubbandFiltering(op_hp(args))
    with pytest.raises(RuntimeError, match="CUDA"):
        instantiate(args["network"])
    # asked for explicitly, the CPU is fine
    instantiate(args["tester"]["sampler"], lambda x, c: x, edm, args, device="cpu")


def test_kernel_wrappers_refuse_cpu_fallback_for_cuda_inputs():
    """A wrapper takes its plain version only for CPU tensors: a tensor that
    claims another device reaches the kernel path, which raises here (no
    card) instead of silently computing on the CPU."""
    from buddy_tpu_torch.ops import groupnorm, stft, subband_conv
    meta = torch.empty((1, 4, 2, 2), device="meta")
    with pytest.raises((ValueError, RuntimeError, ImportError)):
        groupnorm.group_norm_act(meta, torch.ones(4, device="meta"),
                                 torch.zeros(4, device="meta"), 1)
    with pytest.raises((ValueError, RuntimeError, ImportError)):
        stft.stft_analysis(torch.empty((1, 8, 4), device="meta"),
                           stft.StftPlan(8, 4, stft.hann_window(8), device="cpu"), 5)
    with pytest.raises((ValueError, RuntimeError, ImportError)):
        stft.stft_synthesis(torch.empty((1, 5, 5), dtype=torch.complex64, device="meta"),
                            stft.StftPlan(8, 4, stft.hann_window(8), device="cpu"))
    with pytest.raises((ValueError, RuntimeError, ImportError)):
        subband_conv.subband_conv(torch.empty((1, 3, 5), dtype=torch.complex64, device="meta"),
                                  torch.empty((1, 3, 2), dtype=torch.complex64, device="meta"), 1)


def test_public_entry_points_default_to_no_device():
    """Every public class and function of the package whose signature has a
    ``device`` parameter defaults it to None, so that ``resolve_device``
    picks the card or raises: nothing defaults to the CPU."""
    import importlib
    import inspect
    import pkgutil
    import buddy_tpu_torch
    seen, offenders = 0, []
    for m in pkgutil.walk_packages(buddy_tpu_torch.__path__, "buddy_tpu_torch."):
        if m.name.startswith("buddy_tpu_torch.csrc.") or m.name.endswith("__main__"):
            continue
        module = importlib.import_module(m.name)
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != m.name:
                continue
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            targets = [obj] + [f for n, f in vars(obj).items()
                               if inspect.isfunction(f) and not n.startswith("_")] \
                if inspect.isclass(obj) else [obj]
            for t in targets:
                device = inspect.signature(t).parameters.get("device")
                if device is None:
                    continue
                seen += 1
                if device.default not in (None, inspect.Parameter.empty):
                    offenders.append(f"{m.name}.{getattr(t, '__qualname__', name)}")
    assert not offenders, offenders
    assert seen >= 8
