"""The device mesh over torch.distributed (``buddy_tpu/parallel/mesh.py``).

One process a card, the PyTorch idiom.  The JAX package is one controller
over every device and lets XLA insert the collectives; here each rank runs
its own share of the program and the trainer, the tester and the network's
column-sharded convolutions call the collectives themselves.  The function
names are the JAX module's, and so is the meaning of each:

* ``make_mesh(dp, tp, sp)``: the JAX asserts and its ``dp=-1`` rule over the
  world size, ranks laid out dp-major, then tp, then sp as ``Mesh.devices``
  is, and one process group along each axis through each rank;
* ``batch_sharding`` / ``shard_batch``: this rank's rows of the leading axis
  (split over ``dp``);
* ``waveform_sharding`` / ``shard_waveform_batch``: this rank's block of a
  (batch, samples) waveform batch, rows over ``dp`` and samples over ``sp``
  (the JAX package's input hint; the trainer takes ``shard_batch`` instead,
  see ``waveform_sharding``);
* ``replicated_sharding`` / ``replicate``: every rank holds the whole, a
  broadcast from the mesh's first rank;
* ``param_shardings`` / ``shard_params``: the tensor-parallel rule, a conv
  kernel's output channels (axis 0 of the port's OIHW weights, the last of
  the JAX package's HWIO kernels) split over ``tp`` where they divide, every
  other leaf replicated; ``gather_params`` rebuilds the whole tree on the
  first rank of each tp line.

A ``Sharding`` names, for each leading axis of an array, the mesh axis that
splits it (``None``: not split; axes past ``spec`` are whole), as a JAX
``PartitionSpec`` does, and ``Sharding.local`` cuts this rank's block out of
the global array.

Tensor parallelism (``Mesh.tp``, a ``TensorParallel``) runs each sharded
convolution on its rank's output channels between two conjugate
collectives over the tp group, as autograd Functions: ``copy_to_tp`` (the
identity forward; the input gradient summed over the group, since each rank
saw every input channel but produced only its own outputs) and
``gather_from_tp`` (an all-gather of the channels in rank order; the
gradient's slice of this rank).  They run on CUDA tensors (NCCL across
cards, gloo for several ranks on one card) and on CPU tensors (gloo).

Without ``WORLD_SIZE`` in the environment ``init_distributed`` makes no
process group, and a mesh of one rank makes no collective call: the
one-process path is the one the port had before the mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group that ``torchrun`` describes.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``.  Without ``WORLD_SIZE`` it returns
    False and makes nothing.  Where CUDA is available, the rank's card is
    set (``torch.cuda.set_device(LOCAL_RANK)``) before any kernel launches,
    so that ``resolve_device()`` gives ``cuda:<LOCAL_RANK>``; more ranks on
    this host than visible cards raise.  ``backend=None`` asks for NCCL for
    CUDA tensors and gloo for CPU tensors ("cpu:gloo,cuda:nccl"; gloo alone
    where there is no CUDA), so that the tester's gathers of CPU tensors
    have a backend; no other backend is chosen on the caller's behalf.
    """
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        if local_world > cards or local_rank >= cards:
            raise RuntimeError(f"{local_world} ranks on this host but {cards} visible CUDA "
                               f"card(s): one rank a card")
        torch.cuda.set_device(local_rank)
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method="env://", rank=rank,
                            world_size=world)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def describe() -> str:
    """This process's place in the world, for the CLIs' headers."""
    if world_size() == 1 and not (dist.is_available() and dist.is_initialized()):
        return "one process (no process group)"
    return f"rank {global_rank()} of {world_size()}, backend {dist.get_backend_config()}"


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on its tp line: the line's process group, this
    rank's index on it and the line's length."""

    group: object
    rank: int
    size: int

    def block(self, n: int) -> slice:
        """This rank's slice of ``n`` channels (``n`` divides by ``size``)."""
        if n % self.size:
            raise ValueError(f"{n} channels do not divide over tp={self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


class Mesh:
    """Ranks in a (dp[, tp][, sp]) grid.

    ``axis_names``, ``shape`` ({axis: size}), ``size`` and ``devices`` (the
    grid of global ranks) are the JAX ``Mesh``'s.  ``rank`` is this
    process's global rank and ``coords`` its index along each axis (None
    where the rank is outside the mesh).  ``group`` is the process group of
    every rank of the mesh (the default group where the mesh is the whole
    world), ``groups[axis]`` that of the ranks that differ from this one
    along ``axis`` alone (the gradient sum runs over ``groups["dp"]``, the
    sharded convolutions' collectives over ``groups["tp"]``); an axis line
    that is the whole mesh reuses ``group``.  All are None without a
    process group, for a mesh of one rank, or outside the mesh.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], rank: int,
                 make_groups: bool):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        self.coords = dict(zip(self.axis_names, map(int, where[0]))) if len(where) else None
        self.groups: dict = {name: None for name in self.axis_names}
        self.group = None
        if not (make_groups and self.size > 1):
            return
        # every rank of the world makes every group, its own or not
        group = dist.group.WORLD if self.size == dist.get_world_size() else \
            dist.new_group([int(r) for r in self.devices.flat])
        for axis, name in enumerate(self.axis_names):
            n = self.devices.shape[axis]
            if n == 1:
                continue
            if n == self.size:
                self.groups[name] = group
                continue
            for line in np.moveaxis(self.devices, axis, -1).reshape(-1, n):
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[name] = g
        if self.coords is None:
            self.groups = {name: None for name in self.axis_names}
        else:
            self.group = group

    @property
    def in_mesh(self) -> bool:
        return self.coords is not None

    @property
    def first_rank(self) -> int:
        return int(self.devices.flat[0])

    def line(self, axis: str) -> list:
        """The global ranks of this rank's line along ``axis``, in order."""
        if axis not in self.axis_names:
            return [self.rank]
        index = tuple(slice(None) if a == axis else self.coords[a] for a in self.axis_names)
        return [int(r) for r in self.devices[index]]

    @property
    def tp(self) -> Optional[TensorParallel]:
        """This rank's tp line (None without a tp axis or outside the mesh)."""
        if self.shape.get("tp", 1) == 1 or not self.in_mesh:
            return None
        return TensorParallel(self.groups["tp"], self.coords["tp"], self.shape["tp"])


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1) -> Mesh:
    """Build a ("dp"[, "tp"][, "sp"]) mesh over the world's ranks.

    dp=-1 takes every rank left after the tp and sp axes; ranks are laid out
    dp-major, then tp, then sp, and this process's rank picks the
    coordinates.  Process groups are made when a process group is
    initialised, and then every rank must call ``make_mesh`` with the same
    arguments.
    """
    tp = int(tp) if tp not in (None, 0, -1) else 1
    sp = int(sp) if sp not in (None, 0, -1) else 1
    world = world_size()
    if dp in (-1, 0, None):
        dp = world // (tp * sp)
    if dp < 1:
        raise ValueError(f"tp={tp} x sp={sp} leaves no ranks for dp (have {world})")
    if dp * tp * sp > world:
        raise ValueError(f"requested dp={dp} x tp={tp} x sp={sp} > {world} ranks")
    axes = [("dp", dp)] + [(n, k) for n, k in (("tp", tp), ("sp", sp)) if k > 1]
    names, dims = tuple(n for n, _ in axes), tuple(k for _, k in axes)
    devices = np.arange(int(np.prod(dims))).reshape(dims)
    return Mesh(devices, names, global_rank(),
                make_groups=dist.is_available() and dist.is_initialized())


@dataclass(frozen=True)
class Sharding:
    """Axis ``i`` of an array is split over mesh axis ``spec[i]`` (None: not
    split; axes past ``spec`` are whole), as ``NamedSharding(mesh, P(*spec))``."""

    mesh: Mesh
    spec: tuple

    def block(self, shape) -> tuple:
        """The slices of this rank's block of a global array of ``shape``."""
        if not self.mesh.in_mesh:
            raise ValueError(f"rank {self.mesh.rank} is outside the mesh {self.mesh.shape}")
        out = []
        for dim, name in enumerate(self.spec):
            if name is None or self.mesh.shape.get(name, 1) == 1:
                out.append(slice(None))
                continue
            n, i = self.mesh.shape[name], self.mesh.coords[name]
            if shape[dim] % n:
                raise ValueError(f"axis {dim} of {tuple(shape)} does not divide over "
                                 f"{name}={n}")
            size = shape[dim] // n
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def local(self, x):
        return x[self.block(x.shape)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Split the leading (batch) axis over dp."""
    return Sharding(mesh, ("dp",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def waveform_sharding(mesh: Mesh) -> Sharding:
    """A (batch, samples) waveform batch: rows over ``dp`` and, where the
    mesh has an ``sp`` axis, samples over ``sp``.  The JAX package hands
    this to GSPMD as an input hint and lets it all-gather the time axis,
    so there sp spreads the input pipeline's memory but not the compute.
    Every rank here already holds the whole global batch on the host, so the
    trainer takes ``batch_sharding``'s rows instead, whole: sp spreads
    neither the input nor the compute."""
    if "sp" in mesh.axis_names:
        return Sharding(mesh, ("dp", "sp"))
    return batch_sharding(mesh)


def shard_batch(mesh: Mesh, batch):
    return batch_sharding(mesh).local(batch)


def shard_waveform_batch(mesh: Mesh, batch):
    return waveform_sharding(mesh).local(batch)


def tp_sharded(shape, tp: int) -> bool:
    """The tensor-parallel rule (``buddy_tpu/parallel/mesh.py::param_shardings``):
    a conv kernel, the only 4-D leaves, splits its output channels over tp
    where they divide."""
    return tp > 1 and len(shape) == 4 and shape[0] % tp == 0


def param_shardings(mesh: Mesh, tree) -> dict:
    """{name: Sharding} of a tree of whole parameters in the port's layout
    (OIHW conv weights): the output channels (axis 0) of a conv weight over
    ``tp`` where they divide, every other leaf replicated.  Output-channel
    sharding keeps each rank's GroupNorm groups whole (min(C // 4, 32)
    groups: the C / tp boundary lands on a group boundary for NCSN++'s
    widths), so GroupNorm's statistics stay local."""
    tp = int(mesh.shape.get("tp", 1))
    return {k: Sharding(mesh, ("tp",)) if tp_sharded(tuple(v.shape), tp)
            else replicated_sharding(mesh) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# collectives; a group of None (one rank) makes no call
# ---------------------------------------------------------------------------
def _flat_by_dtype(tensors):
    """[(dtype, [tensors], flat buffer)] of the tensors, one buffer a dtype."""
    by: dict = {}
    for t in tensors:
        by.setdefault(t.dtype, []).append(t)
    return [(dt, ts, torch.cat([t.reshape(-1) for t in ts])) for dt, ts in by.items()]


def _unflatten_into(tensors, flat) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_reduce_sum(tensors, group) -> None:
    """Sum ``tensors`` in place over ``group``: one flat buffer (a dtype),
    one collective."""
    if group is None:
        return
    for _, ts, flat in _flat_by_dtype(tensors):
        dist.all_reduce(flat, group=group)
        _unflatten_into(ts, flat)


@torch.no_grad()
def replicate(mesh: Mesh, tensors) -> None:
    """Every rank of the mesh takes the mesh's first rank's values of
    ``tensors`` (in place; one broadcast a dtype)."""
    if mesh.group is None:
        return
    for _, ts, flat in _flat_by_dtype(tensors):
        dist.broadcast(flat, src=mesh.first_rank, group=mesh.group)
        _unflatten_into(ts, flat)


def shard_params(mesh: Mesh, params: dict) -> dict:
    """Place whole parameters by ``param_shardings`` in place: every rank
    takes the mesh's first rank's values, then keeps its block of the
    sharded leaves (``.data`` replaced).  Returns the shardings, which
    ``gather_params`` takes."""
    shardings = param_shardings(mesh, params)
    replicate(mesh, list(params.values()))
    if mesh.in_mesh:
        for k, p in params.items():
            if shardings[k].spec:
                p.data = shardings[k].local(p.data).clone()
    return shardings


def _sharded_names(shardings: dict, state: dict) -> list:
    return [k for k in state if shardings[k].spec]


def pack_blocks(shardings: dict, state: dict) -> torch.Tensor:
    """This rank's blocks of the sharded leaves of ``state``, flattened in
    its order into one float32 CPU buffer (the same length on every rank of
    a tp line)."""
    names = _sharded_names(shardings, state)
    if not names:
        return torch.zeros(0)
    return torch.cat([state[k].detach().float().cpu().reshape(-1) for k in names])


def unpack_blocks(shardings: dict, state: dict, parts) -> dict:
    """The whole leaves from every rank's ``pack_blocks`` buffer (in tp
    order): each sharded leaf's blocks concatenated along axis 0, the
    replicated leaves of ``state`` as they are; CPU tensors."""
    out = {k: v.detach().cpu() for k, v in state.items()}
    offset = 0
    for k in _sharded_names(shardings, state):
        shape, n = tuple(state[k].shape), state[k].numel()
        out[k] = torch.cat([p[offset:offset + n].view(shape) for p in parts]).to(state[k].dtype)
        offset += n
    return out


def gather_params(shardings: dict, state: dict) -> Optional[dict]:
    """The whole tree of a tree of this rank's blocks (the leaves of
    ``shard_params``' parameters, or tensors shaped as them: the EMA,
    Adam's moments), on the first rank of each tp line as CPU tensors, None
    on the others; one gather of CPU tensors over the tp group.  Without a
    sharded leaf, ``state`` on the CPU."""
    mesh = next(iter(shardings.values())).mesh if shardings else None
    tp = None if mesh is None else mesh.tp
    if tp is None or not _sharded_names(shardings, state):
        return {k: v.detach().cpu() for k, v in state.items()}
    flat = pack_blocks(shardings, state)
    first = mesh.line("tp")[0]
    parts = [torch.empty_like(flat) for _ in range(tp.size)] if mesh.rank == first else None
    dist.gather(flat, parts, dst=first, group=tp.group)
    return unpack_blocks(shardings, state, parts) if parts is not None else None


def local_blocks(mesh: Mesh, state: dict) -> dict:
    """This rank's blocks of a tree of whole leaves, by ``param_shardings``
    (``state`` itself without a tp line)."""
    if mesh.tp is None:
        return state
    shardings = param_shardings(mesh, state)
    return {k: shardings[k].local(v) if shardings[k].spec else v for k, v in state.items()}


def gather_rows(mesh: Mesh, x: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's rows of a batch -> the whole batch (on the CPU) on the
    first rank of its dp line, None on the others; gathered over the dp
    group as CPU tensors (gloo gathers CPU tensors only)."""
    group = mesh.groups.get("dp")
    x = x.detach().cpu().contiguous()
    if group is None:
        return x
    first = int(mesh.devices[tuple(0 if a == "dp" else mesh.coords[a] for a in mesh.axis_names)])
    parts = [torch.empty_like(x) for _ in range(mesh.shape["dp"])] if mesh.rank == first \
        else None
    dist.gather(x, parts, dst=first, group=group)
    return torch.cat(parts) if parts is not None else None


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# the column-sharded convolutions' collectives over the tp group
# ---------------------------------------------------------------------------
def _channels_last(t: torch.Tensor) -> bool:
    """A 4-D tensor laid out channels_last (and not also contiguous)."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
        and not t.is_contiguous()


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _channels_last(g):           # summed in place through its NHWC view
            g = g.clone(memory_format=torch.channels_last)
            dist.all_reduce(g.permute(0, 2, 3, 1), group=ctx.tp.group)
        else:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.c = tp, x.shape[1]
        last = _channels_last(x)
        send = x.permute(0, 2, 3, 1) if last else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(tp.size)]
        dist.all_gather(parts, send, group=tp.group)
        if last:                        # NHWC pieces -> NCHW view of channels_last storage
            return torch.cat(parts, dim=-1).permute(0, 3, 1, 2)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        r, c = ctx.tp.rank, ctx.c
        fmt = torch.channels_last if _channels_last(g) else torch.contiguous_format
        return g[:, r * c:(r + 1) * c].contiguous(memory_format=fmt), None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The input of this rank's column of a sharded layer: the identity
    forward; backward, the input gradient summed over the tp group."""
    return _CopyToTp.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This rank's channels (axis 1) -> every rank's, in rank order (one
    all-gather over the tp group, the memory format kept); backward, this
    rank's slice of the gradient."""
    return _GatherFromTp.apply(x, tp)
