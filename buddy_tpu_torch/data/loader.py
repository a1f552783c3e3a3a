"""The training batch pipeline (``buddy_tpu/data/loader.py``).

``make_train_loader`` builds, for a ``VCTKTrain``, the native loader:
``NativeBatchLoader`` over the host library's ``csrc/loader.cpp``, whose
worker threads decode random training segments (``csrc/wavio.cpp``) into a
ring of batch slots with no interpreter lock on their path.  For one worker
and a seed its batches are bit for bit those of the JAX package's native
loader; with several, the workers race for files and slots and the order
is not deterministic.  A dataset that only iterates segments (no
``train_samples``) gets ``PythonBatchLoader``, which stacks them on a
thread.  ``DeviceLoader`` keeps one batch ahead on the device.

Under a mesh (``parallel/mesh.py``) every rank builds the same loader over
the same files and seed, as the JAX package's one host reads the global
batch; there is no per-rank split of the files.  The ranks' batches need
not agree (the native workers' order), so the trainer takes the first
rank's batch on every rank (one broadcast a step) and keeps its rows.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import weakref
from typing import Iterator

import numpy as np
import torch

from buddy_tpu_torch.data import audio_io
from buddy_tpu_torch.device import resolve_device


class NativeBatchLoader:
    """Batches of ``batch_size`` random segments of ``segment_length``
    samples from ``files`` (a file drawn per row, then a crop or wrap-pad),
    filled by ``n_workers`` threads into ``n_slots`` slots from ``seed``.
    ``close`` stops and joins the threads; it is safe to call twice, and it
    runs at interpreter exit for a loader still open."""

    def __init__(self, files, batch_size: int, segment_length: int,
                 n_slots: int = 4, n_workers: int = 2, seed: int = 0):
        if not files:
            raise ValueError("NativeBatchLoader needs at least one file")
        if min(batch_size, segment_length, n_slots, n_workers) < 1:
            raise ValueError(f"batch_size {batch_size}, segment_length {segment_length}, "
                             f"n_slots {n_slots} and n_workers {n_workers} must be >= 1")
        lib = audio_io.native_library()
        self._lib = lib
        self.batch_size = int(batch_size)
        self.segment_length = int(segment_length)
        paths = (ctypes.c_char_p * len(files))(*[os.fsencode(f) for f in files])
        self._handle = lib.loader_create(paths, len(files), self.batch_size,
                                         self.segment_length, int(n_slots), int(n_workers),
                                         int(seed) & 0xFFFFFFFFFFFFFFFF)
        self._close = weakref.finalize(self, lib.loader_destroy, self._handle)

    def next_batch(self) -> np.ndarray:
        """The next filled slot, copied out (float32, (batch, segment));
        StopIteration once the loader is closed."""
        if not self._close.alive:
            raise StopIteration
        data = ctypes.POINTER(ctypes.c_float)()
        slot = self._lib.loader_next(self._handle, ctypes.byref(data))
        if slot < 0:
            raise StopIteration
        batch = np.ctypeslib.as_array(data, shape=(self.batch_size, self.segment_length)).copy()
        self._lib.loader_release(self._handle, slot)
        return batch

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            try:
                batch = self.next_batch()
            except StopIteration:
                return
            yield batch

    def close(self) -> None:
        self._close()


class PythonBatchLoader:
    """Batches of ``batch_size`` segments drawn in order from ``iter(dataset)``
    on a daemon thread, at most ``prefetch`` of them waiting.  An error in
    the thread is raised by the next ``next_batch``."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _fill(self) -> None:
        try:
            it = iter(self.dataset)
            while not self._stop.is_set():
                batch = np.stack([next(it) for _ in range(self.batch_size)])
                self._put(batch.astype(np.float32))
        except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            self._put(e)

    def next_batch(self) -> np.ndarray:
        item = self._q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the batch loader's thread failed") from item
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the thread; it ends after the batch it is drawing."""
        self._stop.set()
        self._thread.join(timeout)


def make_train_loader(dataset, batch_size: int, num_workers: int = 2, prefetch: int = 4,
                      seed: int = 0):
    """The batch loader of a training set, as the JAX package builds it: for
    a ``VCTKTrain`` (its ``train_samples`` and ``segment_length``) the native
    loader with ``num_workers`` threads, ``prefetch`` slots and ``seed``;
    for a dataset that only iterates segments, the threaded loader."""
    if hasattr(dataset, "train_samples"):
        return NativeBatchLoader(dataset.train_samples, batch_size, dataset.segment_length,
                                 n_slots=prefetch, n_workers=num_workers, seed=seed)
    return PythonBatchLoader(dataset, batch_size, prefetch=prefetch)


class DeviceLoader:
    """Wraps a batch loader and keeps one batch ahead on ``device`` (the card
    unless asked otherwise), as a tensor.  On a card each batch goes through
    a pinned staging buffer and a non-blocking copy on a stream of its own;
    the consumer's stream waits on the copy's event.  With a ``sharding``
    (``parallel/mesh.py``'s ``Sharding``) only this rank's block of each
    batch goes to the device, as ``shard_batch`` cuts it."""

    def __init__(self, loader, device=None, sharding=None):
        self.loader = loader
        self.device = resolve_device(device)
        self.sharding = sharding
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._copied = torch.cuda.Event()
            self._staging = None
        self._advance()

    def _advance(self) -> None:
        try:
            self._next = self._prefetch()
        except StopIteration:           # the loader has no more batches
            self._next = None

    def _prefetch(self) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(self.loader.next_batch(), np.float32))
        if self.sharding is not None:
            host = self.sharding.local(host)
        if not self._cuda:
            return host.to(self.device)
        if self._staging is None or self._staging.shape != host.shape:
            self._staging = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
        self._copied.synchronize()          # the staging buffer's last copy has ended
        self._staging.copy_(host)
        with torch.cuda.stream(self._stream):
            batch = self._staging.to(self.device, non_blocking=True)
            self._copied.record(self._stream)
        return batch

    def next_batch(self) -> torch.Tensor:
        """The batch fetched ahead, ready on the caller's current stream;
        StopIteration once the loader has no more."""
        batch = self._next
        if batch is None:
            raise StopIteration
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(self._copied)
            batch.record_stream(consumer)
        self._advance()
        return batch

    def __next__(self) -> torch.Tensor:
        return self.next_batch()

    def __iter__(self):
        return self

    def close(self) -> None:
        self.loader.close()
