"""The training batch pipeline (``buddy_tpu/data/loader.py``).

``PythonBatchLoader`` stacks a dataset's segments into float32 batches of
shape (batch, segment) on a thread of its own, a few batches ahead of the
trainer, which moves each batch to the device.  The JAX package's native
loader (``runtime/loader.cpp``, ``NativeBatchLoader``) and its
``DeviceLoader`` (``jax.device_put`` one batch ahead) have no counterpart
here (ROADMAP.md): ``make_train_loader`` always builds the threaded loader,
which is the JAX package's own fallback.

Under a mesh (``parallel/mesh.py``) every rank builds the same loader over
the same files and seed, as the JAX package's one host reads the global
batch; there is no per-rank split of the files.  The ranks' batches need
not agree (the crops come from numpy's global generator, which a test set
built while the thread draws reseeds), so the trainer takes the first
rank's batch on every rank (one broadcast a step) and keeps its rows.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


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


def make_train_loader(dataset, batch_size: int, prefetch: int = 4) -> PythonBatchLoader:
    """The batch loader of a ``VCTKTrain``: the threaded loader, which draws
    from the dataset's own generators (the JAX package's ``num_workers`` and
    ``seed`` configure its native loader, which is not ported)."""
    return PythonBatchLoader(dataset, batch_size, prefetch=prefetch)
