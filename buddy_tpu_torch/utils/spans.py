"""Spans at the port's layer boundaries, recorded only while turned on.

``span(name)`` is a context manager. Off, the default, it returns one shared
no-op context after a single flag test. On (``enable(True)``), each span
records its name, an id, the id of its parent span and the id of its group,
and its host start and end (``time.perf_counter_ns``). Where the process has
initialised CUDA, each span also records one timing event at its start and
one at its end on the current stream: its device extent, the interval in
which the stream ran the span's work, with any idle gaps inside it. Each
span also enters ``torch.profiler.record_function(name)``, so that a
profiler's trace shows it.

A root span (one opened with no span open) takes ``group`` where it is given
(the trainer passes its iteration), else the next number of the recorder's
own count of roots; every span inside it shares its group.

``enable(True)`` synchronises and records the reference event; ``take()``
synchronises, turns each span's events into device milliseconds from the
reference event (``d0_ms``, ``d1_ms``; None without CUDA), returns the
spans closed since the last ``take`` in the order they opened, and clears
them. Spans are recorded for the one thread that drives the device.

Counters are integer attributes incremented where the work happens, on or
off, as the kernel wrappers' ``.launches`` are (``NoiseSource.draws``).
"""

from __future__ import annotations

import contextlib
import itertools
import time

import torch

_on = False
_NULL = contextlib.nullcontext()
_ref = None             # the reference event, where CUDA is in use
_open: list = []        # the open spans, innermost last
_closed: list = []      # (record, start event, end event) of the closed spans
_ids = itertools.count(1)
_roots = itertools.count()


class _Span:
    __slots__ = ("rec", "e0", "e1", "fn")

    def __init__(self, name: str, group):
        parent = _open[-1].rec if _open else None
        if parent is not None:
            group = parent["group"]
        elif group is None:
            group = next(_roots)
        self.rec = {"name": name, "id": next(_ids), "parent": parent["id"] if parent else None,
                    "group": group, "t0_ns": 0, "t1_ns": 0, "d0_ms": None, "d1_ms": None}
        self.e0 = self.e1 = None
        self.fn = torch.profiler.record_function(name)

    def __enter__(self):
        _open.append(self)
        self.rec["t0_ns"] = time.perf_counter_ns()
        if _ref is not None:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        if _ref is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record()
        self.rec["t1_ns"] = time.perf_counter_ns()
        _open.remove(self)
        _closed.append((self.rec, self.e0, self.e1))
        return False


def span(name: str, group=None):
    """The span ``name`` around a block: a no-op while tracing is off."""
    if not _on:
        return _NULL
    return _Span(name, group)


def enable(on: bool = True) -> None:
    """Turn the recording on (clearing what was recorded and, where CUDA is
    in use, synchronising and recording the reference event) or off."""
    global _on, _ref
    if on and not _on:
        _closed.clear()
        _ref = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            _ref = torch.cuda.Event(enable_timing=True)
            _ref.record()
    _on = bool(on)


def take() -> list:
    """The spans closed since ``enable(True)`` or the last ``take``, in the
    order they opened, each a dict of ``name``, ``id``, ``parent``, ``group``,
    ``t0_ns``, ``t1_ns``, ``d0_ms``, ``d1_ms``; the record is then cleared."""
    if _ref is not None:
        torch.cuda.synchronize()
    out = []
    for rec, e0, e1 in _closed:
        if e0 is not None and _ref is not None:
            rec["d0_ms"], rec["d1_ms"] = _ref.elapsed_time(e0), _ref.elapsed_time(e1)
        out.append(rec)
    _closed.clear()
    return sorted(out, key=lambda r: r["id"])
