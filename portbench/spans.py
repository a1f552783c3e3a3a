"""The port's spans in a traced window, placed on the device trace's clock,
and what the span readers in ``metrics/`` take from them.

``traced_window`` is ``run.traced_window`` with the port's spans
(``buddy_tpu_torch/utils/spans.py``) turned on around it: the record gains
``spans``, the window's span record, and ``draws``, the change in
``NoiseSource.draws``. Where a record has no spans (a run of a program
without them, or one not traced so), every span reader returns None.

One clock. A span's device extent is in ms from the recorder's reference
event; the trace's events are in us on the profiler's clock, which the
profiler converts from the device's and which leads or trails the events'
clock by up to some ms, by an amount that drifts and jumps within a window.
So the offset is taken locally. Each ``noise.draw`` and ``train.get_batch``
span (an anchor) holds one blocking upload, its ``Memcpy HtoD``, and ends
right after it: each anchor is matched to one upload that fits its extent,
the upload's end meeting the span's end, along the one chain of matches in
order on both clocks that matches the most anchors with the least change
of offset from match to match (which tells a draw's upload from the tiny
upload after it). A span then takes the offset of the first matched anchor at or under
it (a step its draw's, a batch or train step its first draw's or batch's),
else its parent's. (The window's first device event need not lie in a
span: ``drivers/dps.py`` makes its observations before each batch.) The
alignment is checked, not assumed: at least ``MIN_INSIDE`` of the window's
device busy time lies inside the root spans' extents, and no two
``dps.denoise`` / ``dps.vjp`` extents overlap by more than
``MAX_OVERLAP_US``; where either fails, or no anchor matches, ``aligned``
returns None.

The idle-gap rule: a gap is an interval between the window's first and
last device events in which no event runs; it is put down to the
innermost span whose extent contains the start of the event that ends it
(the span whose work the device was waiting for), or to ``OUTSIDE`` where
no span does (the benchmark's own work between batches or steps).
"""

from __future__ import annotations

import importlib

HTOD = "Memcpy HtoD"
ANCHORS = ("noise.draw", "train.get_batch")
GUIDED = ("dps.denoise", "dps.vjp")
OUTSIDE = "outside"
MIN_INSIDE = 0.98
MAX_OVERLAP_US = 50.0
MATCH_US = 20000.0      # a match is worth this much change of offset
SKIP = 3                # anchors a chain may pass over between two matches


def traced_window(driver, seconds: float) -> tuple:
    """``run.traced_window`` with the port's spans on: returns (window,
    record), the record with ``spans`` and ``draws``."""
    from portbench import run
    spans = importlib.import_module("buddy_tpu_torch.utils.spans")
    noise = importlib.import_module("buddy_tpu_torch.sampling.euler_heun").NoiseSource
    before = noise.draws
    spans.enable(True)
    try:
        w, rec = run.traced_window(driver, seconds)
        rec["spans"] = spans.take()
    finally:
        spans.enable(False)
    rec["draws"] = noise.draws - before
    return w, rec


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(events) -> list:
    """The device's busy intervals: the union of the events' intervals."""
    return merged((start, start + dur) for _, start, dur in events)


def overlap_us(xs, ys) -> float:
    """The length of the intersection of two unions of disjoint sorted
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def anchor_offsets(events, spans) -> dict:
    """{id of an anchor span: the profiler's clock minus the span record's
    device clock there, in us}: each anchor matched to one upload that fits
    its extent, the upload's end meeting the span's end, along the one chain
    of matches (in order on both clocks) that matches the most anchors with
    the least change of offset from one match to the next."""
    ups = sorted((start, start + dur) for name, start, dur in events if name.startswith(HTOD))
    anchors = sorted((s for s in spans if s["name"] in ANCHORS and s["d0_ms"] is not None),
                     key=lambda s: s["d0_ms"])
    cands = []
    for s in anchors:
        a, b = s["d0_ms"] * 1e3, s["d1_ms"] * 1e3
        cands.append([(j, u1 - b) for j, (u0, u1) in enumerate(ups) if u1 - u0 <= b - a])
    chain: dict = {}        # (anchor, upload) -> (score, -first offset, offset, previous)
    top = None
    for i, row in enumerate(cands):
        for j, o in row:
            cur = (MATCH_US, -o, o, None)
            for i2 in range(max(0, i - 1 - SKIP), i):
                for j2, o2 in cands[i2]:
                    if j2 >= j:
                        break
                    prev = chain[(i2, j2)]
                    score = (prev[0] + MATCH_US - abs(o - o2), prev[1])
                    if score > cur[:2]:
                        cur = (*score, o, (i2, j2))
            chain[(i, j)] = cur
            if top is None or cur[:2] > chain[top][:2]:
                top = (i, j)
    out = {}
    while top is not None:
        out[anchors[top[0]]["id"]] = chain[top][2]
        top = chain[top][3]
    return out


def aligned(rec):
    """The record's spans with ``a_us`` and ``b_us``, their device extents on
    the profiler's clock, or None where the record has no spans, no device
    extents, or fails the alignment's checks. A span takes the offset of
    the first matched anchor at or under it, else its parent's, else that
    of the matched anchor nearest in time."""
    spans, events = rec.get("spans"), rec.get("events")
    if not spans or not events or spans[0]["d0_ms"] is None:
        return None
    found = anchor_offsets(events, spans)
    if not found:
        return None
    kids: dict = {}
    for s in sorted(spans, key=lambda s: s["d0_ms"]):
        kids.setdefault(s["parent"], []).append(s)
    below: dict = {}

    def down(s):
        if s["id"] not in below:
            below[s["id"]] = found.get(s["id"])
            for c in kids.get(s["id"], ()):
                if below[s["id"]] is not None:
                    break
                below[s["id"]] = down(c)
        return below[s["id"]]

    by_id = {s["id"]: s for s in spans}
    times = sorted((by_id[k]["d0_ms"], o) for k, o in found.items())
    out = []
    for s in spans:
        p, o = s, down(s)
        while o is None and p["parent"] is not None:
            p = by_id[p["parent"]]
            o = down(p)
        if o is None:
            o = min(times, key=lambda t: abs(t[0] - s["d0_ms"]))[1]
        out.append(dict(s, a_us=s["d0_ms"] * 1e3 + o, b_us=s["d1_ms"] * 1e3 + o))
    dev = busy(events)
    roots = merged((s["a_us"], s["b_us"]) for s in out if s["parent"] is None)
    if overlap_us(dev, roots) < MIN_INSIDE * sum(b - a for a, b in dev):
        return None
    end = float("-inf")
    for s in sorted((s for s in out if s["name"] in GUIDED), key=lambda s: s["a_us"]):
        if end - s["a_us"] > MAX_OVERLAP_US:
            return None
        end = max(end, s["b_us"])
    return out


def busy_ms_per_step(rec, name: str):
    """Device ms a step in the events inside the extents of the spans
    ``name``, or None."""
    spans = aligned(rec)
    if spans is None or not any(s["name"] == name for s in spans):
        return None
    inside = merged((s["a_us"], s["b_us"]) for s in spans if s["name"] == name)
    return overlap_us(busy(rec["events"]), inside) * 1e-3 / rec["steps"]


def idle_by_span(rec):
    """{span name or ``OUTSIDE``: idle s put down to it by the gap rule}, or
    None."""
    spans = aligned(rec)
    if spans is None:
        return None
    dev = busy(rec["events"])
    order = sorted(spans, key=lambda s: (s["a_us"], s["id"]))
    out: dict = {}
    stack, j = [], 0
    for (_, end), (t, _) in zip(dev, dev[1:]):
        while j < len(order) and order[j]["a_us"] <= t:
            while stack and stack[-1]["b_us"] < order[j]["a_us"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1]["b_us"] < t:
            stack.pop()
        name = stack[-1]["name"] if stack else OUTSIDE
        out[name] = out.get(name, 0.0) + (t - end) * 1e-6
    return out


def idle_share(rec, name: str):
    """Idle s put down to the spans ``name`` over the window's wall time, in
    %, or None."""
    idle = idle_by_span(rec)
    if idle is None:
        return None
    return 100.0 * idle.get(name, 0.0) / rec["window_s"]


def host_ms(spans, name: str) -> float:
    return sum(s["t1_ns"] - s["t0_ns"] for s in spans if s["name"] == name) * 1e-6


def host_ms_per_step(rec, name: str):
    """Host ms a step in the spans ``name``, or None."""
    spans = aligned(rec)
    if spans is None or not any(s["name"] == name for s in spans):
        return None
    return host_ms(spans, name) / rec["steps"]
