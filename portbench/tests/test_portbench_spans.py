"""The span readers (``portbench/spans.py`` and its readers in ``metrics/``)
on hand-made records of device events and spans: the clock alignment, the
gap rule, the alignment's two checks and the draw count; the traced window
with the port's spans on at nf=8 on the CPU; and, on the card, a traced
batch of ``informed_full_b32`` and a traced step of ``train_b16`` in which
every span reader reads a number."""

from __future__ import annotations

import pytest

from portbench import registry, run, spans

DELTA = 123456.0        # the profiler's clock minus the span record's device clock, us
SERVE = ["denoiser_ms_per_step", "vjp_ms_per_step", "enqueue_ms_per_step", "draw_ms_per_step",
         "draw_idle_share"]
TRAIN = ["draw_ms_per_step", "draw_idle_share", "get_batch_ms_per_step", "get_batch_idle_share"]


def _span(sid, name, parent, d0, d1, host_us=0.0, group=0):
    """A span with its device extent [d0, d1] in us on the span record's
    clock and ``host_us`` of host time."""
    return {"name": name, "id": sid, "parent": parent, "group": group, "t0_ns": 0,
            "t1_ns": int(host_us * 1e3), "d0_ms": d0 * 1e-3, "d1_ms": d1 * 1e-3}


def _ev(name, a, b, shift=0.0):
    return (name, a + shift + DELTA, b - a)


def _serving(window_s=0.05):
    """Two batches of one step each. Each: the observation's kernel before
    the batch, outside every span; a kernel of the batch's own; the initial
    draw and the step's churn draw, each ending with its upload (the span's
    end event at the upload's end); the denoiser's kernel; two vjp kernels
    with a gap between them; the recorder's clone after the step."""
    events, sp = [], []
    for k, shift in enumerate((0.0, 21000.0)):
        base = 6 * k
        events += [_ev("observations_kernel", -500, -460, shift),
                   _ev("prep_kernel", 50, 90, shift),
                   _ev("Memcpy HtoD (Pageable -> Device)", 1320, 1500, shift),
                   _ev("Memcpy HtoD (Pageable -> Device)", 2730, 3000, shift),
                   _ev("conv_kernel", 3010, 8990, shift),
                   _ev("dgrad_kernel", 9000, 13000, shift),
                   _ev("gn_bwd_kernel", 13200, 18890, shift),
                   _ev("Memcpy DtoD (Device -> Device)", 19100, 19200, shift)]
        s = lambda a, b: (a + shift, b + shift)
        sp += [_span(base + 1, "dps.batch", None, *s(0, 20000), 20000, group=k),
               _span(base + 2, "noise.draw", base + 1, *s(100, 1500), 5000, group=k),
               _span(base + 3, "dps.step", base + 1, *s(1500, 19000), 10000, group=k),
               _span(base + 4, "noise.draw", base + 3, *s(1500, 3000), 5000, group=k),
               _span(base + 5, "dps.denoise", base + 3, *s(3000, 9000), 2000, group=k),
               _span(base + 6, "dps.vjp", base + 3, *s(9000, 18900), 2000, group=k)]
    events.sort(key=lambda e: e[1])
    return {"events": events, "spans": sp, "draws": 4, "steps": 2, "window_s": window_s}


def _training(window_s=0.03):
    """Two train steps: the batch's upload, the noise levels' draw and the
    prior draw, each ending with its upload, then the step's kernels."""
    events, sp = [], []
    for k, shift in enumerate((0.0, 10000.0)):
        base = 4 * k
        events += [_ev("Memcpy HtoD (Pageable -> Device)", 400, 600, shift),
                   _ev("Memcpy HtoD (Pageable -> Device)", 690, 700, shift),
                   _ev("Memcpy HtoD (Pageable -> Device)", 5500, 5800, shift),
                   _ev("fprop_kernel", 5810, 9990, shift)]
        s = lambda a, b: (a + shift, b + shift)
        sp += [_span(base + 1, "train.step", None, *s(0, 9995), 9000, group=k),
               _span(base + 2, "train.get_batch", base + 1, *s(0, 600), 700, group=k),
               _span(base + 3, "noise.draw", base + 1, *s(620, 700), 100, group=k),
               _span(base + 4, "noise.draw", base + 1, *s(700, 5800), 5000, group=k)]
    events.sort(key=lambda e: e[1])
    return {"events": events, "spans": sp, "draws": 4, "steps": 2, "window_s": window_s}


def _read(rec, names):
    return {m: registry.load_metric(m).read(rec) for m in names}


def test_each_anchor_meets_its_upload():
    rec = _serving()
    draws = [s for s in rec["spans"] if s["name"] == "noise.draw"]
    assert spans.anchor_offsets(rec["events"], rec["spans"]) == \
        pytest.approx({s["id"]: DELTA for s in draws})
    # end events that trail their uploads by 20 and 30 us: each its own
    for s, lag in zip(draws, (20, 30, 20, 30)):
        s["d1_ms"] += lag * 1e-3
    assert spans.anchor_offsets(rec["events"], rec["spans"]) == \
        pytest.approx({s["id"]: DELTA - lag for s, lag in zip(draws, (20, 30, 20, 30))})
    # the noise levels' tiny upload, 90 us after the batch's: each upload
    # goes to its own span
    tr = _training()
    assert set(spans.anchor_offsets(tr["events"], tr["spans"]).values()) == {DELTA}


def test_a_tiny_upload_after_each_draw_is_not_its_upload():
    """The denoiser's scalar upload, 100 us after each churn draw's (under
    the U-Net's first kernel): the draw keeps its own, and nothing moves."""
    rec = _serving()
    rec["events"] = sorted(rec["events"] + [_ev("Memcpy HtoD (Pageable -> Device)", 3100, 3101, k)
                                            for k in (0.0, 21000.0)], key=lambda e: e[1])
    draws = [s for s in rec["spans"] if s["name"] == "noise.draw"]
    assert spans.anchor_offsets(rec["events"], rec["spans"]) == \
        pytest.approx({s["id"]: DELTA for s in draws})
    assert spans.idle_by_span(rec) == pytest.approx(spans.idle_by_span(_serving()))


def test_the_profilers_clock_jumps_between_steps():
    """The profiler's stamps of the second train step 2 ms later against the
    span record's clock: that step's spans take the offset of its own
    uploads, and its gaps go where they went."""
    rec = _training()
    rec["events"] = sorted((n, t + 2000.0 if t - DELTA >= 10000 else t, d)
                           for n, t, d in rec["events"])
    offsets = spans.anchor_offsets(rec["events"], rec["spans"])
    assert sorted(set(offsets.values())) == pytest.approx([DELTA, DELTA + 2000])
    idle = spans.idle_by_span(rec)
    # the gap before the second batch's upload is 2 ms longer on the
    # profiler's clock, and still the batch's
    assert idle == pytest.approx({"noise.draw": 2 * (90 + 4800) * 1e-6, "train.step": 20e-6,
                                  "train.get_batch": 2410e-6})


def test_gap_rule_serving():
    rec = _serving()
    idle = spans.idle_by_span(rec)
    # before each upload: the draw; between batches: outside; the first
    # kernel of a batch and the clone after its step: the batch
    assert idle == pytest.approx({"noise.draw": 4 * 1230e-6, "dps.batch": (510 + 210) * 2e-6,
                                  spans.OUTSIDE: 1300e-6, "dps.denoise": 20e-6,
                                  "dps.vjp": 420e-6})
    got = _read(rec, SERVE)
    assert got == pytest.approx({
        "denoiser_ms_per_step": 5.98, "vjp_ms_per_step": (4000 + 5690) * 1e-3,
        "enqueue_ms_per_step": (10.0 - 5.0), "draw_ms_per_step": 4 * 5.0 / 2,
        "draw_idle_share": 100 * 4 * 1230e-6 / 0.05})


def test_gap_rule_training():
    rec = _training()
    idle = spans.idle_by_span(rec)
    assert idle == pytest.approx({"noise.draw": 2 * (90 + 4800) * 1e-6, "train.step": 20e-6,
                                  "train.get_batch": 410e-6})
    got = _read(rec, TRAIN)
    assert got == pytest.approx({
        "draw_ms_per_step": 5.1, "draw_idle_share": 100 * 2 * 4890e-6 / 0.03,
        "get_batch_ms_per_step": 0.7, "get_batch_idle_share": 100 * 410e-6 / 0.03})


def test_busy_outside_the_roots_silences_every_reader():
    rec = _serving()
    assert all(v is not None for v in _read(rec, SERVE).values())
    # 2.75% of the busy time outside the batches: past the 2% the alignment allows
    rec["events"] = sorted(rec["events"] + [_ev("stray_kernel", -2000, -1160)],
                           key=lambda e: e[1])
    assert spans.aligned(rec) is None
    assert _read(rec, SERVE) == {m: None for m in SERVE}


def test_overlapping_denoise_and_vjp_silence_every_reader():
    rec = _serving()
    vjp = next(s for s in rec["spans"] if s["name"] == "dps.vjp")
    vjp["d0_ms"] -= 0.040                  # 40 us of overlap: still read
    assert _read(rec, SERVE)["denoiser_ms_per_step"] is not None
    vjp["d0_ms"] -= 0.020                  # 60 us
    assert spans.aligned(rec) is None
    assert _read(rec, SERVE) == {m: None for m in SERVE}


def test_draw_count_must_equal_the_counter():
    rec = _serving()
    rec["draws"] = 3
    got = _read(rec, SERVE)
    assert got["draw_ms_per_step"] is None
    assert got["denoiser_ms_per_step"] is not None
    del rec["draws"]
    assert _read(rec, SERVE)["draw_ms_per_step"] is None


def test_record_without_spans_reads_nothing():
    """A traced run of a program without spans (or not traced with them):
    every span reader returns None and none raises."""
    for rec in (_serving(), _training()):
        del rec["spans"], rec["draws"]
        assert _read(rec, SERVE + TRAIN) == {m: None for m in SERVE + TRAIN}
    rec = _training()
    rec["events"] = []
    assert _read(rec, TRAIN) == {m: None for m in TRAIN}


@pytest.mark.parametrize("cell", ["informed_full_b32", "train_b16"])
def test_traced_window_records_the_spans(small_cpu, cell):
    """The traced window with the port's spans on, at nf=8 on the CPU: the
    record holds the window's spans and draws (no device extents on the
    CPU, so the readers read nothing), and tracing is off again after."""
    from buddy_tpu_torch.utils import spans as port_spans
    spec = registry.load_cell(cell, small_cpu)
    config = registry.load_config(spec["config"], small_cpu)
    d = registry.load_driver(spec["driver"]).Driver(spec, config, 2 ** 31 + 21, "cpu")
    d.setup()
    w, rec = spans.traced_window(d, 0.0)
    names = [s["name"] for s in rec["spans"]]
    assert rec["draws"] == names.count("noise.draw") > 0
    roots = [s for s in rec["spans"] if s["parent"] is None]
    assert len(roots) == (w["batches"] if "batches" in w else w["steps"])
    assert all(s["d0_ms"] is None for s in rec["spans"])
    assert port_spans.span("x") is port_spans.span("y")
    assert _read(rec, SERVE + TRAIN) == {m: None for m in SERVE + TRAIN}


@pytest.mark.card
@pytest.mark.parametrize("cell, names", [("informed_full_b32", SERVE), ("train_b16", TRAIN)])
def test_span_readers_read_on_the_card(card, cell, names):
    """A traced batch or train step at the cell's own size with the port's
    spans on: the alignment holds and every span reader reads a number."""
    import torch
    run.fixed_caches()
    spec = registry.load_cell(cell)
    d = registry.load_driver(spec["driver"]).Driver(spec, registry.load_config(spec["config"]),
                                                    2 ** 31 + 103, "cuda")
    d.setup()
    torch.cuda.synchronize()
    try:
        _, rec = spans.traced_window(d, 0.0)
        got = _read(rec, names)
    finally:
        d.free_program()
    assert all(v is not None for v in got.values()), got
