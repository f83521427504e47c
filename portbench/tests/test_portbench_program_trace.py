"""The readers of the program's own spans and counters
(``program_trace.py`` and its metrics) on a fake stretch with known
answers, its device timestamps 3 ms off the host clock (idle gaps are
placed through the host records of their launches, so the answers hold),
and in a ``--cpu --trace 1`` rehearsal of a batch cell, the live cell and
the training cell."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import program_trace
from portbench.cell import ROOT, load, reader
from portbench.run import run_cell, tiny
from portbench.tests.queued import load_any

ENV = dict(os.environ, PYTHONPATH=ROOT)
OFFSET = 5.0                  # device clock - host clock in the fake, s
BATCH_METRICS = ("pack_ms.batch", "epilogue_ms.batch", "idle_unplaced.batch",
                 "lifter_rows_used.batch")
FRAME_METRICS = ("frame_submit_ms.live", "frame_collect_ms.live",
                 "frame_pack_ms.live", "frame_issue_ms.live",
                 "frame_download_ms.live")
TRAIN_METRICS = ("grad_ms.train", "update_ms.train",
                 "epoch_tail_idle_ms.train")


DEVICE_ERROR = 3e-3           # the profiler's device timestamps off by 3 ms


class FakeEvent:
    def __init__(self, device, name, start_s, dur_s, corr):
        self.dev, self._name, self.corr = device, name, corr
        self.start, self.dur = round(start_s * 1e9), round(dur_s * 1e9)

    def device_type(self):
        return self.dev

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def is_user_annotation(self):
        return False


class FakeTracer:
    """What the readers read of ``portbench.trace.Tracer``: the stretch
    on the host clock and the profiler's events.  Each busy interval
    (given on the host clock) is one kernel, launched by a host call at
    its start; the profiler puts host calls at host time + OFFSET and
    kernels at host time + OFFSET + DEVICE_ERROR."""

    def __init__(self, busy_host, t0=100.0, t1=100.1):
        self.t0, self.t1 = t0, t1
        cuda, cpu = (torch.autograd.DeviceType.CUDA,
                     torch.autograd.DeviceType.CPU)
        events = []
        for i, (a, b) in enumerate(busy_host):
            events.append(FakeEvent(cpu, "cudaLaunchKernel", a + OFFSET,
                                    2e-6, i + 1))
            events.append(FakeEvent(cuda, "k", a + OFFSET + DEVICE_ERROR,
                                    b - a, i + 1))
        self.kernels = [("k", e.start, e.start + e.dur) for e in events
                        if e.dev == cuda]
        self.prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))


def _span(name, a, b, parent=None, key=None):
    """A program span with its ends given in host seconds."""
    return SimpleNamespace(name=name, start_ns=round(a * 1e9),
                           end_ns=None if b is None else round(b * 1e9),
                           parent=parent, key=key)


def _program(monkeypatch, spans, counters=None):
    snap = SimpleNamespace(spans=spans, counters=counters or {}, dropped=0)
    monkeypatch.setitem(sys.modules, program_trace.MODULE,
                        SimpleNamespace(snapshot=lambda: snap))
    monkeypatch.setattr(program_trace, "clock_offset", lambda: OFFSET)


def _batch(i0, at, pack_ms, key):
    """A batch's spans from ``at`` (host s) at index ``i0``: submit 20 ms;
    pack, features 3, gat 1, decode 0.5, lifter 0.5, quality 1, download
    2 ms, back to back from 1 ms in."""
    spans = [_span("batch.submit", at, at + 0.020, None, key)]
    t = at + 0.001
    for name, ms in (("batch.pack", pack_ms), ("chunk.features", 3.0),
                     ("chunk.gat", 1.0), ("chunk.decode", 0.5),
                     ("chunk.lifter", 0.5), ("chunk.quality", 1.0),
                     ("batch.download", 2.0)):
        spans.append(_span(name, t, t + ms * 1e-3, i0))
        t += ms * 1e-3
    return spans


def _batch_ctx(monkeypatch, busy=True):
    spans = _batch(0, 99.90, 9.0, 7)               # before the stretch
    spans += _batch(len(spans), 100.010, 2.0, 8)
    spans.append(_span("batch.collect", 100.031, 100.0315, None, 8))
    spans += _batch(len(spans), 100.040, 4.0, 9)
    spans.append(_span("batch.submit", 100.095, None, None, 10))  # open
    _program(monkeypatch, spans, {"lifter.rows": 40})
    # idle gaps (host clock): 1.5 ms from the first batch's pack on, 4 ms
    # between its collect and the next submit (in no program span)
    tracer = FakeTracer([(100.0, 100.012), (100.0135, 100.032),
                         (100.036, 100.1)] if busy else [])
    return {"kind": "batch", "tracer": tracer,
            "persons": np.array([3.0, 5.0])}


def test_clock_offset_is_realtime_minus_perf_counter():
    a = time.time() - time.perf_counter()
    b = program_trace.clock_offset()
    c = time.time() - time.perf_counter()
    assert min(a, c) - 1e-3 <= b <= max(a, c) + 1e-3


def test_batch_readers_known_values(monkeypatch):
    ctx = _batch_ctx(monkeypatch)
    got = {m: reader(m)(ctx) for m in BATCH_METRICS}
    assert got["pack_ms.batch"] == pytest.approx(3.0)       # (2 + 4) / 2
    assert got["epilogue_ms.batch"] == pytest.approx(3.0)
    assert got["idle_unplaced.batch"] == pytest.approx(100.0 * 4.0 / 5.5)
    assert got["lifter_rows_used.batch"] == pytest.approx(20.0)
    pt = program_trace.read(ctx)
    assert pt.offset == pytest.approx(OFFSET)
    assert pt.names.count("batch.submit") == 2     # the stretch's, closed
    gaps = program_trace.placed_idle(ctx)
    # the 1.5 ms gap outlasts the pack by 0.5 ms: that part is the
    # features'
    assert [(round(g * 1e3, 6), None if i is None else pt.names[i])
            for g, i in gaps] == [(1.0, "batch.pack"),
                                  (0.5, "chunk.features"), (4.0, None)]


def test_idle_readers_need_device_activity(monkeypatch):
    ctx = _batch_ctx(monkeypatch, busy=False)
    assert reader("idle_unplaced.batch")(ctx) is None
    assert reader("pack_ms.batch")(ctx) == pytest.approx(3.0)


def test_nothing_to_read_without_the_programs_trace(monkeypatch):
    monkeypatch.delitem(sys.modules, program_trace.MODULE, raising=False)
    ctx = {"kind": "batch", "tracer": FakeTracer([(100.0, 100.1)]),
           "persons": np.array([1.0])}
    for m in BATCH_METRICS + FRAME_METRICS:
        assert reader(m)(dict(ctx)) is None, m
    for m in TRAIN_METRICS:
        assert reader(m)({"kind": "train_lifter",
                          "tracer": ctx["tracer"]}) is None, m


def test_frame_readers_known_values(monkeypatch):
    """Whole ``frame.submit`` / ``frame.collect`` spans, children
    included, and the submit's parts, of the stretch's frames; none of
    the batch path's."""
    spans = [_span("frame.submit", 99.99, 99.995, None, 1)]  # before it
    for k, at, sub_ms, gat_ms, col_ms in ((2, 100.01, 4.0, 1.0, 1.0),
                                          (3, 100.03, 6.0, 2.0, 3.0)):
        i = len(spans)
        spans.append(_span("frame.submit", at, at + sub_ms * 1e-3, None, k))
        spans.append(_span("frame.pack", at, at + 1e-3, i))
        spans.append(_span("chunk.features", at + 1e-3, at + 1.5e-3, i))
        spans.append(_span("chunk.gat", at + 1.5e-3,
                           at + (1.5 + gat_ms) * 1e-3, i))
        spans.append(_span("frame.download", at + 3.5e-3, at + 4e-3, i))
        at += sub_ms * 1e-3
        spans.append(_span("frame.collect", at, at + col_ms * 1e-3, None, k))
    _program(monkeypatch, spans)
    ctx = {"kind": "batch", "tracer": FakeTracer([(100.0, 100.1)])}
    assert reader("frame_submit_ms.live")(ctx) == pytest.approx(5.0)
    assert reader("frame_collect_ms.live")(ctx) == pytest.approx(2.0)
    assert reader("frame_pack_ms.live")(ctx) == pytest.approx(1.0)
    assert reader("frame_issue_ms.live")(ctx) == pytest.approx(2.0)
    assert reader("frame_download_ms.live")(ctx) == pytest.approx(0.5)
    assert reader("pack_ms.batch")(ctx) is None


def test_train_readers_known_values(monkeypatch):
    spans = [_span("train.epoch", 100.0, 100.05, None, 4)]
    for name, a, b in (("train.grad", 100.001, 100.003),
                       ("train.update", 100.003, 100.004),
                       ("train.grad", 100.004, 100.008),
                       ("train.update", 100.008, 100.011),
                       ("train.readback", 100.011, 100.020),
                       ("train.eval", 100.020, 100.030),
                       ("train.select", 100.030, 100.040)):
        spans.append(_span(name, a, b, 0))
    spans.append(_span("train.epoch", 100.05, 100.099, None, 5))
    for name, a, b in (("train.grad", 100.051, 100.054),
                       ("train.update", 100.054, 100.056),
                       ("train.readback", 100.056, 100.09)):
        spans.append(_span(name, a, b, 8))
    _program(monkeypatch, spans)
    # idle gaps (host): 0.5 ms in a grad, 4 in the readback, 2 in the
    # eval, 1 in the select; 3 in epoch 5's readback
    busy = [(100.0, 100.002), (100.0025, 100.015), (100.019, 100.025),
            (100.027, 100.035), (100.036, 100.06), (100.063, 100.1)]
    tracer = FakeTracer(busy)
    ctx = {"kind": "train_lifter", "tracer": tracer, "steps": 3}
    assert reader("grad_ms.train")(ctx) == pytest.approx(3.0)
    assert reader("update_ms.train")(ctx) == pytest.approx(2.0)
    assert reader("epoch_tail_idle_ms.train")(ctx) == pytest.approx(5.0)


def _rehearse(workload):
    # 4 s: the stretch (a quarter in, half the window at most) holds whole
    # submits even on a loaded CPU, where one takes a good part of a second
    p = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload,
         "--seed", "4294967311", "--seconds", "4", "--trace", "1", "--cpu"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_cpu_rehearsal_reports_the_host_split(monkeypatch):
    # in this process, so that the chunk stages' spans (which no reader
    # reads since a replayed batch records none) can be summed here
    from mpe3d_tpu_torch.utils import trace as spans
    spans.clear()
    cell = tiny(load("panoptic.batch_s4"))
    kept, context = {}, cell.loop.layer_context
    monkeypatch.setattr(cell.loop, "layer_context",
                        lambda st, m, tr: kept.update(context(st, m, tr))
                        or kept)
    out = run_cell(cell, 4294967311, 4.0, True, "cpu", time.time())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    parts = [m["pack_ms.batch"], m["epilogue_ms.batch"],
             program_trace.per_root_ms(kept, "batch.submit", (
                 "chunk.features", "chunk.gat", "chunk.decode",
                 "chunk.lifter"))]
    assert all(v > 0 for v in parts)
    # the program's spans lie inside the benchmark's clock around submit
    assert 0.5 * m["submit_ms.batch"] < sum(parts) <= m["submit_ms.batch"]
    assert 0 < m["lifter_rows_used.batch"] <= 100
    assert "idle_unplaced.batch" not in m      # no device on the CPU
    spans.clear()
    out = run_cell(tiny(load_any("panoptic.stream_live")), 4294967311, 4.0,
                   True, "cpu", time.time())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"]
    assert 0 < m["frame_collect_ms.live"] < m["frame_submit_ms.live"]
    parts = [m[k] for k in ("frame_pack_ms.live", "frame_issue_ms.live",
                            "frame_download_ms.live")]
    assert all(v > 0 for v in parts)
    assert 0.5 * m["frame_submit_ms.live"] < sum(parts) \
        <= m["frame_submit_ms.live"]
    assert "submit_ms.batch" not in m and "pack_ms.batch" not in m
    out = _rehearse("panoptic.train_lifter")
    assert out["correct"]
    assert out["metrics"]["grad_ms.train"]["value"] > 0
    assert out["metrics"]["update_ms.train"]["value"] > 0
    assert "epoch_tail_idle_ms.train" not in out["metrics"]
