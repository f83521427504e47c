"""The reader of ``graph_replay_share.batch`` on a fake stretch: the
program's ``batch.replay`` counter over the stretch's closed
``batch.submit`` spans, 100 % when every batch replays, the share when
some do not, and None when the program records no such counter (a
program without batch graphs)."""

import pytest

from portbench.cell import reader
from portbench.tests.test_portbench_program_trace import (FakeTracer,
                                                          _program, _span)


def _ctx(monkeypatch, counters, n=4):
    spans = [_span("batch.submit", 99.9, 99.95, None, 0)]   # before it
    for k in range(n):
        at = 100.0 + 0.02 * k
        spans.append(_span("batch.submit", at, at + 0.015, None, k + 1))
    spans.append(_span("batch.submit", 100.099, None, None, n + 1))  # open
    _program(monkeypatch, spans, counters)
    return {"kind": "batch", "tracer": FakeTracer([(100.0, 100.1)])}


def test_every_batch_replays(monkeypatch):
    ctx = _ctx(monkeypatch, {"batch.replay": 4, "lifter.rows": 160})
    assert reader("graph_replay_share.batch")(ctx) == pytest.approx(100.0)


def test_some_batches_replay(monkeypatch):
    ctx = _ctx(monkeypatch, {"batch.replay": 3, "batch.capture": 1})
    assert reader("graph_replay_share.batch")(ctx) == pytest.approx(75.0)


def test_nothing_to_read_without_the_counter(monkeypatch):
    ctx = _ctx(monkeypatch, {"lifter.rows": 160})
    assert reader("graph_replay_share.batch")(ctx) is None
    ctx = _ctx(monkeypatch, {"batch.replay": 1}, n=0)
    assert reader("graph_replay_share.batch")(ctx) is None
