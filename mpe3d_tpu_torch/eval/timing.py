"""Timed sections of the evaluation runners: the reference's t_pp / t_3Dg /
t_3Di metrics (test/metrics_from_model.py:178-235, 296-300, 386-390).

Port of ``mpe3d_tpu/eval/timing.py``.  Each span opens a
``utils/trace.py`` span of the same name, so under a profiler it names
its region in the trace and lands in the port's span buffer.  A span is
wall-clock time on the host: it ends where its body returns, which in
the runners is after the host readback of the body's results.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

from mpe3d_tpu_torch.utils import trace


class TimingAccumulator:
    """Per-frame spans: total and normalised by the span's item count."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.per_person: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def span(self, name: str, n_items: int = 1):
        with trace.span(name):
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        if n_items > 0:
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.per_person[name] = (self.per_person.get(name, 0.0)
                                     + dt / n_items)
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / n * 1000.0 if n else float("nan")

    def mean_per_person_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return (self.per_person.get(name, 0.0) / n * 1000.0
                if n else float("nan"))

    def summary(self) -> Dict[str, float]:
        out = {}
        for name in self.totals:
            out[f"{name}_ms"] = self.mean_ms(name)
            out[f"{name}_per_person_ms"] = self.mean_per_person_ms(name)
        return out
