"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, read into device intervals by name, with the
benchmark's own host spans beside them.

The profiler traces the device's activity only (kernels, copies,
memsets): tracing every host operator as well slows the host path, which
is what paces the batch cells, by half.  Host spans are the benchmark's
own clock readings around its calls into the program (``span``), put on
the device's timeline by a marker kernel launched on the idle device at a
known host time when the stretch ends.  ``busy_s`` is the length of the
union of the device intervals, so overlapping streams count once; an
idle gap of the device is labelled by the host span that holds its
midpoint."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


class Tracer:
    """Profiles from ``start()`` to ``stop()`` (once), then holds what the
    metric readers read."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None
        self.kernels: List[Tuple[str, float, float]] = []   # name, start, end (s)
        self.host_spans: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []     # on the device clock
        self.window_s = 0.0
        self.busy_s = 0.0
        self.start_s = 0.0
        self._mark = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _acts(self):
        if self.device.type == "cuda":
            return [torch.profiler.ProfilerActivity.CUDA]
        return [torch.profiler.ProfilerActivity.CPU]

    def warm(self) -> None:
        """Start and stop a throwaway profiler once (set-up): the first
        start initialises the device tracing, which takes seconds."""
        with torch.profiler.profile(activities=self._acts()):
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        t = time.perf_counter()
        self.prof = torch.profiler.profile(activities=self._acts())
        self.prof.start()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        if self.device.type == "cuda":
            # the marker, launched on an idle device at a known host time
            torch.cuda.synchronize(self.device)
            self._mark = time.perf_counter()
            torch.cuda._sleep(100)
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.window_s = self.t1 - self.t0
        self._read()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the benchmark's clock, kept while tracing."""
        if not self.active:
            yield
            return
        a = time.perf_counter()
        try:
            yield
        finally:
            self.host_spans.append((name, a, time.perf_counter()))

    def _read(self) -> None:
        marker = None
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA or (
                    hasattr(ev, "is_user_annotation")
                    and ev.is_user_annotation()):
                continue
            name = ev.name()
            if hasattr(ev, "start_ns"):
                start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            else:
                start, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
            if MARKER in name and marker is None:
                marker = start
                continue
            self.kernels.append((name, start, start + dur))
        self.kernels.sort(key=lambda k: k[1])
        self.busy_s = sum(e - s for s, e in self.busy_intervals())
        if marker is not None and self._mark is not None:
            off = marker - self._mark
            self.spans = sorted(((n, a + off, b + off)
                                 for n, a, b in self.host_spans),
                                key=lambda t: t[1])

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, s, e in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def device_seconds(self, patterns) -> float:
        """Summed device time of the kernels whose name holds any of
        ``patterns``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in patterns))

    def n_kernels(self) -> int:
        """CUDA kernels launched (copies and memsets left out)."""
        return sum(1 for n, _, _ in self.kernels
                   if not n.startswith(("Memcpy", "Memset", "cudaMemcpy")))

    def breakdown(self) -> Dict[str, list]:
        """The 10 device operations that took most time, and the idle time
        of the device by the host span it fell in."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n[:200]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        starts = [a for _, a, _ in self.spans]
        idle: Dict[str, float] = defaultdict(float)
        for (_, s), (e, _) in zip(busy[:-1], busy[1:]):
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid) - 1
            label = (self.spans[i][0] if i >= 0 and self.spans[i][2] >= mid
                     else "other")
            idle[label] += e - s
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def maybe(tracer: Optional[Tracer], name: str):
    return tracer.span(name) if tracer is not None else contextlib.nullcontext()
