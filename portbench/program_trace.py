"""The program's own spans and counters in the traced stretch, placed on
the device trace's clock: what the readers of the pipeline's stages and
the trainer's epoch read.

The program (``mpe3d_tpu_torch/utils/trace.py``) records spans only while
a profiler runs, each end on ``time.perf_counter_ns()``, with the index of
its enclosing span and a key (a batch's or an epoch's number), and counts
named quantities (``lifter.rows``).  This module imports nothing of the
program: it reads that module where the program loaded it
(``sys.modules``), without clearing it, so a program that has none gives
nothing to read and every reader returns None.  Spans outside the
stretch (``Tracer.t0`` to ``t1``, the same clock) are left out.

Placing: the profiler reports its events in ``CLOCK_REALTIME``
nanoseconds and the program's spans are on ``perf_counter``
(``CLOCK_MONOTONIC``); ``offset`` is the difference of the two host
clocks, read in this process.  The profiler's host records (the runtime
calls that launch kernels and copies) sit on the host clock to within a
few microseconds of it, but its device timestamps, converted from the
card's clock, can be off by tens of microseconds to milliseconds, and
the error changes within a stretch.  So device time is never compared
with host time directly: each idle gap of the device is put on the host
clock through the host record of the call that ended it (``idle_gaps``).
(The offset of ``Tracer``'s marker is not used either: it rests on the
same device timestamps, its ``_sleep`` is the process's first, whose
launch loads the kernel, and the profiler often does not return it.)

Self time: a span's length less its children's.  Idle: each idle gap of
the stretch, placed on the host clock, is divided among the innermost
program spans the host was in during it (a gap that outlasts a span is
not given whole to the span at its midpoint), the rest to none.
"Innermost" follows the program's nesting on one thread (the benchmark
drives the program from one)."""

from __future__ import annotations

import bisect
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.trace import MARKER

MODULE = "mpe3d_tpu_torch.utils.trace"


@dataclass
class ProgramTrace:
    """The program's complete spans of the stretch, in the order they
    opened (seconds on the host clock), and its counters."""

    names: List[str]
    start: List[float]
    end: List[float]
    parent: List[Optional[int]]
    counters: Dict[str, int]
    offset: float              # the profiler's clock - perf_counter, s
    self_s: List[float] = field(default_factory=list)
    root: List[int] = field(default_factory=list)

    def ancestors(self, i: int):
        """``i`` and the spans that enclose it, innermost first."""
        while i is not None:
            yield i
            i = self.parent[i]


def clock_offset() -> float:
    """The device trace's clock (``CLOCK_REALTIME``) minus ``perf_counter``
    now, s."""
    return (time.clock_gettime_ns(time.CLOCK_REALTIME)
            - time.perf_counter_ns()) * 1e-9


def from_snapshot(snap, tracer) -> ProgramTrace:
    """The spans of ``snap`` (the program's ``trace.snapshot()``) that
    opened and closed inside the tracer's stretch, re-indexed."""
    t0, t1 = tracer.t0, tracer.t1
    keep: Dict[int, int] = {}
    names, start, end, parent = [], [], [], []
    for i, s in enumerate(snap.spans):
        if s.end_ns is None:
            continue
        a, b = s.start_ns * 1e-9, s.end_ns * 1e-9
        if t0 is None or t1 is None or a < t0 or b > t1:
            continue
        keep[i] = len(names)
        names.append(s.name)
        start.append(a)
        end.append(b)
        parent.append(keep.get(s.parent) if s.parent is not None else None)
    pt = ProgramTrace(names, start, end, parent, dict(snap.counters),
                      clock_offset())
    pt.self_s = [b - a for a, b in zip(start, end)]
    for i, p in enumerate(parent):
        if p is not None:
            pt.self_s[p] -= end[i] - start[i]
    for i, p in enumerate(parent):
        pt.root.append(i if p is None else pt.root[p])
    return pt


def read(ctx) -> Optional[ProgramTrace]:
    """The program's trace of this run's stretch (kept in ``ctx``), or
    None when the program records none."""
    if "program_trace" not in ctx:
        mod = sys.modules.get(MODULE)
        tracer = ctx.get("tracer")
        ctx["program_trace"] = (
            None if mod is None or tracer is None
            else from_snapshot(mod.snapshot(), tracer))
    return ctx["program_trace"]


def per_root_ms(ctx, root: str, names: Sequence[str]) -> Optional[float]:
    """Mean over the stretch's ``root`` spans of the self time (ms) of the
    spans named ``names`` under each (the root itself included if named)."""
    pt = read(ctx)
    if pt is None:
        return None
    roots = {i: 0.0 for i, n in enumerate(pt.names)
             if n == root and pt.parent[i] is None}
    if not roots:
        return None
    for i, n in enumerate(pt.names):
        if n in names and pt.root[i] in roots:
            roots[pt.root[i]] += pt.self_s[i]
    return 1e3 * sum(roots.values()) / len(roots)


def root_ms(ctx, root: str) -> Optional[float]:
    """Mean length (ms) of the stretch's ``root`` spans, their children's
    time included."""
    pt = read(ctx)
    if pt is None:
        return None
    t = [b - a for n, a, b, p in zip(pt.names, pt.start, pt.end, pt.parent)
         if n == root and p is None]
    return 1e3 * sum(t) / len(t) if t else None


def per_span_ms(ctx, name: str) -> Optional[float]:
    """Mean self time (ms) of the stretch's spans named ``name``."""
    pt = read(ctx)
    if pt is None:
        return None
    t = [s for n, s in zip(pt.names, pt.self_s) if n == name]
    return 1e3 * sum(t) / len(t) if t else None


def device_timeline(tracer, offset: float
                    ) -> List[Tuple[float, float, float]]:
    """The busy intervals of the stretch's device activity (the profiler's
    device events as ``Tracer`` keeps them, its marker left out), each
    (start, end) on the device clock and the host time at which the call
    that issued its first operation began: the profiler's host record of
    that call (matched by correlation id) less ``offset``; without one,
    the start less ``offset``."""
    host: Dict[int, float] = {}
    events, marker = [], False
    for ev in tracer.prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            if ev.correlation_id():
                host.setdefault(ev.correlation_id(), ev.start_ns() * 1e-9)
            continue
        if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
            continue
        if MARKER in ev.name() and not marker:
            marker = True
            continue
        a = ev.start_ns() * 1e-9
        events.append((a, a + ev.duration_ns() * 1e-9, ev.correlation_id()))
    events.sort()
    out: List[list] = []
    for a, b, c in events:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b, host.get(c, a) - offset])
    return [(a, b, h) for a, b, h in out]


def idle_gaps(tracer, offset: float) -> List[Tuple[float, float]]:
    """(start, end) on the host clock of each idle gap of the stretch:
    before the first busy interval, between two, after the last.  A gap
    between two ends where the call that issued the next interval's first
    operation began on the host (the device waited on that call; for an
    operation queued before the gap, on the call that issued it), and
    lasts as long as on the device."""
    tl = device_timeline(tracer, offset)
    if not tl:
        return []
    t0, t1 = tracer.t0, tracer.t1
    gaps = [(t0, tl[0][2])] if tl[0][2] > t0 else []
    for (_, b, _), (a2, _, h2) in zip(tl, tl[1:]):
        gaps.append((h2 - (a2 - b), h2))
    a, b, h = tl[-1]
    if t1 > h + (b - a):
        gaps.append((h + (b - a), t1))
    return gaps


def innermost_segments(pt: ProgramTrace
                       ) -> Tuple[List[float], List[Optional[int]]]:
    """The host clock cut where the innermost open program span changes:
    (start of each piece, its innermost span or None), in time order."""
    times: List[float] = []
    who: List[Optional[int]] = []
    stack: List[int] = []

    def close_until(t):
        while stack and pt.end[stack[-1]] <= t:
            j = stack.pop()
            times.append(pt.end[j])
            who.append(stack[-1] if stack else None)

    for i, a in enumerate(pt.start):
        close_until(a)
        stack.append(i)
        times.append(a)
        who.append(i)
    close_until(float("inf"))
    return times, who


def placed_idle(ctx) -> Optional[List[Tuple[float, Optional[int]]]]:
    """(seconds, innermost program span or None) of the stretch's idle
    time: each gap divided among the innermost spans the host was in
    during it (kept in ``ctx``); None without device activity."""
    if "placed_idle" not in ctx:
        pt, tracer = read(ctx), ctx.get("tracer")
        out = None
        if pt is not None and tracer.kernels:
            times, who = innermost_segments(pt)
            out = []
            for h0, h1 in idle_gaps(tracer, pt.offset):
                k = bisect.bisect_right(times, h0) - 1
                at = h0
                while at < h1:
                    upto = min(times[k + 1] if k + 1 < len(times) else h1,
                               h1)
                    if upto > at:
                        out.append((upto - at, who[k] if k >= 0 else None))
                        at = upto
                    k += 1
        ctx["placed_idle"] = out
    return ctx["placed_idle"]


def idle_in(ctx, names: Sequence[str]) -> Optional[float]:
    """Idle seconds of the stretch during which the host was in a span
    named ``names`` or in a span under one."""
    gaps, pt = placed_idle(ctx), read(ctx)
    if gaps is None:
        return None
    return sum(g for g, i in gaps if i is not None
               and any(pt.names[j] in names for j in pt.ancestors(i)))


def idle_unplaced_share(ctx) -> Optional[float]:
    """Share (%) of the stretch's idle time during which the host was in
    no program span."""
    gaps = placed_idle(ctx)
    total = sum(g for g, _ in gaps) if gaps is not None else 0.0
    if total <= 0.0:
        return None
    return 100.0 * sum(g for g, i in gaps if i is None) / total


def count(ctx, name: str) -> Optional[int]:
    """The program's counter ``name`` (it counts only while a profiler
    runs: in a benchmark run, the stretch)."""
    pt = read(ctx)
    if pt is None:
        return None
    return pt.counters.get(name)


def n_roots(ctx, root: str) -> int:
    pt = read(ctx)
    if pt is None:
        return 0
    return sum(1 for i, n in enumerate(pt.names)
               if n == root and pt.parent[i] is None)
