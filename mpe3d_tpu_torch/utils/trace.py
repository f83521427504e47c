"""Spans and counters of the port's host work, recorded while a
``torch.profiler`` session runs.

The batch path (``pipeline.py``: ``batch.submit`` and its stages), the
frame path's roots, the lifter trainer's epoch (``train/lifter.py``) and
the evaluation runners' timed sections (``eval/timing.py``) open their
regions here, and ``Lifter.forward`` counts the rows it lifts
(``lifter.rows``) and the run kernel's launches it makes
(``lifter.launches``).

* ``span(name, key=None)`` is a context manager.  While a profiler
  session is active it records ``(name, start_ns, end_ns, parent, key)``:
  both ends on ``time.perf_counter_ns()``, ``parent`` the index of the
  span that encloses it on the same thread (None at a root), ``key`` an
  identifier that one request's spans share (a batch's sequence number,
  an epoch's number).  The span is then also a ``record_function`` range,
  so it names its region in the profiler's trace (``infer
  --profile-trace``).  Otherwise it records nothing, at the cost of one
  flag read.
* ``count(name, n=1)`` adds ``n`` to a named counter, under the same
  condition.
* ``snapshot()`` returns what was recorded, without clearing it;
  ``clear()`` empties it.  At most ``CAP`` spans are kept; later ones
  count as dropped.

The condition is ``torch.autograd.profiler._is_profiler_enabled``: the
flag every ``torch.profiler`` session sets at its start and clears at its
end, whatever activities it traces (CPU, CUDA, or both), and the same on
every thread.  So the spans record exactly in a profiled stretch and cost
nothing to switch: there is no flag, option or environment variable of
their own.  The range is ``torch._C._profiler._RecordFunctionFast``, the
C++ form of ``torch.profiler.record_function`` (the Python form dispatches
an operator at each end)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 17
_RecordFunction = torch._C._profiler._RecordFunctionFast

_spans: List[list] = []          # [name, start_ns, end_ns, parent, key]
_counters: Dict[str, int] = {}
_dropped = 0
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]        # None while the span is still open
    parent: Optional[int]        # index of the enclosing span, or None
    key: object


class Snapshot(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]
    dropped: int


def recording() -> bool:
    """Whether spans and counters record now (a profiler session is
    active)."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _Close:
    """Ends the innermost open span of the calling thread."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        rec, rf = _local.stack.pop()
        rec[2] = _now()
        rf.__exit__(*exc)
        return False


_OFF, _CLOSE = _Off(), _Close()
_now = time.perf_counter_ns


def span(name: str, key=None):
    """A region of host work named ``name`` (module header), for a
    ``with`` statement; ``key`` ties the spans of one batch or epoch
    together.  While recording, the span opens here and closes when the
    ``with`` block ends."""
    global _dropped
    if not _profiler._is_profiler_enabled:
        return _OFF
    try:
        stack = _local.stack
    except AttributeError:
        stack = _local.stack = []
    rec = [name, 0, None, stack[-1][0] if stack else None, key]
    if len(_spans) < CAP:
        _spans.append(rec)
    else:
        with _lock:
            _dropped += 1
    rf = _RecordFunction(name)
    rf.__enter__()
    stack.append((rec, rf))
    rec[1] = _now()
    return _CLOSE


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def snapshot() -> Snapshot:
    """The spans recorded so far, in the order they opened (``parent`` an
    index into this list), the counters and the number of spans dropped;
    nothing is cleared."""
    recs = list(_spans)
    index = {id(r): i for i, r in enumerate(recs)}
    spans = [Span(r[0], r[1], r[2],
                  None if r[3] is None else index.get(id(r[3])), r[4])
             for r in recs]
    with _lock:
        return Snapshot(spans, dict(_counters), _dropped)


def clear() -> None:
    """Forget every span, counter and drop recorded so far."""
    global _dropped
    with _lock:
        del _spans[:]
        _counters.clear()
        _dropped = 0
