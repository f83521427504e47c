"""Structured logging, the numerics guard and the profiler trace.

Port of ``mpe3d_tpu/utils/logging.py``:

* ``JsonlLogger`` (:19-55): an append-only JSONL event log (one JSON
  record an event, with the seconds since the logger started and the run's
  fields) that also prints a readable line; calling it with a string logs
  a ``log`` event, so it stands in for the trainers' ``log=print``.
* ``enable_nan_debugging`` (:63-69): where ``jax_debug_nans`` makes a jit
  program raise on a NaN, ``torch.autograd.set_detect_anomaly(True)``
  makes a backward pass raise on one, naming the forward operation that
  made it.
* ``profiler_trace`` (:70-80), the trace of ``infer --profile-trace DIR``:
  ``torch.profiler`` records the block's host calls and, on a CUDA device,
  its kernels (CUPTI), and writes one Chrome trace (``chrome://tracing``,
  Perfetto) into DIR.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Optional

import torch


class JsonlLogger:
    """Append-only JSONL event log with stdout mirroring.

    >>> log = JsonlLogger("runs/lifter.jsonl", run="lifter-v1")
    >>> log.event("train_step", epoch=3, loss=0.5)
    """

    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 **run_fields: Any):
        self.path, self.echo, self.run_fields = path, echo, run_fields
        self._t0 = time.time()
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "kind": kind,
               **self.run_fields, **fields}
        if self._f:
            self._f.write(json.dumps(rec, default=float) + "\n")
        if self.echo:
            body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            print(f"[{kind}] {body}", file=sys.stdout)

    def __call__(self, message: str) -> None:
        """Stands in for the trainers' ``log=print``."""
        self.event("log", message=message)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def enable_nan_debugging() -> None:
    """Make a backward pass that meets a NaN raise, naming the forward
    operation that made it (slow: a development switch)."""
    torch.autograd.set_detect_anomaly(True)


@contextmanager
def profiler_trace(log_dir: str):
    """Record the block under ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) and write the Chrome trace
    ``DIR/trace_<pid>_<time>.json``; the path is the profile's
    ``trace_path`` attribute."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
