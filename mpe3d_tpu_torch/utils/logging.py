"""The profiler trace of ``infer --profile-trace DIR``.

Port of ``mpe3d_tpu/utils/logging.py::profiler_trace`` (:70-80), which
wraps ``jax.profiler`` around a block: here ``torch.profiler`` records the
block's host calls and, on a CUDA device, its kernels (CUPTI), and writes
one Chrome trace (``chrome://tracing``, Perfetto) into DIR.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


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
