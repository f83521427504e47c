"""Live frames, one at a time: each frame through
``PoseEstimationPipeline.submit_fused`` / ``collect_fused``, the next
frame submitted only once the last one's poses are back (a closed loop
with one frame in flight), cycling over a seeded pool of ``pool_frames``
frames, with the batch cells' seeded models (``loops/batch.py``).
Set-up submits every pool frame once.

``live_frames_per_s``: frames collected over the window's wall time.
``frame_p95_ms``: the 95th percentile over every frame of the window of
the time from its ``submit_fused`` call to the return of its
``collect_fused``; the median and the count go to standard error.

The comparison is the batch cells' (``loops/batch.judge``), each frame a
batch of one: ``check_frames`` of the window's frames drawn from the
seed.

Its cell, ``panoptic.stream_live``, waits in ``portbench/queued/``: the
frame path issues its launches eagerly, so the host paces the loop, and
a shared host's speed drifts from run to run by more than any bound of
the benchmark can hold (PERF.md, "Open questions")."""

from __future__ import annotations

import functools
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import program
from portbench.loops import batch as B
from portbench.loops.batch import control, judge, layer_context  # noqa: F401
from portbench.trace import Tracer, maybe


def setup(cell, seed: int, device, build_program: bool = True) -> B.State:
    tr = cell.traffic
    st = B.state(cell, seed, device, 1, tr["pool_frames"], tr["check_frames"])
    if build_program:
        program.check_rig(cell.config)
        st.pipe = st.form.build(st)
        st.batches = program.frame_list(st.pool)
        for f in st.batches:
            st.pipe.collect_fused(st.pipe.submit_fused(f))
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)
    return st


def window(st: B.State, seconds: float, seed: int,
           tracer: Optional[Tracer] = None, trace_at: float = 0.0,
           trace_s: float = 0.0) -> B.Window:
    pipe, pool = st.pipe, st.batches
    rng = np.random.default_rng([seed % 2 ** 63, 17])
    lat, sample, traced = [], [], []
    done = traced_frames = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if tracer is not None:
            if tracer.prof is None and now >= t0 + trace_at:
                tracer.start()
            elif tracer.active and now >= tracer.t0 + trace_s:
                tracer.stop()
        if now >= t_end:
            break
        i = done % len(pool)
        on = tracer is not None and tracer.active
        ts = time.perf_counter()
        with maybe(tracer, "submit"):
            ticket = pipe.submit_fused(pool[i])
        with maybe(tracer, "collect"):
            o = pipe.collect_fused(ticket)
        lat.append(time.perf_counter() - ts)
        outs = [B.FrameOut(o.poses, o.persons, o.scores, o.quality)]
        if on:
            traced.append((i, outs))
            traced_frames += 1
        if done < st.n_check:
            sample.append((i, outs))
        else:
            j = int(rng.integers(0, done + 1))
            if j < st.n_check:
                sample[j] = (i, outs)
        done += 1
    wall = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        tracer.stop()
    return B.Window(wall, done, lat, sample, done, 0, traced, traced_frames)


def end_to_end(win: B.Window) -> Dict[str, float]:
    lat_ms = 1e3 * np.asarray(win.latencies_s)
    print(f"stream: {len(lat_ms)} frames, submit to collect median "
          f"{float(np.median(lat_ms))!r} ms", file=sys.stderr)
    return {"live_frames_per_s": win.frames / win.wall_s,
            "frame_p95_ms": float(np.percentile(lat_ms, 95))}


measure = functools.partial(B.measure, window=window, end_to_end=end_to_end)


def tiny(cfg: dict, tr: dict) -> None:
    """Rehearsal size: a pool of four frames, two compared."""
    tr.update(pool_frames=4, check_frames=2)
