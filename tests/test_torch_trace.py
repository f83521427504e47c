"""The port's spans and counters (``mpe3d_tpu_torch/utils/trace.py``) on
the CPU.

Without a profiler the batch path, the frame path and the lifter trainer
record nothing.  Under ``torch.profiler.profile`` every span of the batch
path (the union body and the eager body), the frame path and the trainer
is recorded, nested under its parent, with one key a batch (the ticket's)
and an epoch, both ends on the ``perf_counter`` clock; ``lifter.rows``
counts the rows the lifter gets.  ``TimingAccumulator`` keeps its numbers
and its spans land in the buffer.  Outputs and losses are the same with
tracing on and off.  The buffer itself: nesting by thread, the cap and
its drop count, ``snapshot`` leaving it whole, ``clear``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig,
                                    LifterTrainConfig, MatcherConfig)
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            generate_single_person_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.eval import timing
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
from mpe3d_tpu_torch.train.lifter import train_lifter
from mpe3d_tpu_torch.train.lifter_data import build_lifter_dataset
from mpe3d_tpu_torch.utils import trace

NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.05,
                   camera_dropout=0.05)
STAGES = ("chunk.features", "chunk.gat", "chunk.decode", "chunk.lifter",
          "chunk.quality")
BATCH = ("batch.submit", "batch.pack", "batch.download", "batch.collect")
TRAIN = ("train.epoch", "train.grad", "train.update", "train.readback",
         "train.eval", "train.select")


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def frames():
    rig = synthetic_ring_rig(PANOPTIC)
    wire = generate_frames(PANOPTIC, rig, 5, n_people=(2, 3), seed=3,
                           noise=NOISE, spread=2.5)
    return [parse_frame(w, PANOPTIC, 4) for w in wire]


def _pipe(union: bool):
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8,),
                         heads=(2,))
    lcfg = LifterConfig(widths=(64,))
    return PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(weights.random_matcher_tree(mcfg, 0),
                                  mcfg, "cpu"),
        weights.lifter_from_tree(weights.random_lifter_tree(lcfg, 1), lcfg,
                                 "cpu"),
        slot_buckets=(4,), person_buckets=(8,), threshold=0.05,
        decode_top_k=0, use_frame_kernel=True if union else None,
        device="cpu")


def _batches(pipe, frames):
    """Two batches in flight (3 and 2 frames, the second padded to 3)."""
    t1 = pipe.submit_batch(frames[:3], slots=4)
    t2 = pipe.submit_batch(frames[3:], slots=4, pad_to=3)
    return pipe.collect_batch(t1) + pipe.collect_batch(t2), (t1, t2)


def _fused(pipe, frames):
    return [pipe.collect_fused(pipe.submit_fused(f)) for f in frames[:2]]


def _root(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


def _outputs(outs):
    return [(o.poses, o.persons, o.scores, o.quality) for o in outs]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def dataset():
    rig = synthetic_ring_rig(PANOPTIC)
    wire = generate_single_person_frames(PANOPTIC, rig, 16, seed=1,
                                         noise=NOISE)
    net, err = build_lifter_dataset(wire, PANOPTIC, rig, max_combinations=2,
                                    seed=0, device="cpu")
    return net[:48], err[:48], net[48:64], err[48:64]


def _train(dataset, scan_epoch=True, epochs=3):
    net, err, nd, ed = dataset
    return train_lifter(net, err, nd, ed, PANOPTIC,
                        synthetic_ring_rig(PANOPTIC),
                        LifterConfig(widths=(32,)),
                        LifterTrainConfig(epochs=epochs, batch_size=16,
                                          eval_every=2, lr=1e-3,
                                          scan_epoch=scan_epoch),
                        log=lambda s: None, device="cpu")


def test_nothing_recorded_without_a_profiler(frames, dataset):
    assert not trace.recording()
    for union in (True, False):
        pipe = _pipe(union)
        _batches(pipe, frames)
        _fused(pipe, frames)
    _train(dataset, epochs=2)
    snap = trace.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.dropped == 0


@pytest.mark.parametrize("union", [True, False])
def test_batch_spans_nest_under_their_submit(frames, union):
    pipe = _pipe(union)
    _batches(pipe, frames)                   # plans and tables built
    t0 = time.perf_counter_ns()
    with _profiled():
        assert trace.recording()
        _, tickets = _batches(pipe, frames)
    t1 = time.perf_counter_ns()
    spans = trace.snapshot().spans
    names = {s.name for s in spans}
    assert set(BATCH + STAGES) <= names
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    submits = [i for i, s in enumerate(spans) if s.name == "batch.submit"]
    assert [spans[i].key for i in submits] == [t[-1] for t in tickets]
    assert len({t[-1] for t in tickets}) == 2
    collects = [s for s in spans if s.name == "batch.collect"]
    assert [s.key for s in collects] == [t[-1] for t in tickets]
    assert all(s.parent is None for s in collects)
    plan = pipe.batch_plan(4, 3)
    for i, s in enumerate(spans):
        if s.name in ("batch.pack", "batch.download") + STAGES:
            assert _root(spans, i) in submits, s.name
            assert s.key is None
        if s.name in ("batch.pack", "batch.download"):
            assert s.parent in submits
    for r in submits:
        mine = [s.name for i, s in enumerate(spans) if _root(spans, i) == r]
        assert mine.count("batch.pack") == mine.count("batch.download") == 1
        for stage in STAGES:
            # a chunk each: a union of frames, or one eager frame
            assert mine.count(stage) == len(plan.chunks), stage


def test_frame_path_spans(frames):
    pipe = _pipe(True)
    _fused(pipe, frames)
    with _profiled():
        _fused(pipe, frames)
    spans = trace.snapshot().spans
    roots = [i for i, s in enumerate(spans) if s.name == "frame.submit"]
    assert len(roots) == 2
    keys = [spans[i].key for i in roots]
    assert [s.key for s in spans if s.name == "frame.collect"] == keys
    for r in roots:
        mine = [s.name for i, s in enumerate(spans)
                if i != r and _root(spans, i) == r]
        assert sorted(mine) == sorted(("frame.pack", "frame.download")
                                      + STAGES)


@pytest.mark.parametrize("union", [True, False])
def test_lifter_rows_counted(frames, union):
    pipe = _pipe(union)
    rows = []                   # (rows, recording) of every lifter call
    hook = pipe.lifter.register_forward_hook(
        lambda m, inp, out: rows.append((inp[0].shape[0],
                                         trace.recording())))
    _batches(pipe, frames)
    with _profiled():
        _batches(pipe, frames)
        _fused(pipe, frames)
    hook.remove()
    lifted = sum(n for n, on in rows if on)
    assert lifted > 0 and not all(on for _, on in rows)
    assert trace.snapshot().counters == {"lifter.rows": lifted}


@pytest.mark.parametrize("scan_epoch", [True, False])
def test_train_spans(dataset, scan_epoch):
    t0 = time.perf_counter_ns()
    with _profiled():
        res = _train(dataset, scan_epoch)
    t1 = time.perf_counter_ns()
    spans = trace.snapshot().spans
    epochs = [i for i, s in enumerate(spans) if s.name == "train.epoch"]
    assert [spans[i].key for i in epochs] == list(range(res.epochs_run))
    assert all(spans[i].parent is None for i in epochs)
    steps = len(dataset[0]) // 16
    for e in epochs:
        mine = [s.name for s in spans if s.parent == e]
        evals = int(spans[e].key % 2 == 0)
        assert sorted(mine) == sorted(
            ["train.grad", "train.update"] * steps + ["train.readback"]
            + ["train.eval", "train.select"] * evals), mine
    assert {s.name for s in spans} == set(TRAIN)
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("union", [True, False])
def test_outputs_the_same_with_tracing_on(frames, union):
    pipe = _pipe(union)
    off = _outputs(_batches(pipe, frames)[0]) + _outputs(_fused(pipe, frames))
    with _profiled():
        on = (_outputs(_batches(pipe, frames)[0])
              + _outputs(_fused(pipe, frames)))
    _same(off, on)
    assert trace.snapshot().spans


def test_training_the_same_with_tracing_on(dataset):
    off = _train(dataset)
    with _profiled():
        on = _train(dataset)
    assert [h["train_loss"] for h in off.history] == \
        [h["train_loss"] for h in on.history]
    assert [h["val_loss"] for h in off.history] == \
        [h["val_loss"] for h in on.history]
    for a, b in zip(off.params["layers"], on.params["layers"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_timing_accumulator_numbers_and_spans(monkeypatch):
    ticks = iter([10.0, 10.5, 20.0, 21.5, 30.0, 30.25])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(ticks))
    acc = timing.TimingAccumulator()
    with acc.span("t_pp", 1):
        pass
    with _profiled():
        with acc.span("t_3D", 3):
            pass
    with acc.span("t_pp", 0):                # no items: not counted
        pass
    assert acc.totals == {"t_pp": 0.5, "t_3D": 1.5}
    assert acc.per_person == {"t_pp": 0.5, "t_3D": 0.5}
    assert acc.counts == {"t_pp": 1, "t_3D": 1}
    assert acc.summary() == {"t_pp_ms": 500.0, "t_pp_per_person_ms": 500.0,
                             "t_3D_ms": 1500.0, "t_3D_per_person_ms": 500.0}
    assert [s.name for s in trace.snapshot().spans] == ["t_3D"]


def test_buffer_nesting_cap_snapshot_and_clear(monkeypatch):
    with trace.span("outside"):
        pass
    trace.count("outside")
    assert trace.snapshot().spans == []
    with _profiled():
        with trace.span("a", key=7):
            with trace.span("b"):
                trace.count("n", 2)
                trace.count("n")
            done = threading.Event()

            def other():
                with trace.span("c"):
                    pass
                done.set()
            threading.Thread(target=other).start()
            assert done.wait(30)
        monkeypatch.setattr(trace, "CAP", 4)
        for _ in range(3):
            with trace.span("d"):
                pass
    snap = trace.snapshot()
    assert [(s.name, s.parent, s.key) for s in snap.spans] == [
        ("a", None, 7), ("b", 0, None), ("c", None, None), ("d", None, None)]
    assert all(s.start_ns <= s.end_ns for s in snap.spans)
    assert snap.counters == {"n": 3} and snap.dropped == 2
    assert trace.snapshot() == snap          # reading leaves it whole
    trace.clear()
    assert trace.snapshot() == trace.Snapshot([], {}, 0)


def test_threads_keep_their_own_nesting():
    """More threads than cores open nested spans and count at once, with a
    short switch interval: every child's parent is its own thread's span
    and no count is lost."""
    n_threads, n_iter = 2 * (os.cpu_count() or 2) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            def work(t):
                for i in range(n_iter):
                    with trace.span("outer", key=(t, i)):
                        with trace.span("inner", key=(t, i)):
                            trace.count("n")
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert snap.counters == {"n": n_threads * n_iter}
    inner = [s for s in snap.spans if s.name == "inner"]
    assert len(inner) == n_threads * n_iter
    for s in inner:
        p = snap.spans[s.parent]
        assert p.name == "outer" and p.key == s.key
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
