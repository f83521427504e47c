"""The comparison that decides ``correct`` can fail: its control (the
reference in the next precision down, in the program's place) and the
faults a cell can have, planted in the program under a run that skips the
look for a chip, each come out not correct."""

import time

import numpy as np
import pytest
import torch

from portbench.cell import load
from portbench.loops import train_lifter
from portbench.run import run_cell, tiny
from portbench.tests.queued import load_any

BATCH = ["panoptic.batch_s4", "panoptic.batch_s16", "arplab.batch_s4",
         "panoptic.stream_live"]


def _fails(checks, limits):
    return any(not np.isfinite(v) or v > limits[k] for k, v in checks.items())


@pytest.mark.parametrize("workload", BATCH)
def test_batch_control_fails(workload):
    cell = tiny(load_any(workload))
    st = cell.loop.setup(cell, 31, "cpu", build_program=False)
    assert _fails(cell.loop.control(st, 31), cell.limits)


def test_train_control_fails():
    cell = tiny(load("panoptic.train_lifter"))
    st = train_lifter.setup(cell, 31, "cpu", build_program=False)
    assert _fails(train_lifter.judge(st, train_lifter.control_readings(st)),
                  cell.limits)


def _scores_altered(mp, st):
    cls = type(st.pipe.matcher)
    fwd = cls.forward

    def forward(self, *a, **k):
        out = fwd(self, *a, **k).clone()
        out[:3] += 0.05
        return out
    mp.setattr(cls, "forward", forward)


def _person_altered(mp, st):
    import mpe3d_tpu_torch.pipeline as P
    fdp = P.frame_decode_pack

    def frame_decode_pack(*a, **k):
        out = fdp(*a, **k)
        p = out.persons.clone()
        p[0] = torch.where(p[0] >= 0, torch.full_like(p[0], -1),
                           torch.zeros_like(p[0]))
        return out._replace(persons=p)
    mp.setattr(P, "frame_decode_pack", frame_decode_pack)


def _pose_altered(mp, st):
    cls = type(st.pipe.lifter)
    fwd = cls.forward
    mp.setattr(cls, "forward", lambda self, x: fwd(self, x) * 1.01)


def _half_batch(mp, st):
    cls = type(st.pipe)
    sub = cls.submit_batch

    def submit_batch(self, frames, *a, **k):
        return sub(self, frames[:max(1, len(frames) // 2)], *a, **k)
    mp.setattr(cls, "submit_batch", submit_batch)


@pytest.mark.parametrize("fault", [_scores_altered, _person_altered,
                                   _pose_altered, _half_batch])
def test_batch_faults_fail(monkeypatch, fault):
    cell = tiny(load("panoptic.batch_s4"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time(),
                   fault=lambda st: fault(monkeypatch, st))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_scores_altered, _person_altered,
                                   _pose_altered])
def test_stream_faults_fail(monkeypatch, fault):
    cell = tiny(load_any("panoptic.stream_live"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time(),
                   fault=lambda st: fault(monkeypatch, st))
    assert out["correct"] is False, out["checks"]


def test_stream_sound_run_is_correct():
    cell = tiny(load_any("panoptic.stream_live"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time())
    assert out["correct"] is True, out["checks"]


def test_batch_sound_run_is_correct():
    cell = tiny(load("panoptic.batch_s4"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time())
    assert out["correct"] is True, out["checks"]


def _state_unchanged(mp, st):
    import mpe3d_tpu_torch.train.lifter as T
    mp.setattr(T.Adam, "step", lambda self, grads: None)


def _half_of_each_batch(mp, st):
    import mpe3d_tpu_torch.train.lifter as T
    loss = T.reprojection_loss

    def half(pred, err, *a, **k):
        n = max(1, pred.shape[0] // 2)
        return loss(pred[:n], err[:n], *a, **k)
    mp.setattr(T, "reprojection_loss", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_of_each_batch])
def test_train_faults_fail(monkeypatch, fault):
    cell = tiny(load("panoptic.train_lifter"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time(),
                   fault=lambda st: fault(monkeypatch, st))
    assert out["correct"] is False, out["checks"]


def test_train_sound_run_is_correct():
    cell = tiny(load("panoptic.train_lifter"))
    out = run_cell(cell, 5, 1.0, False, "cpu", time.time())
    assert out["correct"] is True, out["checks"]
