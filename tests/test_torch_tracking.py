"""The port's PoseTracker and track_outputs against the JAX package's on
seeded scenes: walkers, crossings, occlusions, births, jitter with
smoothing.  Ids must be equal and poses equal, frame for frame."""

import numpy as np
import pytest

from mpe3d_tpu import tracking as jtracking
from mpe3d_tpu_torch import tracking
from mpe3d_tpu_torch.pipeline import PipelineOutput


def _person(center, rng=None, jitter=0.0):
    """An 18-joint blob around a 3D center."""
    base = np.linspace(-0.4, 0.4, 18)[:, None] * np.array([0, 0, 1.0])
    pose = np.asarray(center, np.float32) + base
    if jitter:
        pose = pose + rng.standard_normal(pose.shape) * jitter
    return pose.astype(np.float32)


def _walkers(rng):
    """Two people walking apart, in shuffled order."""
    out = []
    for t in range(20):
        people = [_person([0.05 * t, 0.0, 1.0], rng, 0.01),
                  _person([-0.05 * t, 2.0, 1.0], rng, 0.01)]
        out.append(np.stack(people[::1 if t % 2 else -1]))
    return out


def _crossing(rng):
    """Two people passing each other within the gate."""
    return [np.stack([_person([-1.0 + 0.1 * t, 0.0, 1.0], rng, 0.005),
                      _person([1.0 - 0.1 * t, 0.25, 1.0], rng, 0.005)])
            for t in range(21)]


def _occlusion(rng):
    """One person moving, missing for 3 frames (re-associated), then for
    12 (retired), plus a second person appearing and random clutter."""
    empty = np.zeros((0, 18, 3), np.float32)
    seq = [np.stack([_person([0.1 * t, 0, 1], rng, 0.01)]) for t in range(4)]
    seq += [empty] * 3
    seq += [np.stack([_person([0.6, 0, 1], rng, 0.01),
                      _person([3, 0, 1], rng, 0.01)])]
    seq += [empty] * 12
    seq += [np.stack([_person([0.6, 0, 1], rng, 0.01)])]
    for _ in range(15):
        n = int(rng.integers(0, 5))
        seq.append(np.stack([_person(rng.uniform(-3, 3, 3), rng, 0.05)
                             for _ in range(n)]) if n else empty)
    return seq


SCENES = {"walkers": _walkers, "crossing": _crossing,
          "occlusion": _occlusion}


@pytest.mark.parametrize("smooth", [0.0, 0.7])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tracker_matches_jax(scene, smooth):
    frames = SCENES[scene](np.random.default_rng(11))
    kw = dict(max_dist=0.6, max_missed=5, smooth=smooth)
    port, ref = tracking.PoseTracker(**kw), jtracking.PoseTracker(**kw)
    n_ids = set()
    for poses in frames:
        ids, out = port.update(poses)
        rids, rout = ref.update(poses)
        np.testing.assert_array_equal(ids, rids)
        assert ids.dtype == rids.dtype
        np.testing.assert_array_equal(out, rout)
        assert port.active_ids == ref.active_ids
        n_ids.update(ids.tolist())
    assert len(n_ids) >= 2


def test_track_outputs_matches_jax():
    rng = np.random.default_rng(5)
    outs = [PipelineOutput(poses, np.zeros((len(poses), 5), np.int32),
                           np.zeros(4, np.float32), len(poses),
                           np.zeros(len(poses), np.float32))
            for poses in _walkers(rng) + _occlusion(rng)]
    got = list(tracking.track_outputs(outs, max_dist=0.6, smooth=0.5))
    ref = list(jtracking.track_outputs(outs, max_dist=0.6, smooth=0.5))
    assert len(got) == len(ref) == len(outs)
    for (ids, poses, o), (rids, rposes, ro) in zip(got, ref):
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(poses, rposes)
        assert o is ro
