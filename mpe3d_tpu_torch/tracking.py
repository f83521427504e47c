"""Temporal identity tracking and smoothing over per-frame 3D poses.

The port's own copy of ``mpe3d_tpu/tracking.py`` (the port imports nothing
of the JAX package).  No reference counterpart: the reference pipeline is
frame-independent, so person identities flicker between frames.  This
module assigns stable track ids to the pipeline's per-frame poses and
optionally smooths the reported joints.

Tracking is host-side, stateful and tiny (P <= 16 persons, J = 18 joints),
so it consumes the pipeline's outputs (``infer_stream``, ``serve``) frame
by frame, in order; the device path stays stateless.

Association: constant-velocity prediction per track, mean-per-joint
Euclidean cost against each proposal, exact Hungarian assignment (scipy),
gated at ``max_dist`` metres.  Unmatched proposals open new tracks;
unmatched tracks coast (their prediction advances) for ``max_missed``
frames before retiring, which re-associates through short occlusions.

Smoothing: per-track exponential moving average of the joints (``smooth``
in [0, 1); 0 = off).  The EMA restarts after a coast, so a re-acquired
track is not dragged by stale history.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
# at module load, not at the first assignment, so the import's cost is
# paid at start-up (serve --warmup) and not by the first tracked frames
from scipy.optimize import linear_sum_assignment


@dataclass
class _Track:
    tid: int
    pose: np.ndarray                 # [J, 3] smoothed (reported) joints
    raw: np.ndarray                  # [J, 3] last raw observation
    velocity: np.ndarray             # [J, 3] EMA of per-frame deltas
    hits: int = 1
    missed: int = 0

    def predict(self) -> np.ndarray:
        return self.raw + self.velocity


@dataclass
class PoseTracker:
    """Stable-id tracker over per-frame pose lists.

    ``update(poses)`` consumes one frame's poses ([P, J, 3] metres, any
    P ≥ 0) and returns ``(track_ids [P] int, poses [P, J, 3])`` where the
    returned poses are EMA-smoothed when ``smooth > 0`` (else the input
    array).  Ids are assigned in first-seen order and never reused.
    """

    max_dist: float = 0.5            # association gate (m, mean per joint)
    max_missed: int = 10             # frames a track coasts before retiring
    smooth: float = 0.0              # EMA weight on history (0 = off)
    velocity_ema: float = 0.5        # weight on previous velocity estimate
    _tracks: List[_Track] = field(default_factory=list)
    _next_id: int = 0

    def reset(self) -> None:
        self._tracks = []
        self._next_id = 0

    @property
    def active_ids(self) -> List[int]:
        return [t.tid for t in self._tracks]

    def update(self, poses: np.ndarray):
        poses = np.asarray(poses, np.float32)
        P = len(poses)
        assigned = np.full(P, -1, np.int64)
        matched_tracks: Dict[int, int] = {}       # track index -> pose index

        if P and self._tracks:
            preds = np.stack([t.predict() for t in self._tracks])  # [T,J,3]
            # mean per-joint distance, [T, P]
            cost = np.linalg.norm(preds[:, None] - poses[None], axis=-1
                                  ).mean(axis=-1)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] <= self.max_dist:
                    matched_tracks[r] = c

        out = poses.copy()
        for r, c in matched_tracks.items():
            t = self._tracks[r]
            delta = poses[c] - t.raw
            if t.missed:
                # re-acquired after a coast: restart velocity/EMA history
                t.velocity = np.zeros_like(delta)
                t.pose = poses[c]
            else:
                t.velocity = (self.velocity_ema * t.velocity
                              + (1.0 - self.velocity_ema) * delta)
                t.pose = (self.smooth * t.pose
                          + (1.0 - self.smooth) * poses[c])
            t.raw = poses[c]
            t.hits += 1
            t.missed = 0
            assigned[c] = t.tid
            out[c] = t.pose

        # unmatched tracks coast; retire after max_missed frames
        survivors = []
        for i, t in enumerate(self._tracks):
            if i in matched_tracks:
                survivors.append(t)
                continue
            t.missed += 1
            t.raw = t.predict()       # coast so re-association stays local
            if t.missed <= self.max_missed:
                survivors.append(t)
        self._tracks = survivors

        # unmatched poses open new tracks
        for c in range(P):
            if assigned[c] >= 0:
                continue
            t = _Track(self._next_id, poses[c].copy(), poses[c].copy(),
                       np.zeros_like(poses[c]))
            self._next_id += 1
            self._tracks.append(t)
            assigned[c] = t.tid

        return assigned, out


def track_outputs(outputs, max_dist: float = 0.5, max_missed: int = 10,
                  smooth: float = 0.0):
    """Convenience wrapper: iterate PipelineOutput frames (from
    ``PoseEstimationPipeline.infer_stream``) and yield
    ``(track_ids, poses, output)`` triples with stable ids."""
    tracker = PoseTracker(max_dist=max_dist, max_missed=max_missed,
                          smooth=smooth)
    for out in outputs:
        ids, poses = tracker.update(out.poses)
        yield ids, poses, out
