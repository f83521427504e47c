"""3D pose accuracy: MPJPE, and AP and recall over mm thresholds.

The port's own copy of ``mpe3d_tpu/eval/pose_metrics.py``, with the
reference's evaluation semantics (test/metrics_from_model.py:303-382): per
frame a GT x results table of mean joint distance over the rig's
``used_joints`` present in the GT dict; assignment by the best permutation
(min summed error); MPJPE over matched poses whose GT carries the '-1'
marker; per-threshold TP/FP streams (25..150 mm, step 25) turned into AP
with the cumulated precision-envelope interpolation.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

DEFAULT_THRESHOLDS_MM = tuple(range(25, 155, 25))


def pose_error_table(gt3d: np.ndarray, gt_valid: np.ndarray,
                     results: np.ndarray,
                     used_joints: Sequence[int]) -> np.ndarray:
    """[G, R]: mean joint distance (m) over used joints with GT.  gt3d
    [G, J, 3], gt_valid [G, J] bool, results [R, J, 3].  A GT person with
    no valid used joint keeps a row of zeros, as in the reference
    (metrics_from_model.py:318-320): it matches any result at no cost."""
    G = len(gt3d)
    table = np.zeros((G, len(results)), np.float64)
    used = np.zeros(gt3d.shape[1], bool)
    used[list(used_joints)] = True
    for g in range(G):
        sel = gt_valid[g] & used
        if sel.sum() == 0:
            continue
        d = np.linalg.norm(results[:, sel] - gt3d[g, sel][None], axis=-1)
        table[g] = d.mean(axis=1)
    return table


def best_permutation(err_table: np.ndarray) -> List[int]:
    """The min-total-error assignment (reference :322-337): a result index
    a GT row, an index >= R meaning unmatched (no cost).  Up to
    max(G, R) = 6 every permutation is scanned, for the reference's tie
    breaking; past it an exact Hungarian assignment (the same total)."""
    G, R = err_table.shape
    if G == 0:
        return []
    if max(G, R) > 6:
        if G > R:
            # unmatched GT rows take zero-cost pseudo-columns >= R, like
            # the reference's permutations(range(G), G)
            table = np.concatenate(
                [err_table, np.zeros((G, G - R), err_table.dtype)], axis=1)
        else:
            table = err_table
        rows, cols = linear_sum_assignment(table)
        out = np.empty(G, np.int64)
        out[rows] = cols
        return [int(r) for r in out]
    if G <= R:
        perms = itertools.permutations(range(R), G)
    else:
        perms = itertools.permutations(range(G), G)
    best, best_p = np.inf, None
    for p in perms:
        acc = sum(err_table[g, r] for g, r in enumerate(p) if r < R)
        if acc < best:
            best, best_p = acc, p
    return list(best_p) if best_p is not None else []


@dataclass
class PoseEvalAccumulator:
    """Streaming MPJPE / AP accumulator, one ``update`` a frame."""

    used_joints: Sequence[int]
    thresholds_mm: Sequence[int] = DEFAULT_THRESHOLDS_MM
    acum_err: float = 0.0
    n_matched: int = 0
    n_gt: int = 0
    n_poses: int = 0
    tp: Dict[int, List[int]] = field(default_factory=dict)
    fp: Dict[int, List[int]] = field(default_factory=dict)

    def __post_init__(self):
        for th in self.thresholds_mm:
            self.tp[th] = []
            self.fp[th] = []

    def update(self, gt3d: np.ndarray, gt_valid: np.ndarray,
               person_valid: np.ndarray, results: np.ndarray) -> None:
        """gt3d [G, J, 3] (m, world), gt_valid [G, J], person_valid [G]
        (the '-1' marker), results [R, J, 3] (m, world)."""
        G, R = len(gt3d), len(results)
        self.n_poses += R
        self.n_gt += G
        if G == 0:
            for th in self.thresholds_mm:
                self.tp[th].extend([0] * R)
                self.fp[th].extend([1] * R)
            return
        table = pose_error_table(gt3d, gt_valid, results, self.used_joints)
        perm = best_permutation(table)
        assigned = {r: g for g, r in enumerate(perm) if r < R}
        for r in range(R):
            g = assigned.get(r)
            if g is not None:
                if person_valid[g]:
                    self.n_matched += 1
                    self.acum_err += table[g, r]
                else:
                    self.n_gt -= 1   # the reference discounts invalid GT
            for th in self.thresholds_mm:
                if g is not None:
                    if not person_valid[g]:
                        continue
                    hit = table[g, r] * 1000.0 < th
                    self.tp[th].append(1 if hit else 0)
                    self.fp[th].append(0 if hit else 1)
                else:
                    self.tp[th].append(0)
                    self.fp[th].append(1)

    def mpjpe_mm(self) -> float:
        return (self.acum_err * 1000.0 / self.n_matched
                if self.n_matched else float("nan"))

    def ap_table(self) -> Dict[int, Dict[str, float]]:
        """AP, final precision and final recall a threshold (reference
        :368-382)."""
        out = {}
        for th in self.thresholds_mm:
            tp = np.cumsum(np.asarray(self.tp[th], np.float64))
            fp = np.cumsum(np.asarray(self.fp[th], np.float64))
            if len(tp) == 0:
                out[th] = {"ap": 0.0, "precision": 0.0, "recall": 0.0}
                continue
            recall = tp / (self.n_gt + 1e-5)
            precise = tp / (tp + fp + 1e-5)
            for n in range(len(precise) - 2, -1, -1):
                precise[n] = max(precise[n], precise[n + 1])
            precise = np.concatenate(([0.0], precise, [0.0]))
            recall_c = np.concatenate(([0.0], recall, [1.0]))
            idx = np.where(recall_c[1:] != recall_c[:-1])[0]
            ap = float(np.sum((recall_c[idx + 1] - recall_c[idx])
                              * precise[idx + 1]))
            out[th] = {"ap": ap, "precision": float(precise[-2]),
                       "recall": float(recall_c[-2])}
        return out

    def summary(self) -> Dict[str, float]:
        aps = self.ap_table()
        return {
            "mpjpe_mm": self.mpjpe_mm(),
            "mAP": float(np.mean([v["ap"] for v in aps.values()])) * 100.0,
            "mR": float(np.mean([v["recall"] for v in aps.values()])) * 100.0,
            "n_gt": self.n_gt,
            "n_poses": self.n_poses,
            "n_matched": self.n_matched,
            "ap_per_threshold": {str(k): v for k, v in aps.items()},
        }
