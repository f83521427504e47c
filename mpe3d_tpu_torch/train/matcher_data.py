"""Matcher scenes: single-person recordings composited into multi-person
scenes as fixed-shape numpy arrays.

The port's own copy of ``mpe3d_tpu/train/matcher_data.py`` (:38-247), over
the port's ``PairTopology``; the same seed gives the same scenes.  The
reference's training-set synthesis (skeleton_matching/graph_generator.py:
672-810): each input frame expanded into its camera subsets of at least
``min_views`` cameras (utils/data_augmentation.py:50-85); each composite
takes 1..n_files frames from the highest-probability files (:684-693);
per (frame, camera) the skeleton with most joints is the person's real
head, the rest spurious (:726-737); a candidate pair is labelled 1 for two
real heads of one person, else 0 (:753-798).  A scene fills padded
``[C, S, J]`` buffers plus a label and a weight a pair of the static
topology; the weight carries the reference's pair multiplicity (real-real
and spurious-spurious edge nodes twice, real-spurious once).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.matching.features import PairTopology


@dataclass
class MatcherScenes:
    """A batchable set of composite scenes on a fixed (C, S) grid."""

    kp: np.ndarray          # [N, C, S, J, 2]
    valid: np.ndarray       # [N, C, S, J]
    prob: np.ndarray        # [N, C, S, J]
    observed: np.ndarray    # [N, C, S, J] bool
    present: np.ndarray     # [N, C, S] bool
    labels: np.ndarray      # [N, E] 0/1
    pair_weight: np.ndarray  # [N, E] 0 (absent) / 1 / 2 (duplicated)

    def __len__(self) -> int:
        return len(self.kp)

    def select(self, idx) -> "MatcherScenes":
        return MatcherScenes(*(getattr(self, f.name)[idx]
                               for f in self.__dataclass_fields__.values()))


def _parse_skeletons(entry, joint_count: int):
    """One camera entry → list of (kp [J,2], valid [J], prob [J], obs [J])."""
    skeletons = entry[0]
    if isinstance(skeletons, str):
        skeletons = json.loads(skeletons)
    out = []
    for sk in skeletons:
        kp = np.zeros((joint_count, 2), np.float32)
        valid = np.zeros(joint_count, np.float32)
        prob = np.zeros(joint_count, np.float32)
        obs = np.zeros(joint_count, bool)
        n = 0
        for j_key, values in sk.items():
            if j_key == "ID":
                continue
            j = int(j_key)
            if j >= joint_count:
                continue
            kp[j] = (values[1], values[2])
            valid[j] = values[3]
            prob[j] = values[4]
            obs[j] = True
            n += 1
        if n > 0:
            out.append((kp, valid, prob, obs, n))
    return out


def camera_subset_augment(frames: List[Dict], rig_config: RigConfig,
                          min_views: int = 2) -> List[Dict]:
    """≙ utils/data_augmentation.py:50-85 — expand each frame into every
    camera subset with ≥ min_views populated used cameras (full set first)."""
    used = rig_config.used_cameras
    out: List[Dict] = []
    for frame in frames:
        flags = []
        base = {}
        for c in used:
            if c in frame:
                skeletons = frame[c][0]
                if isinstance(skeletons, str):
                    has = skeletons not in ("[]", "")
                else:
                    has = bool(skeletons)
                if has:
                    base[c] = frame[c]
                    flags.append(1)
                else:
                    flags.append(0)
            else:
                flags.append(0)
        avail = [c for c, f in zip(used, flags) if f]
        if not avail:
            continue
        out.append(base)
        n = len(avail)
        for bits in range(1, 2 ** n):
            subset = [avail[i] for i in range(n) if bits >> i & 1]
            if len(subset) < min_views or len(subset) == n:
                continue
            out.append({c: base[c] for c in subset})
    return out


def composite_scene_stream(inputs: List[List[Dict]],
                           probabilities: Sequence[float],
                           limit: int, rng: np.random.Generator
                           ) -> Iterator[List[Dict]]:
    """≙ graph_generator.py:674-696 — yield lists of single-person frames.

    Pops pre-shuffled indices from the num_people highest-probability files;
    ends when a selected file runs out.
    """
    order = [list(rng.permutation(len(l))) for l in inputs]
    probs = np.asarray(probabilities, np.float64)
    for _ in range(limit):
        if all(len(o) == 0 for o in order):
            return
        num_people = int(rng.integers(1, len(inputs) + 1))
        top = np.argpartition(probs, -num_people)[-num_people:]
        views = []
        for fi in top:
            if not order[fi]:
                return
            views.append(inputs[fi][order[fi].pop()])
        if views:
            yield views


def build_matcher_scenes(inputs: List[List[Dict]], rig_config: RigConfig,
                         topo: PairTopology,
                         probabilities: Optional[Sequence[float]] = None,
                         limit: int = 120000, seed: int = 0,
                         augment: bool = True,
                         cache_path: Optional[str] = None) -> MatcherScenes:
    """Build the full composite-scene dataset on the static (C, S) grid.

    inputs: one list of wire frames per source file (single-person
    recordings).  ``probabilities`` default: 0.8·len(file)/len(file0)
    (reference: train_skeleton_matching.py:122-132).  ``cache_path`` caches
    the built tensors as npz (≙ the reference's DGL bin cache,
    graph_generator.py:884-916).
    """
    if cache_path and os.path.exists(cache_path):
        d = np.load(cache_path)
        return MatcherScenes(d["kp"], d["valid"], d["prob"],
                             d["observed"], d["present"], d["labels"],
                             d["pair_weight"])
    if probabilities is None:
        first = max(len(inputs[0]), 1)
        probabilities = [0.8 * len(l) / first for l in inputs]
        probabilities[0] = 0.8
    match_cams = rig_config.used_cameras_skeleton_matching
    cam_pos = {c: i for i, c in enumerate(match_cams)}
    C, S, J = topo.n_cameras, topo.n_slots, rig_config.n_joints
    rng = np.random.default_rng(seed)

    if augment:
        inputs = [camera_subset_augment(l, rig_config) for l in inputs]

    N_kp, N_v, N_p, N_o, N_pr = [], [], [], [], []
    N_lab, N_w = [], []
    e1s, e2s = topo.e1, topo.e2

    for views in composite_scene_stream(inputs, probabilities, limit, rng):
        kp = np.zeros((C, S, J, 2), np.float32)
        valid = np.zeros((C, S, J), np.float32)
        prob = np.zeros((C, S, J), np.float32)
        obs = np.zeros((C, S, J), bool)
        present = np.zeros((C, S), bool)
        person_id = -np.ones((C, S), np.int64)   # -1 = spurious/absent
        slot_used = np.zeros(C, np.int64)
        overflow = False
        for pid, view in enumerate(views):
            for cam, entry in view.items():
                if cam not in cam_pos:
                    continue
                ci = cam_pos[cam]
                sks = _parse_skeletons(entry, J)
                if not sks:
                    continue
                best = int(np.argmax([s[4] for s in sks]))
                for k, (skp, sv, sp, so, _) in enumerate(sks):
                    s = slot_used[ci]
                    if s >= S:
                        overflow = True
                        break
                    kp[ci, s] = skp
                    valid[ci, s] = sv
                    prob[ci, s] = sp
                    obs[ci, s] = so
                    present[ci, s] = True
                    person_id[ci, s] = pid if k == best else -1
                    slot_used[ci] += 1
        if overflow or not present.any():
            continue

        pid_flat = person_id.reshape(-1)
        pres_flat = present.reshape(-1)
        p1, p2 = pid_flat[e1s], pid_flat[e2s]
        m = (pres_flat[e1s] & pres_flat[e2s]).astype(np.float32)
        labels = ((p1 >= 0) & (p1 == p2)).astype(np.float32) * m
        # multiplicity: 1 for real<->spurious, 2 otherwise (see module doc)
        one_spurious = ((p1 >= 0) & (p2 < 0)) | ((p1 < 0) & (p2 >= 0))
        weight = np.where(one_spurious, 1.0, 2.0).astype(np.float32) * m
        if weight.sum() == 0:   # reference skips scenes with no edge-nodes
            continue

        N_kp.append(kp); N_v.append(valid); N_p.append(prob)
        N_o.append(obs); N_pr.append(present)
        N_lab.append(labels); N_w.append(weight)

    if not N_kp:
        z = lambda *s: np.zeros(s, np.float32)
        return MatcherScenes(z(0, C, S, J, 2), z(0, C, S, J), z(0, C, S, J),
                             np.zeros((0, C, S, J), bool),
                             np.zeros((0, C, S), bool),
                             z(0, topo.n_pairs), z(0, topo.n_pairs))
    scenes = MatcherScenes(np.stack(N_kp), np.stack(N_v), np.stack(N_p),
                           np.stack(N_o), np.stack(N_pr),
                           np.stack(N_lab), np.stack(N_w))
    if cache_path:
        # atomic publish (same race as lifter_data: a training run must
        # never np.load a half-written cache from a concurrent pre-build)
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, kp=scenes.kp, valid=scenes.valid,
                 prob=scenes.prob, observed=scenes.observed,
                 present=scenes.present, labels=scenes.labels,
                 pair_weight=scenes.pair_weight)
        os.replace(tmp, cache_path)
    return scenes
