"""Evaluation runners: the library form of the reference's test scripts.

Port of ``mpe3d_tpu/eval/runners.py``:

* ``run_pose_metrics``: test/metrics_from_model.py (``backend="mlp"``) and
  test/metrics_from_triangulation.py (``backend="triangulation"``);
* ``run_sm_metrics``: test/sm_metrics.py;
* ``run_sm_metrics_without_gt``: test/sm_metrics_without_gt.py;
* ``run_reprojection_error``: test/reprojection_error.py.

Each takes wire frames and a ``PoseEstimationPipeline`` and returns a
metrics dict; the command line (``cli.py``) prints it.  They drive the
pipeline's staged path (``match``, ``match_decode``,
``host_decode_scores``, ``lift``, ``__call__``), ``infer_fused`` and
``infer_stream``, so on the card every kernel of those paths runs.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.data.frames import (dedup_ground_truth, parse_frame,
                                         parse_frame_gt)
from mpe3d_tpu_torch.eval.clustering import clustering_report
from mpe3d_tpu_torch.eval.pose_metrics import (PoseEvalAccumulator,
                                               best_permutation,
                                               pose_error_table)
from mpe3d_tpu_torch.eval.reprojection import (per_camera_stats,
                                               reprojection_pixel_errors)
from mpe3d_tpu_torch.eval.timing import TimingAccumulator
from mpe3d_tpu_torch.matching.decode import (decode_person_proposals,
                                             single_camera_bypass)
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes

_CLUSTER_KEYS = ("ari", "homogeneity", "completeness", "v_measure")


def transform_gt_to_world(gt3d: np.ndarray, dataset_T_wc1: np.ndarray,
                          model_T_c1w: np.ndarray) -> np.ndarray:
    """Dataset-frame GT -> the model's world through camera 1 (reference
    test/metrics_from_model.py:156-161): world = T_c1w_model ·
    T_wc1_dataset · gt; the identity when both calibrations share a
    root."""
    M = model_T_c1w @ dataset_T_wc1
    return gt3d @ M[:3, :3].T + M[:3, 3]


def _staged_persons(fa, pipeline: PoseEstimationPipeline,
                    rig_config: RigConfig) -> np.ndarray:
    """Decoded persons [P, C_match] of the staged path: the device decode
    with ``decode_on_device``, else the matcher's scores to the host and
    the host decode."""
    if pipeline.decode_on_device:
        return pipeline.match_decode(fa)[4]
    scores, pm, topo, S = pipeline.match(fa)
    eff, order = pipeline.host_decode_scores(fa, scores, topo, S)
    return decode_person_proposals(eff, pm, topo,
                                   rig_config.min_number_of_views,
                                   pipeline.threshold, order_scores=order)


def run_pose_metrics(frames, rig_config: RigConfig,
                     pipeline: PoseEstimationPipeline, datastep: int = 12,
                     dataset_T_wc1: Optional[np.ndarray] = None,
                     max_skeletons: int = 10, fused: bool = False,
                     stream: int = 0, dedup_gt: bool = False) -> Dict:
    """3D accuracy and timing of the whole pipeline on every
    ``datastep``-th frame with GT (reference metrics_from_model.py:
    104-390).

    ``frames``: wire dicts, or the ``(FrameArrays, ground truths)`` tuple
    of ``data.frames.load_eval_frames``.  ``dataset_T_wc1``: the dataset
    calibration's root -> camera 1 transform when GT lives in another frame
    than the model's calibration.  ``fused``: ``infer_fused`` a frame
    (reports t_e2e_ms instead of t_pp / t_3D).  ``stream > 0`` (implies
    fused): ``infer_stream`` with that many frames in flight; t_e2e_ms is
    then wall-clock per frame.  ``dedup_gt``: drop duplicated GT rows
    first (``dedup_ground_truth``).  A rig with one matching camera takes
    the staged path's bypass whatever ``fused`` says."""
    acc = PoseEvalAccumulator(rig_config.used_joints)
    timing = TimingAccumulator()
    model_T_c1w = (np.asarray(pipeline.rig.T_cw[1])
                   if pipeline.rig.n_cameras > 1 else np.eye(4))

    def keep(gt):
        if dedup_gt:
            gt = dedup_ground_truth(gt)
        gt3d = gt.gt3d
        if dataset_T_wc1 is not None:
            gt3d = transform_gt_to_world(gt3d, dataset_T_wc1, model_T_c1w)
        return gt3d, gt

    selected = []            # (FrameArrays, gt3d, gt)
    if isinstance(frames, tuple):
        for i, (fa, gt) in enumerate(zip(*frames)):
            if i % datastep == 0 and gt is not None:
                selected.append((fa, *keep(gt)))
    else:
        for i, frame in enumerate(frames):
            if i % datastep != 0:
                continue
            gt = parse_frame_gt(frame, rig_config)
            if gt is not None:
                selected.append((parse_frame(frame, rig_config,
                                             max_skeletons), *keep(gt)))
    n_frames = len(selected)
    several = len(pipeline.match_idx) > 1

    if stream > 0 and several:
        t0 = time.perf_counter()
        outs = list(pipeline.infer_stream((fa for fa, _, _ in selected),
                                          depth=stream))
        wall = time.perf_counter() - t0
        for (_, gt3d, gt), out_f in zip(selected, outs):
            acc.update(gt3d, gt.gt_valid, gt.person_valid, out_f.poses)
        out = acc.summary()
        out["t_e2e_ms"] = wall / max(n_frames, 1) * 1e3
        out["stream_depth"] = stream
        out["n_frames"] = n_frames
        return out

    for fa, gt3d, gt in selected:
        if fused and several:
            with timing.span("t_e2e", 1):
                poses = pipeline.infer_fused(fa).poses
        else:
            with timing.span("t_pp", 1):
                if not several:
                    persons = single_camera_bypass(
                        fa.present[np.asarray(pipeline.match_idx)])
                else:
                    persons = _staged_persons(fa, pipeline, rig_config)
            with timing.span("t_3D", max(len(persons), 1)):
                poses = pipeline.lift(fa, persons)
        acc.update(gt3d, gt.gt_valid, gt.person_valid, poses)
    out = acc.summary()
    if fused:
        out["t_e2e_ms"] = timing.mean_ms("t_e2e")
    else:
        out["t_pp_ms"] = timing.mean_ms("t_pp")
        out["t_3Dg_ms"] = timing.mean_ms("t_3D")
        out["t_3Di_ms"] = timing.mean_per_person_ms("t_3D")
    out["n_frames"] = n_frames
    return out


# ---------------------------------------------------------------------------
# matching-quality metrics
# ---------------------------------------------------------------------------


def _gt_clusters_from_frame(frame: Dict, rig_config: RigConfig,
                            max_skeletons: int,
                            dist_per_joint: float = 1.0) -> Optional[Dict]:
    """{(matching camera index, slot): GT person label} by the reference's
    greedy proximity clustering of the per-camera GT lists (sm_metrics.py:
    113-161): cameras in file order, used cameras only; each GT entry joins
    the existing person with the smallest total distance over shared joint
    keys (the '-1' body centre included), unless it shares no key or its
    per-joint mean exceeds ``dist_per_joint`` (wire cm), then it starts a
    new person.  None when an entry lacks the '-1' marker (the reference
    skips the frame, :163)."""
    used = rig_config.used_cameras
    match_cams = list(rig_config.used_cameras_skeleton_matching)
    persons: List[Dict[str, np.ndarray]] = []   # joint id -> cm coords
    labels = {}
    for cam in frame:
        if cam not in used:
            continue
        entry = frame[cam]
        if len(entry) < 4:
            continue
        mi = match_cams.index(cam) if cam in match_cams else -1
        for slot, joints in enumerate(entry[3]):
            if "-1" not in joints:
                return None
            best, min_d, n_best = -1, np.inf, 0
            for pid, ref in enumerate(persons):
                d, n = 0.0, 0
                for j, p in ref.items():
                    if j in joints:
                        d += float(np.linalg.norm(
                            np.asarray(joints[j], np.float64) - p))
                        n += 1
                if d < min_d:           # min total distance first, the
                    best, min_d, n_best = pid, d, n   # cut after
            if n_best == 0 or min_d / n_best > dist_per_joint:
                persons.append({j: np.asarray(v, np.float64)
                                for j, v in joints.items()})
                best = len(persons) - 1
            if mi >= 0 and slot < max_skeletons:
                labels[(mi, slot)] = best
    return labels


def _head_to_person(persons) -> Dict:
    """{(matching camera index, slot): person index} of decoded persons."""
    out = {}
    for pi, person in enumerate(persons):
        for mi, s in enumerate(person):
            if s >= 0:
                out[(mi, s)] = pi
    return out


def _mean_report(sums: Dict[str, float], n: int, count_key: str) -> Dict:
    if n == 0:
        return {k: float("nan") for k in sums} | {count_key: 0}
    return {k: v / n for k, v in sums.items()} | {count_key: n}


def run_sm_metrics(frames: List[Dict], rig_config: RigConfig,
                   pipeline: PoseEstimationPipeline, datastep: int = 12,
                   max_skeletons: int = 10,
                   unassigned: str = "lump") -> Dict:
    """Matching quality against GT (reference sm_metrics.py:92-229): ARI,
    homogeneity, completeness and V-measure a frame, averaged.

    ``unassigned``: the label of heads the decode left unassigned.
    "lump" (the reference protocol, sm_metrics.py:211-218): one shared
    label ``len(persons)``; "singleton": a label of its own each."""
    if unassigned not in ("lump", "singleton"):
        raise ValueError(f"unassigned must be 'lump' or 'singleton', "
                         f"got {unassigned!r}")
    sums = dict.fromkeys(_CLUSTER_KEYS, 0.0)
    n = 0
    mi_idx = np.asarray(pipeline.match_idx)
    for i, frame in enumerate(frames):
        if i % datastep != 0:
            continue
        gt_labels = _gt_clusters_from_frame(frame, rig_config, max_skeletons)
        if not gt_labels:
            continue
        fa = parse_frame(frame, rig_config, max_skeletons)
        S = pipeline._match_slots(fa)
        persons = _staged_persons(fa, pipeline, rig_config)
        head_to_person = _head_to_person(persons)
        true_l, pred_l = [], []
        next_singleton = len(persons)
        for (mi, s), gl in sorted(gt_labels.items()):
            if s >= S or not fa.present[mi_idx[mi], s]:
                continue
            true_l.append(gl)
            p = head_to_person.get((mi, s))
            if p is None:
                p = next_singleton
                if unassigned == "singleton":
                    next_singleton += 1
            pred_l.append(p)
        if not true_l:
            continue
        rep = clustering_report(true_l, pred_l)
        for k in sums:
            sums[k] += rep[k]
        n += 1
    return _mean_report(sums, n, "n_frames")


def _scene_scores(pipeline: PoseEstimationPipeline, scenes, S: int,
                  chunk: int = 256):
    """Matcher scores and pair masks [N, E] of composite scenes (matching
    cameras' buffers [N, C_match, S, ...]): each scene through the bucket's
    matcher form on the pipeline's device, one download a chunk."""
    C, J = pipeline.rig_config.n_cameras, pipeline.rig_config.n_joints
    mi = np.asarray(pipeline.match_idx)
    all_scores, all_pm = [], []
    with torch.inference_mode(), pipeline._on_device():
        for c0 in range(0, len(scenes), chunk):
            sc = scenes.select(slice(c0, c0 + chunk))
            n = len(sc)
            full = []
            for a, shape, dt in (
                    (sc.kp, (n, C, S, J, 2), np.float32),
                    (sc.valid, (n, C, S, J), np.float32),
                    (sc.prob, (n, C, S, J), np.float32),
                    (sc.observed, (n, C, S, J), np.bool_),
                    (sc.present, (n, C, S), np.bool_)):
                buf = np.zeros(shape, dt)
                buf[:, mi] = a
                full.append(torch.as_tensor(buf, device=pipeline.device))
            outs = [pipeline._match_scores(S, *(t[k] for t in full))[:2]
                    for k in range(n)]
            all_scores.append(torch.stack([o[0] for o in outs]).cpu())
            all_pm.append(torch.stack([o[1] for o in outs]).cpu())
    if not all_scores:
        return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    return (torch.cat(all_scores).numpy(),
            torch.cat(all_pm).float().numpy())


def run_sm_metrics_without_gt(inputs: List[List[Dict]],
                              rig_config: RigConfig,
                              pipeline: PoseEstimationPipeline,
                              limit: int = 1000, seed: int = 0) -> Dict:
    """GT-free matcher evaluation (reference sm_metrics_without_gt.py:
    101-167): single-person recordings composited into scenes whose labels
    are known by construction (``build_matcher_scenes``), decoded once from
    the matcher's scores and once from the labels; the two clusterings
    compared."""
    S = pipeline.slot_buckets[-1]
    topo = pipeline.topology(S)
    scenes = build_matcher_scenes(inputs, rig_config, topo, limit=limit,
                                  seed=seed, augment=False)
    sums = dict.fromkeys(_CLUSTER_KEYS, 0.0)
    n = 0
    scores_all, pm_all = _scene_scores(pipeline, scenes, S)
    for k in range(len(scenes)):
        sc = scenes.select(k)
        persons_model = decode_person_proposals(
            scores_all[k], pm_all[k], topo,
            rig_config.min_number_of_views, pipeline.threshold)
        persons_label = decode_person_proposals(
            sc.labels, (sc.pair_weight > 0).astype(np.float32), topo,
            rig_config.min_number_of_views, pipeline.threshold)
        lm = _head_to_person(persons_model)
        ll = _head_to_person(persons_label)
        true_l, pred_l = [], []
        for mi in range(topo.n_cameras):
            for s in range(S):
                if sc.present[mi, s]:
                    true_l.append(ll.get((mi, s), len(persons_label)))
                    pred_l.append(lm.get((mi, s), len(persons_model)))
        if not true_l:
            continue
        rep = clustering_report(true_l, pred_l)
        for key in sums:
            sums[key] += rep[key]
        n += 1
    return _mean_report(sums, n, "n_scenes")


def run_reprojection_error(frames, rig_config: RigConfig,
                           pipeline: PoseEstimationPipeline,
                           tri_pipeline: Optional[
                               PoseEstimationPipeline] = None,
                           datastep: int = 1, max_skeletons: int = 10,
                           show_gt: bool = False) -> Dict:
    """Per-camera reprojection pixel error of the estimated 3D poses
    (reference reprojection_error.py:160-431), for rigs without 3D GT:
    the staged path's poses, and ``tri_pipeline``'s on the same persons.
    ``frames``: wire dicts or a ``load_eval_frames`` tuple.  ``show_gt``
    also reprojects the GT poses where frames carry them (reference
    :384-419), each matched to a proposal by the best permutation of mean
    joint distance."""
    C = rig_config.n_cameras
    errs_mlp: List[List[float]] = [[] for _ in range(C)]
    errs_tri: List[List[float]] = [[] for _ in range(C)]
    errs_gt: List[List[float]] = [[] for _ in range(C)]
    n = 0
    tupled = isinstance(frames, tuple)
    count = len(frames[0]) if tupled else len(frames)
    for i in range(0, count, datastep):
        if tupled:
            fa, gt = frames[0][i], frames[1][i]
        else:
            fa = parse_frame(frames[i], rig_config, max_skeletons)
            gt = parse_frame_gt(frames[i], rig_config) if show_gt else None
        out = pipeline(fa)
        if len(out.persons) == 0:
            continue
        n += 1
        kp, _, _, observed = pipeline.gather_person_obs(fa, out.persons)
        for errs, pl in ((errs_mlp, pipeline), (errs_tri, tri_pipeline)):
            if pl is None:
                continue
            poses = out.poses if pl is pipeline else pl.lift(fa,
                                                              out.persons)
            pe = reprojection_pixel_errors(poses, kp, observed, pl.used_rig)
            for c in range(len(pe)):
                errs[c].extend(pe[c])
        if show_gt and gt is not None and len(gt.gt3d):
            poses = out.poses
            perm = best_permutation(pose_error_table(
                gt.gt3d, gt.gt_valid, poses, rig_config.used_joints))
            gt_per_person = np.zeros_like(poses)
            have = np.zeros(len(poses), bool)
            for g, r in enumerate(perm):
                if r < len(poses):
                    gt_per_person[r] = gt.gt3d[g]
                    have[r] = True
            pe = reprojection_pixel_errors(gt_per_person[have], kp[have],
                                           observed[have], pipeline.used_rig)
            for c in range(len(pe)):
                errs_gt[c].extend(pe[c])
    res = {"mlp": per_camera_stats(errs_mlp), "n_frames": n,
           "cameras": list(rig_config.used_cameras)}
    if tri_pipeline is not None:
        res["triangulation"] = per_camera_stats(errs_tri)
    if show_gt:
        res["gt"] = per_camera_stats(errs_gt)
    return res
