"""Frame wire-format parsing into fixed-shape masked numpy buffers.

Port of ``mpe3d_tpu/data/frames.py`` (``FrameArrays``, the python
``parse_frame``, ``load_frames``, ``parse_frames_batch`` and
``parse_frames_file`` through the port's C++ parser, ``skeleton_dict``,
``frame_entry``), with the frames' 3D ground truth (``FrameGroundTruth``
:49, ``dedup_ground_truth`` :62, ``parse_frame_gt`` :137,
``parse_frames_batch(with_gt=True)`` :167, ``load_eval_frames`` :248) and
``merge_frame_files`` (:265).  A wire frame is
``{camera_name: [skeletons_json_str, timestamp, 'no_image', gt_3d_list?]}``;
each skeleton maps joint-id string -> ``[id, x_pix, y_pix, valid, prob]``
and may carry an ``"ID"`` key, which is skipped.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from mpe3d_tpu_torch.config import RigConfig


class FrameArrays(NamedTuple):
    """One frame as dense masked buffers: C cameras (rig order), S skeleton
    slots per camera, J joints."""

    kp: np.ndarray         # [C, S, J, 2] raw pixel coords
    valid: np.ndarray      # [C, S, J] the wire 'valid' flag
    prob: np.ndarray       # [C, S, J] detector confidence
    in_view: np.ndarray    # [C, S, J] bool: joint key present in the dict
    present: np.ndarray    # [C, S] bool: skeleton slot occupied
    timestamp: np.ndarray  # [C] float seconds (0 where absent)


class FrameGroundTruth(NamedTuple):
    """A frame's 3D ground truth (test files only), in the dataset's frame
    in metres (the wire stores cm)."""

    gt3d: np.ndarray          # [P, J, 3]
    gt_valid: np.ndarray      # [P, J] joint present in the GT dict
    person_valid: np.ndarray  # [P] bool: the '-1' marker is present
    camera: str               # the camera whose GT list was used


def dedup_ground_truth(gt: FrameGroundTruth) -> FrameGroundTruth:
    """Drop duplicated GT rows, file order kept, first occurrence wins.  A
    ghost detection repeats its source person's GT entry on the wire, and
    a repeated row can never be matched twice (opt-in:
    ``run_pose_metrics(dedup_gt=True)``, ``--dedup-gt``)."""
    key = np.round(gt.gt3d.reshape(len(gt.gt3d), -1), 6)
    _, idx = np.unique(key, axis=0, return_index=True)
    idx = np.sort(idx)
    if len(idx) == len(gt.gt3d):
        return gt
    return FrameGroundTruth(gt.gt3d[idx], gt.gt_valid[idx],
                            gt.person_valid[idx], gt.camera)


def parse_frame(frame: Dict, rig: RigConfig, max_skeletons: int = 10,
                cameras: Optional[Sequence[str]] = None) -> FrameArrays:
    """Parse one wire frame.  Skeletons beyond ``max_skeletons`` are
    dropped; a skeleton with zero listed joints gets no slot (reference
    skeleton_matching/graph_generator.py:590-591)."""
    cameras = tuple(cameras) if cameras is not None else rig.camera_names
    C, S, J = len(cameras), max_skeletons, rig.n_joints
    kp = np.zeros((C, S, J, 2), np.float32)
    valid = np.zeros((C, S, J), np.float32)
    prob = np.zeros((C, S, J), np.float32)
    in_view = np.zeros((C, S, J), bool)
    present = np.zeros((C, S), bool)
    ts = np.zeros((C,), np.float64)

    for ci, cam in enumerate(cameras):
        if cam not in frame:
            continue
        entry = frame[cam]
        skeletons = entry[0]
        if isinstance(skeletons, str):
            skeletons = json.loads(skeletons)
        if len(entry) > 1 and isinstance(entry[1], (int, float)):
            ts[ci] = entry[1]
        slot = 0
        for skeleton in skeletons:
            if slot >= S:
                break
            n = 0
            for j_key, values in skeleton.items():
                if j_key == "ID":
                    continue
                j = int(j_key)
                if j >= J:
                    continue
                kp[ci, slot, j] = (values[1], values[2])
                valid[ci, slot, j] = values[3]
                prob[ci, slot, j] = values[4]
                in_view[ci, slot, j] = True
                n += 1
            if n > 0:
                present[ci, slot] = True
                slot += 1
    return FrameArrays(kp, valid, prob, in_view, present, ts)


def parse_frame_gt(frame: Dict, rig: RigConfig
                   ) -> Optional[FrameGroundTruth]:
    """The frame's 3D ground truth from the camera with the most GT entries
    (the first such in file order; reference
    test/metrics_from_model.py:128-140); None without GT."""
    best_cam, best = None, []
    for cam, entry in frame.items():
        if len(entry) >= 4 and isinstance(entry[3], list):
            if best_cam is None or len(entry[3]) > len(best):
                best_cam, best = cam, entry[3]
    if best_cam is None or len(best) == 0:
        return None
    P, J = len(best), rig.n_joints
    gt = np.zeros((P, J, 3), np.float32)
    gt_valid = np.zeros((P, J), bool)
    person_valid = np.zeros((P,), bool)
    for p, joints in enumerate(best):
        person_valid[p] = "-1" in joints
        for j_key, xyz in joints.items():
            j = int(j_key)
            if 0 <= j < J:
                gt[p, j] = np.asarray(xyz, np.float32)[:3] / 100.0  # cm -> m
                gt_valid[p, j] = True
    return FrameGroundTruth(gt, gt_valid, person_valid, best_cam)


def _native_ground_truth(out, cameras) -> List[Optional[FrameGroundTruth]]:
    """Each frame's ground truth from the C++ parser's GT buffers: the
    first rig camera in file order with the strictly largest GT list, as
    ``parse_frame_gt`` picks it (a camera outside the rig is not a
    candidate)."""
    gt, gt_valid, gt_pvalid, gt_count, gt_order = out[6:]
    gts: List[Optional[FrameGroundTruth]] = []
    for f in range(len(gt)):
        counts = gt_count[f]
        in_order = sorted((int(gt_order[f, ci]), ci)
                          for ci in range(len(cameras))
                          if counts[ci] >= 0 and gt_order[f, ci] >= 0)
        best_ci, best_n = -1, -1
        for _, ci in in_order:
            if counts[ci] > best_n:
                best_ci, best_n = ci, int(counts[ci])
        if best_ci < 0 or best_n == 0:
            gts.append(None)
            continue
        P = min(best_n, gt.shape[2])
        gts.append(FrameGroundTruth(gt[f, best_ci, :P] / 100.0,  # cm -> m
                                    gt_valid[f, best_ci, :P],
                                    gt_pvalid[f, best_ci, :P],
                                    cameras[best_ci]))
    return gts


def load_frames(path: str) -> List[Dict]:
    """A wire-format JSON file (a list of frames) as python objects."""
    with open(path, "rb") as f:
        return json.loads(f.read())


def parse_frames_batch(text: bytes, rig: RigConfig, max_skeletons: int = 10,
                       cameras: Optional[Sequence[str]] = None,
                       use_native: bool = True,
                       with_gt: bool = False):
    """A whole wire JSON payload (a list of frames) as FrameArrays, through
    the C++ parser (``mpe3d_tpu_torch/native``) when it is available and
    reads the payload, else through ``json.loads`` and ``parse_frame``
    (which raise on malformed input).  ``with_gt=True`` returns (frames,
    ground truths), a ``FrameGroundTruth`` or None a frame."""
    cameras = tuple(cameras) if cameras is not None else rig.camera_names
    if use_native:
        from mpe3d_tpu_torch.native import parse_frames_native
        out = parse_frames_native(text, cameras, max_skeletons, rig.n_joints,
                                  with_gt=with_gt)
        if out is not None and with_gt:
            # gt_count counts past the storage cap: where a frame's GT list
            # overflows it, parse again with an exact cap (no truncation)
            max_count = int(out[9].max(initial=0))
            if max_count > out[6].shape[2]:
                out = parse_frames_native(text, cameras, max_skeletons,
                                          rig.n_joints, with_gt=True,
                                          max_gt_persons=max_count)
        if out is not None:
            kp, valid, prob, in_view, present, ts = out[:6]
            fas = [FrameArrays(kp[f], valid[f], prob[f], in_view[f],
                               present[f], ts[f]) for f in range(len(kp))]
            return (fas, _native_ground_truth(out, cameras)) if with_gt \
                else fas
    frames = json.loads(text)
    fas = [parse_frame(f, rig, max_skeletons, cameras) for f in frames]
    if not with_gt:
        return fas
    return fas, [parse_frame_gt(f, rig) for f in frames]


def parse_frames_file(path: str, rig: RigConfig, max_skeletons: int = 10,
                      cameras: Optional[Sequence[str]] = None,
                      use_native: bool = True,
                      with_gt: bool = False):
    """``parse_frames_batch`` of a file's bytes."""
    with open(path, "rb") as f:
        return parse_frames_batch(f.read(), rig, max_skeletons, cameras,
                                  use_native, with_gt=with_gt)


def load_eval_frames(paths: Sequence[str], rig: RigConfig,
                     max_skeletons: int = 10, use_native: bool = True
                     ) -> Tuple[List[FrameArrays],
                                List[Optional[FrameGroundTruth]]]:
    """Wire files as (FrameArrays, ground truths), one parse a file: the
    evaluation runners' loading path."""
    fas: List[FrameArrays] = []
    gts: List[Optional[FrameGroundTruth]] = []
    for p in paths:
        fa, gt = parse_frames_file(p, rig, max_skeletons,
                                   use_native=use_native, with_gt=True)
        fas.extend(fa)
        gts.extend(gt)
    return fas, gts


def merge_frame_files(paths: Sequence[str], out_path: str) -> int:
    """Concatenate wire files into one (the reference's
    utils/merge_jsons.py); returns the frame count."""
    merged: List[Dict] = []
    for p in paths:
        merged.extend(load_frames(p))
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return len(merged)


def skeleton_dict(joint_ids: Sequence[int], pix: np.ndarray,
                  prob: Optional[np.ndarray] = None) -> Dict[str, list]:
    """One wire skeleton dict: joint-id str -> [id, x, y, valid, prob]."""
    out = {}
    for idx, j in enumerate(joint_ids):
        p = 1.0 if prob is None else float(prob[idx])
        out[str(int(j))] = [float(j), float(pix[idx, 0]), float(pix[idx, 1]),
                            1, p]
    return out


def frame_entry(skeletons: List[Dict], timestamp: float,
                gt3d: Optional[List[Dict]] = None) -> list:
    """One camera's frame entry [skeletons_json, ts, 'no_image', gt?]."""
    entry = [json.dumps(skeletons), timestamp, "no_image"]
    if gt3d is not None:
        entry.append(gt3d)
    return entry
