"""Frame wire-format parsing into fixed-shape masked numpy buffers.

Port of ``mpe3d_tpu/data/frames.py`` (``FrameArrays``, the python
``parse_frame``, ``load_frames``, ``parse_frames_batch`` and
``parse_frames_file`` through the port's C++ parser, ``skeleton_dict``,
``frame_entry``).  A wire frame is
``{camera_name: [skeletons_json_str, timestamp, 'no_image', gt_3d_list?]}``;
each skeleton maps joint-id string -> ``[id, x_pix, y_pix, valid, prob]``
and may carry an ``"ID"`` key, which is skipped.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Sequence

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


def load_frames(path: str) -> List[Dict]:
    """A wire-format JSON file (a list of frames) as python objects."""
    with open(path, "rb") as f:
        return json.loads(f.read())


def parse_frames_batch(text: bytes, rig: RigConfig, max_skeletons: int = 10,
                       cameras: Optional[Sequence[str]] = None,
                       use_native: bool = True,
                       with_gt: bool = False) -> List[FrameArrays]:
    """A whole wire JSON payload (a list of frames) as FrameArrays, through
    the C++ parser (``mpe3d_tpu_torch/native``) when it is available and
    reads the payload, else through ``json.loads`` and ``parse_frame``
    (which raise on malformed input).  ``with_gt=True`` (the frames' 3D
    ground truth) belongs to the evaluation slice (ROADMAP.md section 1,
    item 7) and raises."""
    if with_gt:
        raise NotImplementedError(
            "parse_frames_batch(with_gt=True): ground truth is parsed by the "
            "evaluation slice, not ported yet (ROADMAP.md section 1, item 7)")
    cameras = tuple(cameras) if cameras is not None else rig.camera_names
    if use_native:
        from mpe3d_tpu_torch.native import parse_frames_native
        out = parse_frames_native(text, cameras, max_skeletons, rig.n_joints)
        if out is not None:
            kp, valid, prob, in_view, present, ts = out
            return [FrameArrays(kp[f], valid[f], prob[f], in_view[f],
                                present[f], ts[f]) for f in range(len(kp))]
    return [parse_frame(f, rig, max_skeletons, cameras)
            for f in json.loads(text)]


def parse_frames_file(path: str, rig: RigConfig, max_skeletons: int = 10,
                      cameras: Optional[Sequence[str]] = None,
                      use_native: bool = True,
                      with_gt: bool = False) -> List[FrameArrays]:
    """``parse_frames_batch`` of a file's bytes."""
    with open(path, "rb") as f:
        return parse_frames_batch(f.read(), rig, max_skeletons, cameras,
                                  use_native, with_gt=with_gt)


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
