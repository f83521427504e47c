"""Synthetic multi-camera scenes in the wire format, with numpy alone.

Port of ``mpe3d_tpu/data/synthetic.py``: ``generate_frames`` (:312),
``synthetic_ring_rig`` (:419) and what they call, unchanged in arithmetic
and in the order random numbers are drawn, so the same seed gives the same
frames as the JAX package.  Random 3D people from a COCO-18 template
(BODY_25 people derived from it, ``_body25_from_coco`` :229) are projected
through the rig with the full distortion model, plus detector-like pixel
noise, joint dropout and spurious detections.  The ring rig takes world-up
from the rig's "Z" axis entry (PANOPTIC: (1, -1), ARPLAB: (2, -1)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.data.frames import frame_entry, skeleton_dict
from mpe3d_tpu_torch.geometry.camera import (CameraRig,
                                             intrinsics_from_rig_config,
                                             make_rig)

# COCO-18 template, person-local frame: up = +z, lateral = x, metres.
# index:      0     1      2      3      4      5     6     7     8
#             nose  leye   reye   lear   rear   lsho  rsho  lelb  relb
#             9     10     11     12     13     14    15    16    17
#             lwri  rwri   lhip   rhip   lkne   rkne  lank  rank  neck
_TEMPLATE = np.array([
    [0.00, 0.08, 1.62],    # nose
    [0.03, 0.09, 1.65],    # left eye
    [-0.03, 0.09, 1.65],   # right eye
    [0.07, 0.03, 1.63],    # left ear
    [-0.07, 0.03, 1.63],   # right ear
    [0.19, 0.00, 1.45],    # left shoulder
    [-0.19, 0.00, 1.45],   # right shoulder
    [0.25, 0.03, 1.19],    # left elbow
    [-0.25, 0.03, 1.19],   # right elbow
    [0.27, 0.08, 0.94],    # left wrist
    [-0.27, 0.08, 0.94],   # right wrist
    [0.11, 0.00, 0.95],    # left hip
    [-0.11, 0.00, 0.95],   # right hip
    [0.12, 0.02, 0.52],    # left knee
    [-0.12, 0.02, 0.52],   # right knee
    [0.13, 0.00, 0.08],    # left ankle
    [-0.13, 0.00, 0.08],   # right ankle
    [0.00, 0.00, 1.50],    # neck
], np.float32)


@dataclass
class SceneNoise:
    """Detector noise model."""

    pixel_sigma: float = 1.5
    joint_dropout: float = 0.06
    spurious_rate: float = 0.15     # per (person, camera) chance of a ghost
    camera_dropout: float = 0.05    # per (person, camera) chance of no view
    pose_jitter: float = 0.02       # per-joint 3D jitter (m)
    # heavy-tailed detector failures: with this per-(joint, camera)
    # probability the detection lands U(10, outlier_px) pixels away in a
    # random direction while KEEPING valid=1 and full confidence —
    # the confident-but-wrong regime (limb swaps, occlusion snaps) real 2D
    # detectors exhibit and pure-Gaussian noise does not model.
    outlier_rate: float = 0.0
    outlier_px: float = 40.0


def up_axis(rig_config: RigConfig) -> Tuple[int, float]:
    """World 'up' from the rig's drawing axis map: display Z = sign·coord[idx]
    (reference: parameters.py:77)."""
    for label, (idx, sign) in rig_config.axes_3d:
        if label == "Z":
            return idx, float(sign)
    return 2, 1.0


def _up_rotation(rig_config: RigConfig) -> np.ndarray:
    """Rotation taking the person-local frame (up=+z) into the world frame."""
    idx, sign = up_axis(rig_config)
    up = np.zeros(3)
    up[idx] = sign
    # choose any orthonormal completion
    a = np.array([1.0, 0.0, 0.0]) if abs(up[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = a - np.dot(a, up) * up
    x /= np.linalg.norm(x)
    y = np.cross(up, x)
    return np.stack([x, y, up], axis=1).astype(np.float32)  # columns = local axes


def scene_center(rig: CameraRig) -> np.ndarray:
    """Least-squares intersection of the cameras' optical axes — a robust
    'where the action is' point for arbitrary rigs."""
    T_cw = np.asarray(rig.T_cw, np.float64)
    centers = T_cw[:, :3, 3]
    fwd = T_cw[:, :3, 2]  # camera z-axis in world
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, f in zip(centers, fwd):
        P = np.eye(3) - np.outer(f, f)
        A += P
        b += P @ o
    return np.linalg.solve(A, b).astype(np.float32)


def _project_np(pts_w: np.ndarray, T_wc: np.ndarray, K: np.ndarray,
                dist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """numpy mirror of geometry.camera.project_points (full distortion).
    Returns (pixels [N,2], depth [N])."""
    pc = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    z = pc[:, 2]
    xy = pc[:, :2] / np.maximum(z[:, None], 1e-9)
    k1, k2, p1, p2, k3 = dist
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    f = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * f + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yt = y * f + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = xt * K[0, 0] + K[0, 2]
    v = yt * K[1, 1] + K[1, 2]
    return np.stack([u, v], -1), z


# kinematic chains in the local frame (x lateral, y forward, z up)
_CHAINS = {
    "l_arm": (5, (7, 9)),     # pivot shoulder -> (elbow, wrist)
    "r_arm": (6, (8, 10)),
    "l_leg": (11, (13, 15)),  # pivot hip -> (knee, ankle)
    "r_leg": (12, (14, 16)),
}
_ANKLES = (15, 16)


def _rx(a: float) -> np.ndarray:
    """Rotation about the local x (lateral) axis; +a swings a downward limb
    forward (+y)."""
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rotate_chain(pts: np.ndarray, pivot: int, chain: Sequence[int],
                  R: np.ndarray) -> None:
    p = pts[pivot]
    for j in chain:
        pts[j] = p + R @ (pts[j] - p)


def sample_pose(rng: np.random.Generator) -> np.ndarray:
    """Articulated COCO-18 pose in the person-local frame (up = +z).

    The reference trains on real recordings with natural pose variety
    (walking, sitting, gesturing people — README.md:56-66); a single standing
    template makes every synthetic person near-identical, which both caps
    matcher difficulty (overlapping clones are maximally ambiguous) and
    narrows the lifter's training distribution.  Styles: stand / walk / sit /
    reach, each a continuous family via random joint angles.
    """
    pts = _TEMPLATE.copy()
    style = rng.choice(4, p=[0.3, 0.35, 0.15, 0.2])
    if style == 1:          # walk: opposite leg stride + counter arm swing
        th = float(rng.uniform(0.15, 0.55)) * (1 if rng.random() < 0.5 else -1)
        _rotate_chain(pts, _CHAINS["l_leg"][0], _CHAINS["l_leg"][1], _rx(th))
        _rotate_chain(pts, _CHAINS["r_leg"][0], _CHAINS["r_leg"][1], _rx(-th))
        # back-leg knee bend (shank folds backwards)
        back = "l_leg" if th < 0 else "r_leg"
        knee, ankle = _CHAINS[back][1]
        _rotate_chain(pts, knee, (ankle,), _rx(-float(rng.uniform(0.2, 0.6))))
        _rotate_chain(pts, _CHAINS["l_arm"][0], _CHAINS["l_arm"][1],
                      _rx(-0.7 * th))
        _rotate_chain(pts, _CHAINS["r_arm"][0], _CHAINS["r_arm"][1],
                      _rx(0.7 * th))
    elif style == 2:        # sit: thighs forward ~horizontal, shanks down
        a = float(rng.uniform(1.25, 1.55))
        for leg in ("l_leg", "r_leg"):
            hip, (knee, ankle) = _CHAINS[leg]
            _rotate_chain(pts, hip, (knee, ankle), _rx(a))
            _rotate_chain(pts, knee, (ankle,),
                          _rx(-a - float(rng.uniform(-0.15, 0.15))))
        # relaxed arms slightly forward
        for arm in ("l_arm", "r_arm"):
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(0.1, 0.5))))
    elif style == 3:        # reach: one or both arms raised overhead
        arms = ["l_arm", "r_arm"] if rng.random() < 0.3 else \
            [rng.choice(["l_arm", "r_arm"])]
        for arm in arms:
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(2.2, 3.1))))
        other = [a for a in ("l_arm", "r_arm") if a not in arms]
        for arm in other:
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(-0.3, 0.6))))
    else:                   # stand: small independent limb angles
        for limb in _CHAINS:
            pivot, chain = _CHAINS[limb]
            amp = 0.45 if "arm" in limb else 0.12
            _rotate_chain(pts, pivot, chain,
                          _rx(float(rng.uniform(-amp, amp))))
    # slight whole-torso lean (head/arms/neck about the hip line)
    torso = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 17)
    lean = _rx(float(rng.uniform(-0.08, 0.2)))
    hip_c = 0.5 * (pts[11] + pts[12])
    for j in torso:
        pts[j] = hip_c + lean @ (pts[j] - hip_c)
    # re-ground: lowest ankle back to template ankle height (sitting/striding
    # changes leg geometry; people stay floor-supported)
    pts[:, 2] -= min(pts[a, 2] for a in _ANKLES) - _TEMPLATE[_ANKLES[0], 2]
    return pts


# BODY_25 joint index -> COCO-18 source index for the directly-shared joints
# (vocabularies: reference skeleton_matching/graph_generator.py:60-74).
# BODY_25 8 (hip center) and 19-24 (foot points) are derived, not mapped.
_B25_FROM_COCO = {
    0: 0, 1: 17, 2: 6, 3: 8, 4: 10, 5: 5, 6: 7, 7: 9,
    9: 12, 10: 14, 11: 16, 12: 11, 13: 13, 14: 15,
    15: 2, 16: 1, 17: 4, 18: 3,
}


def _body25_from_coco(p18: np.ndarray) -> np.ndarray:
    """A BODY_25 skeleton from an articulated COCO-18 pose in the local
    frame (x lateral, y forward, z up): shared joints copied, the hip
    center the hips' midpoint, heel / ball / toes points around each
    ankle."""
    p25 = np.zeros((25, 3), np.float32)
    for b, c in _B25_FROM_COCO.items():
        p25[b] = p18[c]
    p25[8] = 0.5 * (p18[11] + p18[12])          # hip center
    fwd = np.array([0.0, 1.0, 0.0], np.float32)
    dz = np.array([0.0, 0.0, 1.0], np.float32)
    for ankle, (ball, toes, heel) in ((15, (19, 20, 21)),   # left foot
                                      (16, (22, 23, 24))):  # right foot
        ground = p18[ankle] - 0.06 * dz
        p25[ball] = ground + 0.10 * fwd
        p25[toes] = ground + 0.17 * fwd
        p25[heel] = ground - 0.06 * fwd
    return p25


def sample_person(rng: np.random.Generator, rig_config: RigConfig,
                  center: np.ndarray, radius: float = 1.2,
                  jitter: float = 0.02) -> np.ndarray:
    """Random posed person: articulated pose + jitter, random yaw/scale,
    placed on a disc around the scene center.  Returns world joints
    [n_joints, 3] in the rig config's joint format."""
    R_up = _up_rotation(rig_config)
    yaw = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    R_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scale = rng.uniform(0.88, 1.10)
    local = sample_pose(rng)
    if rig_config.joint_format == "BODY_25":
        local = _body25_from_coco(local)
    local = (local + rng.normal(0, jitter, local.shape)) * scale
    local = local @ R_yaw.T
    # place feet near the floor through the scene center
    offset_local = np.array([rng.uniform(-radius, radius),
                             rng.uniform(-radius, radius), 0.0], np.float32)
    idx, sign = up_axis(rig_config)
    # feet land ~0.9 below the scene center along the rig's up axis
    base = center.copy()
    return (local + offset_local) @ R_up.T + base - sign * 0.9 * np.eye(3)[idx]


def project_person(joints_w: np.ndarray, rig: CameraRig, cam_idx: int,
                   rig_config: RigConfig, rng: np.random.Generator,
                   noise: SceneNoise) -> Tuple[np.ndarray, np.ndarray]:
    """Project one person into one camera with detector noise.

    Returns (pixels [18,2], visible [18] bool)."""
    K = np.asarray(rig.K[cam_idx])
    dist = np.asarray(rig.dist[cam_idx])
    T_wc = np.asarray(rig.T_wc[cam_idx])
    pix, z = _project_np(joints_w, T_wc, K, dist)
    pix = pix + rng.normal(0, noise.pixel_sigma, pix.shape)
    if noise.outlier_rate > 0.0:
        hit = rng.random(len(pix)) < noise.outlier_rate
        n_hit = int(hit.sum())
        if n_hit:
            ang = rng.uniform(0.0, 2.0 * np.pi, n_hit)
            mag = rng.uniform(10.0, noise.outlier_px, n_hit)
            pix[hit] += np.stack([mag * np.cos(ang), mag * np.sin(ang)], -1)
    w, h = rig_config.image_width, rig_config.image_height
    visible = (z > 0.3) & (pix[:, 0] >= 0) & (pix[:, 0] < w) \
        & (pix[:, 1] >= 0) & (pix[:, 1] < h)
    visible &= rng.random(len(visible)) > noise.joint_dropout
    # behind-camera / near-focal-plane joints project to huge coordinates
    # (never visible — the in-image check above excludes them) that
    # overflow the float32 cast with a noisy RuntimeWarning; clamp first
    return np.clip(pix, -1e9, 1e9).astype(np.float32), visible


def _gt_dict(joints_w: np.ndarray, visible_any: np.ndarray) -> Dict[str, list]:
    """GT wire dict: joint-id -> [x,y,z] in *cm*, plus the '-1' validity
    marker (reference: test/metrics_from_model.py:128-174)."""
    out = {str(j): (joints_w[j] * 100.0).tolist()
           for j in range(len(joints_w)) if visible_any[j]}
    out["-1"] = [0.0, 0.0, 0.0]
    return out


def generate_frames(rig_config: RigConfig, rig: CameraRig, n_frames: int,
                    n_people: Tuple[int, int] = (1, 4), seed: int = 0,
                    noise: Optional[SceneNoise] = None,
                    with_gt: bool = True, spread=1.2,
                    min_cam_dist: float = 0.0) -> List[Dict]:
    """Multi-person wire frames (test format when with_gt=True).

    ``spread`` is the placement-disc radius in metres: 1.2 (default) packs
    people into constant overlap (hard-mode scenes); ~2.5 approximates the
    person density of typical CMU Panoptic footage.  A ``(lo, hi)`` tuple
    samples the radius uniformly per frame — use for *training* data so the
    models cover the rig's whole capture volume (a fixed-radius training
    disc makes wider scenes out-of-distribution: measured 23.5 mm at
    spread 1.2 but 289 mm at 2.5 for a spread-1.2-trained lifter).

    ``min_cam_dist > 0`` resamples people that land closer than that to any
    camera.  Near-camera people make the reference's MSE-of-summed-pixel-
    errors loss explode (huge projection sensitivity), and a handful of
    such frames dominate mean val loss so badly that early stopping breaks
    (measured: val diverging 1.4 M → 4 M while train fell, on spread ≤ 2.6
    without the guard)."""
    noise = noise or SceneNoise()
    rng = np.random.default_rng(seed)
    center = scene_center(rig)
    frames: List[Dict] = []
    joint_ids = np.arange(rig_config.n_joints)
    if isinstance(spread, (tuple, list)):
        if len(spread) != 2 or spread[0] > spread[1]:
            raise ValueError(f"spread range must be (lo, hi), got {spread!r}")
    cam_pos = np.asarray(rig.T_cw)[:, :3, 3]                    # [C, 3]

    def place(rng, r):
        # shrink the disc toward the centre if the guard can't be satisfied
        # at this radius — never silently emit a violating placement
        while True:
            for _ in range(20):
                p = sample_person(rng, rig_config, center, radius=r)
                if min_cam_dist <= 0.0:
                    return p
                d = np.linalg.norm(cam_pos - p.mean(0)[None, :],
                                   axis=1).min()
                if d >= min_cam_dist:
                    return p
            r *= 0.8
            if r < 0.05:
                return p        # guard unsatisfiable even at the centre

    for fi in range(n_frames):
        P = int(rng.integers(n_people[0], n_people[1] + 1))
        r = (float(rng.uniform(*spread)) if isinstance(spread, (tuple, list))
             else float(spread))
        people = [place(rng, r) for _ in range(P)]
        frame: Dict[str, list] = {}
        gt_dicts: List[Dict] = [_gt_dict(p, np.ones(len(p), bool))
                                for p in people]
        for ci, cam in enumerate(rig_config.camera_names):
            # per-camera GT list index-aligned with the emitted skeletons,
            # like the reference conversor's detection↔GT association
            # (get_joints_from_panoptic_model_multi.py:266-287); a ghost
            # detection carries its source person's GT entry.
            skeletons: List[Dict] = []
            gt_list: List[Dict] = []
            for pi, person in enumerate(people):
                if rng.random() < noise.camera_dropout:
                    continue
                pix, vis = project_person(person, rig, ci, rig_config, rng, noise)
                if vis.sum() < 3:
                    continue
                ids = joint_ids[vis]
                skeletons.append(skeleton_dict(ids, pix[vis]))
                gt_list.append(gt_dicts[pi])
                if rng.random() < noise.spurious_rate:
                    # ghost: shifted partial copy, fewer joints than the real
                    keep = rng.random(len(ids)) < 0.5
                    if keep.sum() >= 2 and keep.sum() < vis.sum():
                        shift = rng.uniform(-60, 60, size=2)
                        skeletons.append(
                            skeleton_dict(ids[keep], pix[vis][keep] + shift))
                        gt_list.append(gt_dicts[pi])
            frame[cam] = frame_entry(skeletons, float(fi) / 30.0,
                                     gt_list if with_gt else None)
        frames.append(frame)
    return frames


def synthetic_ring_rig(rig_config: RigConfig, radius: float = 3.5,
                       height: float = 1.6, seed: int = 7) -> CameraRig:
    """A plausible rig when no calibration fixture is available: cameras on a
    ring, looking at the origin, using the rig config's intrinsics and the
    world-up convention from its axis map."""
    rng = np.random.default_rng(seed)
    C = rig_config.n_cameras
    idx, sign = up_axis(rig_config)
    up = np.zeros(3)
    up[idx] = sign
    K, dist = intrinsics_from_rig_config(rig_config)
    T_wc = np.zeros((C, 4, 4), np.float64)
    for ci in range(C):
        ang = 2 * np.pi * ci / C + rng.normal(0, 0.05)
        # position on the ring, lifted along up
        a = np.array([1.0, 0, 0]) if abs(up[0]) < 0.9 else np.array([0.0, 1, 0])
        x_dir = a - np.dot(a, up) * up
        x_dir /= np.linalg.norm(x_dir)
        y_dir = np.cross(up, x_dir)
        pos = radius * (np.cos(ang) * x_dir + np.sin(ang) * y_dir) + height * up
        # camera looks at a point slightly above the origin
        target = 0.9 * up
        fwd = target - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_cw = np.stack([right, down, fwd], axis=1)  # columns: camera axes in world
        T_cw = np.eye(4)
        T_cw[:3, :3] = R_cw
        T_cw[:3, 3] = pos
        T_wc[ci] = np.linalg.inv(T_cw)
    return make_rig(K, dist, T_wc,
                    (rig_config.image_width, rig_config.image_height))
