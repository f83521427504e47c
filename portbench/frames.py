"""Seeded synthetic scenes as dense frame arrays, and the synthetic ring rig.

A frozen copy of the port's synthetic generator (``data/synthetic.py``:
``synthetic_ring_rig``, ``generate_frames`` and what they call), with the
same arithmetic and the same order of random draws, so a seed gives the
frames the port's generator gives.  It emits the parsed arrays directly
(what ``data/frames.py::parse_frame`` makes of the wire frame, slots past
``slots`` dropped) instead of wire JSON.  Random COCO-18 people from a
standing template with articulated limbs are projected through the rig
with the full distortion model, plus detector-like pixel noise, joint
dropout, camera dropout and spurious (ghost) detections.

Kept here so that a change to the program cannot move the traffic the
benchmark sends.  numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

# COCO-18 template, person-local frame: up = +z, lateral = x, metres.
_TEMPLATE = np.array([
    [0.00, 0.08, 1.62], [0.03, 0.09, 1.65], [-0.03, 0.09, 1.65],
    [0.07, 0.03, 1.63], [-0.07, 0.03, 1.63], [0.19, 0.00, 1.45],
    [-0.19, 0.00, 1.45], [0.25, 0.03, 1.19], [-0.25, 0.03, 1.19],
    [0.27, 0.08, 0.94], [-0.27, 0.08, 0.94], [0.11, 0.00, 0.95],
    [-0.11, 0.00, 0.95], [0.12, 0.02, 0.52], [-0.12, 0.02, 0.52],
    [0.13, 0.00, 0.08], [-0.13, 0.00, 0.08], [0.00, 0.00, 1.50],
], np.float32)

_CHAINS = {"l_arm": (5, (7, 9)), "r_arm": (6, (8, 10)),
           "l_leg": (11, (13, 15)), "r_leg": (12, (14, 16))}
_ANKLES = (15, 16)


@dataclass(frozen=True)
class Noise:
    """Detector noise model (the generator's defaults)."""

    pixel_sigma: float = 1.5
    joint_dropout: float = 0.06
    spurious_rate: float = 0.15
    camera_dropout: float = 0.05
    pose_jitter: float = 0.02


class Rig(NamedTuple):
    """A C-camera rig as numpy arrays (float32, as the port's ``make_rig``
    stores them)."""

    K: np.ndarray        # [C, 3, 3]
    K_inv: np.ndarray    # [C, 3, 3]
    T_wc: np.ndarray     # [C, 4, 4] world -> camera
    T_cw: np.ndarray     # [C, 4, 4] camera -> world
    dist: np.ndarray     # [C, 5] (k1, k2, p1, p2, k3)
    image_size: np.ndarray   # [2] (width, height)

    def select(self, idx: Sequence[int]) -> "Rig":
        idx = list(idx)
        return Rig(self.K[idx], self.K_inv[idx], self.T_wc[idx],
                   self.T_cw[idx], self.dist[idx], self.image_size)


class Frames(NamedTuple):
    """Frames as stacked arrays [F, C, S, ...] (the parsed buffers)."""

    kp: np.ndarray        # [F, C, S, J, 2] float32 raw pixels
    valid: np.ndarray     # [F, C, S, J] float32
    prob: np.ndarray      # [F, C, S, J] float32
    in_view: np.ndarray   # [F, C, S, J] bool
    present: np.ndarray   # [F, C, S] bool

    def __len__(self) -> int:
        return self.kp.shape[0]

    def take(self, idx) -> "Frames":
        return Frames(*(a[idx] for a in self))


def intrinsics(cfg: dict) -> Tuple[np.ndarray, np.ndarray]:
    """[C, 3, 3] K and [C, 5] distortion of a configuration's cameras."""
    cams = cfg["cameras"]
    C = len(cams["names"])
    K = np.zeros((C, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = cams["fx"], cams["fy"]
    K[:, 0, 2], K[:, 1, 2] = cams["cx"], cams["cy"]
    K[:, 2, 2] = 1.0
    dist = np.stack([cams["kd0"], cams["kd1"], cams["p1"], cams["p2"],
                     cams["kd2"]], axis=1)
    return K, dist.astype(np.float32)


def up_axis(cfg: dict) -> Tuple[int, float]:
    idx, sign = cfg["up_axis"]
    return int(idx), float(sign)


def ring_rig(cfg: dict, radius: float = 3.5, height: float = 1.6,
             seed: int = 7) -> Rig:
    """Cameras on a ring looking at a point above the origin, with the
    configuration's intrinsics and world-up axis."""
    rng = np.random.default_rng(seed)
    K, dist = intrinsics(cfg)
    C = K.shape[0]
    idx, sign = up_axis(cfg)
    up = np.zeros(3)
    up[idx] = sign
    T_wc = np.zeros((C, 4, 4), np.float64)
    for ci in range(C):
        ang = 2 * np.pi * ci / C + rng.normal(0, 0.05)
        a = np.array([1.0, 0, 0]) if abs(up[0]) < 0.9 else np.array([0.0, 1, 0])
        x_dir = a - np.dot(a, up) * up
        x_dir /= np.linalg.norm(x_dir)
        y_dir = np.cross(up, x_dir)
        pos = radius * (np.cos(ang) * x_dir + np.sin(ang) * y_dir) + height * up
        fwd = 0.9 * up - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T_cw = np.eye(4)
        T_cw[:3, :3] = np.stack([right, down, fwd], axis=1)
        T_cw[:3, 3] = pos
        T_wc[ci] = np.linalg.inv(T_cw)
    K = np.asarray(K, np.float32)
    T32 = T_wc.astype(np.float32)
    return Rig(K, np.linalg.inv(K).astype(np.float32), T32,
               np.linalg.inv(T32.astype(np.float64)).astype(np.float32),
               np.asarray(dist, np.float32),
               np.asarray((cfg["image_width"], cfg["image_height"]),
                          np.float32))


def _up_rotation(cfg: dict) -> np.ndarray:
    idx, sign = up_axis(cfg)
    up = np.zeros(3)
    up[idx] = sign
    a = np.array([1.0, 0.0, 0.0]) if abs(up[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = a - np.dot(a, up) * up
    x /= np.linalg.norm(x)
    y = np.cross(up, x)
    return np.stack([x, y, up], axis=1).astype(np.float32)


def scene_center(rig: Rig) -> np.ndarray:
    """Least-squares intersection of the cameras' optical axes."""
    T_cw = np.asarray(rig.T_cw, np.float64)
    A, b = np.zeros((3, 3)), np.zeros(3)
    for o, f in zip(T_cw[:, :3, 3], T_cw[:, :3, 2]):
        P = np.eye(3) - np.outer(f, f)
        A += P
        b += P @ o
    return np.linalg.solve(A, b).astype(np.float32)


def _project(pts_w, T_wc, K, dist):
    pc = pts_w @ T_wc[:3, :3].T + T_wc[:3, 3]
    z = pc[:, 2]
    xy = pc[:, :2] / np.maximum(z[:, None], 1e-9)
    k1, k2, p1, p2, k3 = dist
    x, y = xy[:, 0], xy[:, 1]
    r2 = x * x + y * y
    f = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * f + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yt = y * f + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xt * K[0, 0] + K[0, 2], yt * K[1, 1] + K[1, 2]], -1), z


def _rx(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rotate_chain(pts, pivot, chain, R) -> None:
    p = pts[pivot]
    for j in chain:
        pts[j] = p + R @ (pts[j] - p)


def sample_pose(rng: np.random.Generator) -> np.ndarray:
    """Articulated COCO-18 pose (stand / walk / sit / reach)."""
    pts = _TEMPLATE.copy()
    style = rng.choice(4, p=[0.3, 0.35, 0.15, 0.2])
    if style == 1:
        th = float(rng.uniform(0.15, 0.55)) * (1 if rng.random() < 0.5 else -1)
        _rotate_chain(pts, _CHAINS["l_leg"][0], _CHAINS["l_leg"][1], _rx(th))
        _rotate_chain(pts, _CHAINS["r_leg"][0], _CHAINS["r_leg"][1], _rx(-th))
        back = "l_leg" if th < 0 else "r_leg"
        knee, ankle = _CHAINS[back][1]
        _rotate_chain(pts, knee, (ankle,), _rx(-float(rng.uniform(0.2, 0.6))))
        _rotate_chain(pts, _CHAINS["l_arm"][0], _CHAINS["l_arm"][1],
                      _rx(-0.7 * th))
        _rotate_chain(pts, _CHAINS["r_arm"][0], _CHAINS["r_arm"][1],
                      _rx(0.7 * th))
    elif style == 2:
        a = float(rng.uniform(1.25, 1.55))
        for leg in ("l_leg", "r_leg"):
            hip, (knee, ankle) = _CHAINS[leg]
            _rotate_chain(pts, hip, (knee, ankle), _rx(a))
            _rotate_chain(pts, knee, (ankle,),
                          _rx(-a - float(rng.uniform(-0.15, 0.15))))
        for arm in ("l_arm", "r_arm"):
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(0.1, 0.5))))
    elif style == 3:
        arms = ["l_arm", "r_arm"] if rng.random() < 0.3 else \
            [rng.choice(["l_arm", "r_arm"])]
        for arm in arms:
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(2.2, 3.1))))
        for arm in [a for a in ("l_arm", "r_arm") if a not in arms]:
            _rotate_chain(pts, _CHAINS[arm][0], _CHAINS[arm][1],
                          _rx(float(rng.uniform(-0.3, 0.6))))
    else:
        for limb in _CHAINS:
            pivot, chain = _CHAINS[limb]
            amp = 0.45 if "arm" in limb else 0.12
            _rotate_chain(pts, pivot, chain,
                          _rx(float(rng.uniform(-amp, amp))))
    lean = _rx(float(rng.uniform(-0.08, 0.2)))
    hip_c = 0.5 * (pts[11] + pts[12])
    for j in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 17):
        pts[j] = hip_c + lean @ (pts[j] - hip_c)
    pts[:, 2] -= min(pts[a, 2] for a in _ANKLES) - _TEMPLATE[_ANKLES[0], 2]
    return pts


def sample_person(rng, cfg, center, radius, jitter=0.02) -> np.ndarray:
    """A posed person on a disc of ``radius`` around the scene centre:
    world joints [18, 3]."""
    R_up = _up_rotation(cfg)
    yaw = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    R_yaw = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scale = rng.uniform(0.88, 1.10)
    local = sample_pose(rng)
    local = (local + rng.normal(0, jitter, local.shape)) * scale
    local = local @ R_yaw.T
    offset = np.array([rng.uniform(-radius, radius),
                       rng.uniform(-radius, radius), 0.0], np.float32)
    idx, sign = up_axis(cfg)
    return (local + offset) @ R_up.T + center.copy() - sign * 0.9 * np.eye(3)[idx]


def _project_person(joints_w, rig, ci, cfg, rng, noise):
    pix, z = _project(joints_w, np.asarray(rig.T_wc[ci]),
                      np.asarray(rig.K[ci]), np.asarray(rig.dist[ci]))
    pix = pix + rng.normal(0, noise.pixel_sigma, pix.shape)
    w, h = cfg["image_width"], cfg["image_height"]
    visible = (z > 0.3) & (pix[:, 0] >= 0) & (pix[:, 0] < w) \
        & (pix[:, 1] >= 0) & (pix[:, 1] < h)
    visible &= rng.random(len(visible)) > noise.joint_dropout
    return np.clip(pix, -1e9, 1e9).astype(np.float32), visible


def generate(cfg: dict, rig: Rig, n_frames: int, people: Tuple[int, int],
             slots: int, seed: int, spread: float,
             noise: Noise = Noise()) -> Frames:
    """``n_frames`` scenes of people[0]..people[1] persons on a disc of
    radius ``spread`` metres, each camera's skeletons in the first
    ``slots`` slots (later ones dropped, as the parser drops them)."""
    rng = np.random.default_rng(seed)
    center = scene_center(rig)
    C, J = len(cfg["cameras"]["names"]), cfg["n_joints"]
    shape = (n_frames, C, slots, J)
    kp = np.zeros(shape + (2,), np.float32)
    valid = np.zeros(shape, np.float32)
    in_view = np.zeros(shape, bool)
    present = np.zeros((n_frames, C, slots), bool)
    joint_ids = np.arange(J)
    for fi in range(n_frames):
        P = int(rng.integers(people[0], people[1] + 1))
        persons = [sample_person(rng, cfg, center, float(spread))
                   for _ in range(P)]
        for ci in range(C):
            skeletons: List[Tuple[np.ndarray, np.ndarray]] = []
            for person in persons:
                if rng.random() < noise.camera_dropout:
                    continue
                pix, vis = _project_person(person, rig, ci, cfg, rng, noise)
                if vis.sum() < 3:
                    continue
                ids = joint_ids[vis]
                skeletons.append((ids, pix[vis].astype(np.float64)))
                if rng.random() < noise.spurious_rate:
                    keep = rng.random(len(ids)) < 0.5
                    if keep.sum() >= 2 and keep.sum() < vis.sum():
                        shift = rng.uniform(-60, 60, size=2)
                        skeletons.append((ids[keep], pix[vis][keep] + shift))
            for slot, (ids, pix) in enumerate(skeletons[:slots]):
                kp[fi, ci, slot, ids] = pix.astype(np.float32)
                valid[fi, ci, slot, ids] = 1.0
                in_view[fi, ci, slot, ids] = True
                present[fi, ci, slot] = True
    return Frames(kp, valid, valid.copy(), in_view, present)
