"""CMU Panoptic dataset conversor: offline 2D detections in the wire format.

Port of ``mpe3d_tpu/convert/panoptic.py`` (``project_points_panoptic`` :49,
``load_calibration`` :74, ``selected_tracker_cameras`` :86,
``write_transform_set`` :94, ``Detector2D`` :118, ``project_gt_people``
:187, ``associate`` :220, ``convert_sequence`` :243), the reference's
panoptic_conversor/get_joints_from_panoptic_model{,_multi}.py:84-309::

    a frame's HD image of each camera -> resize to 960x512 -> ImageNet
    normalisation -> PoseResNet-50 heatmaps [18, 128, 240] -> peaks ->
    camera pixels; GT COCO-19 3D -> the Panoptic toolbox's projection ->
    nearest-neighbour association -> per-person skeletons -> wire JSON
    (multi: one entry a frame with all people and GT, the test format;
    single: one entry a person and frame, the training format)

``Detector2D`` runs on the tensor's device: the image uploads as uint8,
is resized there (``resize_linear``: ``cv2.resize``'s INTER_LINEAR in
integer arithmetic, bit for bit), normalised, run through the net in fp32
(TF32 off for cuDNN for the call) and the peak finder, and the counts and
coordinates come back in one download.

Image decoding is the one use of OpenCV: ``read_image_rgb`` imports
``cv2`` when it is called, and without it fails naming OpenCV.
``convert_sequence`` reads every image through the module's
``read_image_rgb``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import (BODY_CENTER, COCO19_TO_COCO18,
                                    DETECTOR_INPUT, IMAGENET_MEAN,
                                    IMAGENET_STD, PANOPTIC_HD_NODES)
from mpe3d_tpu_torch.convert.peaks import find_peaks, refine_peaks
from mpe3d_tpu_torch.convert.pose_resnet import pose_resnet
from mpe3d_tpu_torch.geometry.calib_io import (TransformSet,
                                               write_transform_set_pickle)


def project_points_panoptic(X: np.ndarray, K: np.ndarray, R: np.ndarray,
                            t: np.ndarray, Kd: np.ndarray) -> np.ndarray:
    """The Panoptic toolbox's projection (panutils.projectPoints): K with
    skew, and the toolbox's in-place aliasing kept: the y tangential term
    and K's row 1 use the already distorted x.  X: [3, N] world (cm).
    Returns [2, N] pixels."""
    x = R @ X + t.reshape(3, 1)
    x = np.asarray(x, np.float64).copy()
    x[0] /= x[2]
    x[1] /= x[2]
    r = x[0] ** 2 + x[1] ** 2
    f = 1 + Kd[0] * r + Kd[1] * r * r + Kd[4] * r ** 3
    x[0] = x[0] * f + 2 * Kd[2] * x[0] * x[1] + Kd[3] * (r + 2 * x[0] ** 2)
    x[1] = x[1] * f + 2 * Kd[3] * x[0] * x[1] + Kd[2] * (r + 2 * x[1] ** 2)
    u = K[0, 0] * x[0] + K[0, 1] * x[1] + K[0, 2]
    v = K[1, 0] * u + K[1, 1] * x[1] + K[1, 2]
    return np.stack([u, v])


def load_calibration(seq_dir: str) -> Dict[Tuple[int, int], Dict]:
    """calibration_<seq>.json -> {(panel, node): camera dict} with numpy
    K / R / t / distCoef."""
    seq = seq_dir.rstrip("/").split("/")[-1]
    with open(os.path.join(seq_dir, f"calibration_{seq}.json")) as f:
        calib = json.load(f)
    cams = {}
    for cam in calib["cameras"]:
        cam = dict(cam)
        cam["K"] = np.asarray(cam["K"], np.float64)
        cam["R"] = np.asarray(cam["R"], np.float64)
        cam["t"] = np.asarray(cam["t"], np.float64).reshape(3, 1)
        cam["distCoef"] = np.asarray(cam["distCoef"], np.float64)
        cams[(cam["panel"], cam["node"])] = cam
    return cams


def selected_tracker_cameras(cams: Dict,
                             nodes: Sequence[int] = PANOPTIC_HD_NODES
                             ) -> Dict[str, Dict]:
    """Panel-0 HD cameras -> the names trackera, trackerb, ..."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    return {f"tracker{letters[i]}": cams[(0, n)]
            for i, n in enumerate(nodes)}


def write_transform_set(selected: Dict[str, Dict], out_path: str
                        ) -> TransformSet:
    """root -> camera transforms, translation cm -> m, written as
    ``<out>.json`` and ``<out>.pickle``, the bytes the JAX conversor
    writes (its pickle names the JAX package's class; both packages'
    ``load_transform_manager`` read it)."""
    transforms = {}
    for name, cam in selected.items():
        T = np.eye(4)
        T[:3, :3] = cam["R"]
        T[:3, 3] = cam["t"][:, 0] / 100.0
        transforms[("root", name)] = T
    ts = TransformSet(transforms)
    with open(out_path + ".json", "w") as f:
        f.write(ts.to_json())
    with open(out_path + ".pickle", "wb") as f:
        write_transform_set_pickle(ts, f)
    return ts


def read_image_rgb(path: str) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB (``cv2.imread`` +
    ``cvtColor``).  OpenCV is needed for it and only for it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs OpenCV (the cv2 module), "
                          f"which is not installed") from e
    image = cv2.imread(path)
    if image is None:
        raise ValueError(f"{path}: OpenCV could not read the image")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------------
# the resize
# ---------------------------------------------------------------------------

_COEF_SCALE = 2048       # INTER_RESIZE_COEF_SCALE: 11-bit fixed point


def _linear_taps(dst: int, src: int):
    """OpenCV's INTER_LINEAR taps along one axis: [4, dst] int32 rows (i0,
    i1, w0, w1) of the output indices, the two source indices clamped to the image and their
    11-bit weights: fx = (float)((d + 0.5) * scale - 0.5), s = floor(fx),
    weights round((1 - fx') * 2048) and round(fx' * 2048) in float32 with
    fx' = fx - s.  The border's taps keep their weights and read the edge
    pixel twice, which is how ``cv2.resize`` (5.0.0) computes them."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(fx)
    fx = fx - s
    w0 = np.rint((np.float32(1.0) - fx) * np.float32(_COEF_SCALE))
    w1 = np.rint(fx * np.float32(_COEF_SCALE))
    s = s.astype(np.int64)
    return np.stack([np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
                     w0, w1]).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _resize_taps(w: int, h: int, W: int, H: int,
                 device: torch.device) -> torch.Tensor:
    """[4, W + H] taps of a (w, h) -> (W, H) resize, on ``device``: built
    and uploaded once a source shape, as a camera's images all share
    one."""
    return torch.from_numpy(np.concatenate(
        [_linear_taps(W, w), _linear_taps(H, h)], axis=1)).to(device)


def resize_linear(image: torch.Tensor, size: Tuple[int, int]
                  ) -> torch.Tensor:
    """``cv2.resize(image, size)`` (INTER_LINEAR) of an [H, W, C] uint8
    tensor, bit for bit, on its device: the horizontal pass in 11-bit
    fixed point (int32), the vertical pass as OpenCV's vector path rounds
    it, ((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2 >> 2, then
    saturated to uint8.  ``size`` is (W, H), as cv2 takes it."""
    h, w = image.shape[:2]
    W, H = size
    taps = _resize_taps(w, h, W, H, image.device)
    x0, x1, a0, a1 = taps[:, :W]
    y0, y1, b0, b1 = taps[:, W:]
    rows = image.index_select(0, torch.cat([y0, y1])).to(torch.int32)
    hz = (rows.index_select(1, x0) * a0[:, None]
          + rows.index_select(1, x1) * a1[:, None])        # [2H, W, C]
    h0, h1 = hz[:H] >> 4, hz[H:] >> 4
    out = (((h0 * b0[:, None, None]) >> 16)
           + ((h1 * b1[:, None, None]) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# 2D detection
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN convolutions in true fp32 for the block, the flag restored
    after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Detector2D:
    """Image -> per-joint peak lists, on ``device``.  ``state``: the
    PoseResNet state dict (``convert/pose_resnet.py``:
    ``load_pose_resnet_checkpoint``, ``he_normal_state``, or
    ``weights.pose_resnet_from_jax``)."""

    def __init__(self, state, cmap_threshold: float = 0.15,
                 window: int = 5, max_peaks: int = 100, device="cuda"):
        self.device = torch.device(device)
        self.net = pose_resnet(state, self.device)
        self.threshold, self.window = cmap_threshold, window
        self.max_peaks = max_peaks
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                 device=self.device)

    def heatmaps(self, image_rgb: np.ndarray) -> torch.Tensor:
        """[J, 128, 240] heatmaps (on the device) of an [H, W, 3] uint8 RGB
        image of any size."""
        img = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(
            self.device)
        img = resize_linear(img, DETECTOR_INPUT)
        x = (img.to(torch.float32) / 255.0 - self._mean) / self._std
        with torch.no_grad(), _cudnn_without_tf32():
            return self.net(x.permute(2, 0, 1)[None])[0]

    def peaks(self, cmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(counts [J], normalised (x, y) [J, K, 2]) of heatmaps, on their
        device."""
        counts, peaks = find_peaks(cmap, self.threshold, self.window,
                                   self.max_peaks)
        return counts, refine_peaks(peaks, cmap, self.window)

    def __call__(self, image_rgb: np.ndarray, resolution: Tuple[int, int]
                 ) -> Dict[int, List[List[float]]]:
        """COCO-18 joint id -> list of [x, y] in camera-resolution pixels
        (reference :248-262).  One download an image."""
        counts, norm = self.peaks(self.heatmaps(image_rgb))
        J = counts.shape[0]
        host = torch.cat([counts.to(torch.float32)[:, None],
                          norm.reshape(J, -1)], 1).cpu().numpy()
        counts = host[:, 0].astype(np.int64)
        norm = host[:, 1:].reshape(J, -1, 2)
        W, H = resolution
        out: Dict[int, List[List[float]]] = {}
        for j19, n in enumerate(counts):
            # channel j is COCO-19 joint j; the 18-channel net has no
            # channel for joint 18 (right ear), as in the reference
            if j19 == BODY_CENTER or j19 >= 19:
                continue
            j18 = COCO19_TO_COCO18.get(j19)
            if j18 is None:
                continue
            pts = [[float(norm[j19, k, 0] * W), float(norm[j19, k, 1] * H)]
                   for k in range(int(n))]
            if pts:
                out[j18] = pts
        return out


# ---------------------------------------------------------------------------
# detection <-> GT association and the wire files
# ---------------------------------------------------------------------------


def project_gt_people(bodies: List[Dict], cam: Dict,
                      conf_threshold: float = 0.1) -> Tuple[Dict, Dict]:
    """Each GT body projected into the view (reference :203-243).
    Returns (projected {person: {joint18: [id, x, y, 1, 1]}}, joints3d
    {person: {joint18 or '-1': [x, y, z] cm}})."""
    W, H = cam["resolution"]
    projected, joints3d = {}, {}
    for body in bodies:
        pid = body["id"]
        skel = np.asarray(body["joints19"], np.float64).reshape(-1, 4).T
        pts = project_points_panoptic(skel[0:3], cam["K"], cam["R"],
                                      cam["t"], cam["distCoef"]).T
        valid = skel[3] > conf_threshold
        kps, j3d = {}, {}
        for i, (x, y) in enumerate(pts):
            if not valid[i]:
                continue
            key = "-1" if i == BODY_CENTER else str(COCO19_TO_COCO18[i])
            j3d[key] = [float(skel[0, i]), float(skel[1, i]),
                        float(skel[2, i])]
            if i == BODY_CENTER or x < 0 or x >= W or y < 0 or y >= H:
                continue
            kps[int(key)] = [int(key), float(x), float(y), 1, 1]
        projected[pid] = kps
        joints3d[pid] = j3d
    return projected, joints3d


def associate(projected: Dict, detected: Dict[int, List[List[float]]],
              max_dist: float) -> Dict:
    """Nearest-neighbour association of detected peaks to projected GT
    joints (reference :266-283).  Returns {person: {joint: [id, x, y, 1,
    1]}}."""
    out = {}
    for pid, skeleton in projected.items():
        kps = {}
        for j, joint in skeleton.items():
            cands = detected.get(j)
            if not cands:
                continue
            p = np.asarray(joint[1:3])
            d = np.linalg.norm(np.asarray(cands) - p, axis=1)
            k = int(np.argmin(d))
            if d[k] < max_dist:
                kps[j] = [j, float(cands[k][0]), float(cands[k][1]), 1, 1]
        if kps:
            out[pid] = kps
    return out


def convert_sequence(seq_dir: str, detector: Detector2D,
                     nodes: Sequence[int] = PANOPTIC_HD_NODES,
                     multi: bool = True, out_dir: str = ".",
                     max_frames: Optional[int] = None) -> str:
    """A whole sequence (the reference's command-line scripts).
    multi=True -> ``<seq>_from_image_multi.json`` (a frame an entry, all
    people and GT; association within 25 px); multi=False ->
    ``<seq>_from_image_single.json`` (a person and frame an entry, no GT;
    15 px).  Also writes ``tm_<seq>.{json,pickle}``.  Camera names follow
    the ``nodes`` order, as the transform set's do; image directories of
    other nodes are skipped."""
    seq = seq_dir.rstrip("/").split("/")[-1]
    cams = load_calibration(seq_dir)
    selected = selected_tracker_cameras(cams, nodes)
    write_transform_set(selected, os.path.join(out_dir, f"tm_{seq}"))

    imgs_root = os.path.join(seq_dir, "hdImgs")
    skel_root = os.path.join(seq_dir, "hdPose3d_stage1_coco19")
    node_order = {n: i for i, n in enumerate(nodes)}
    cam_dirs = [d for d in sorted(os.listdir(imgs_root))
                if os.path.isdir(os.path.join(imgs_root, d))
                and int(d.split("_")[-1]) in node_order]
    name_of_node = {n: f"tracker{chr(ord('a') + i)}"
                    for n, i in node_order.items()}

    frames_index: Dict[str, Dict[int, str]] = {}
    for d in cam_dirs:
        node = int(d.split("_")[-1])
        for fn in sorted(os.listdir(os.path.join(imgs_root, d))):
            img_id = fn.rsplit(".", 1)[0].split("_")[-1]
            frames_index.setdefault(img_id, {})[node] = \
                os.path.join(imgs_root, d, fn)

    threshold = 25.0 if multi else 15.0
    out_frames: List[Dict] = []
    for n_done, (img_id, by_cam) in enumerate(sorted(frames_index.items())):
        if max_frames is not None and n_done >= max_frames:
            break
        skel_path = os.path.join(skel_root, f"body3DScene_{img_id}.json")
        if not os.path.exists(skel_path):
            continue
        with open(skel_path) as f:
            bodies = json.load(f)["bodies"]

        frame_entry: Dict[str, list] = {}
        per_person_frames: Dict[int, Dict[str, list]] = {}
        for node, img_path in by_cam.items():
            cam = cams[(0, node)]
            detected = detector(read_image_rgb(img_path),
                                tuple(cam["resolution"]))
            projected, joints3d = project_gt_people(bodies, cam)
            people = associate(projected, detected, threshold)
            cam_name = name_of_node[node]
            if multi:
                frame_entry[cam_name] = [
                    json.dumps(list(people.values())), time.time(),
                    "no_image", [joints3d[pid] for pid in people]]
            else:
                for pid, kps in people.items():
                    per_person_frames.setdefault(pid, {})[cam_name] = [
                        json.dumps([kps]), time.time(), "no_image"]
        if multi:
            out_frames.append(frame_entry)
        else:
            out_frames.extend(per_person_frames.values())

    suffix = "multi" if multi else "single"
    out_path = os.path.join(out_dir, f"{seq}_from_image_{suffix}.json")
    with open(out_path, "w") as f:
        json.dump(out_frames, f)
    return out_path
