"""Pinhole-camera geometry on torch tensors.

Port of ``mpe3d_tpu/geometry/camera.py``: ``full_distort`` (:111, radial
and tangential), ``undistort_points`` (:133, 10 fixed-point iterations),
``project_points`` (:175), ``cam_centers_world``
(:207), ``pixel_rays_world`` (:213), ``save_rig_npz`` / ``load_rig_npz``
(:243-256).  Point-wise over the last axis,
broadcasting over leading axes, float32.  Small contractions are written as
broadcast multiply-sums, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import RigConfig


class CameraRig(NamedTuple):
    """Stacked calibration of a C-camera rig.  Fields are host numpy as
    built (``make_rig``); ``to(device)`` gives the same rig as tensors."""

    K: object           # [C, 3, 3] intrinsics
    K_inv: object       # [C, 3, 3]
    T_wc: object        # [C, 4, 4] world -> camera
    T_cw: object        # [C, 4, 4] camera -> world
    dist: object        # [C, 5] OpenCV order (k1, k2, p1, p2, k3)
    image_size: object  # [2] (width, height)

    @property
    def n_cameras(self) -> int:
        return self.K.shape[0]

    def select(self, idx) -> "CameraRig":
        """Sub-rig with cameras ``idx``."""
        idx = list(idx)
        return CameraRig(self.K[idx], self.K_inv[idx], self.T_wc[idx],
                         self.T_cw[idx], self.dist[idx], self.image_size)

    def to(self, device) -> "CameraRig":
        return CameraRig(*(torch.as_tensor(np.asarray(a, np.float32)
                                           if not torch.is_tensor(a) else a,
                                           dtype=torch.float32,
                                           device=device) for a in self))


def intrinsics_from_rig_config(rig: RigConfig) -> Tuple[np.ndarray, np.ndarray]:
    """[C, 3, 3] K matrices and [C, 5] distortion (OpenCV order)."""
    C = rig.n_cameras
    K = np.zeros((C, 3, 3), np.float32)
    K[:, 0, 0] = rig.fx
    K[:, 1, 1] = rig.fy
    K[:, 0, 2] = rig.cx
    K[:, 1, 2] = rig.cy
    K[:, 2, 2] = 1.0
    dist = np.stack([rig.kd0, rig.kd1, rig.p1, rig.p2, rig.kd2], axis=1)
    return K, dist.astype(np.float32)


def make_rig(K, dist, T_wc, image_size) -> CameraRig:
    K = np.asarray(K, np.float32)
    T_wc = np.asarray(T_wc, np.float32)
    return CameraRig(
        K=K,
        K_inv=np.linalg.inv(K).astype(np.float32),
        T_wc=T_wc,
        T_cw=np.linalg.inv(T_wc.astype(np.float64)).astype(np.float32),
        dist=np.asarray(dist, np.float32),
        image_size=np.asarray(image_size, np.float32),
    )


def radial_distort(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Radial-only distortion of normalized coords (tangential ignored, as
    the reference's training projection does)."""
    k1, k2, k3 = dist[..., 0:1], dist[..., 1:2], dist[..., 4:5]
    r2 = torch.sum(xy * xy, -1, keepdim=True)
    return xy * (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))


def full_distort(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Radial and tangential distortion of normalized coords (the OpenCV
    model of the Panoptic toolbox, reference panoptic_conversor/
    panutils.py:4-27)."""
    k1, k2, p1, p2, k3 = (dist[..., i:i + 1] for i in range(5))
    x, y = xy[..., 0:1], xy[..., 1:2]
    r2 = x * x + y * y
    f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = y * f + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.cat([xt, yt], -1)


def normalize_pixels(pix: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    x = (pix[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    y = (pix[..., 1] - K[..., 1, 2]) / K[..., 1, 1]
    return torch.stack([x, y], -1)


def undistort_points(pix: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 10) -> torch.Tensor:
    """cv2.undistortPoints: normalized undistorted coordinates [..., 2]."""
    xd = normalize_pixels(pix, K)
    k1, k2, p1, p2, k3 = (dist[..., i:i + 1] for i in range(5))
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0:1], x[..., 1:2]
        r2 = xx * xx + yy * yy
        f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = (xd - torch.cat([dx, dy], -1)) / f
    return x


def _hom_transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return torch.sum(T[..., :3, :3] * pts[..., None, :], -1) + T[..., :3, 3]


def project_points(pts_w: torch.Tensor, T_wc: torch.Tensor, K: torch.Tensor,
                   dist: torch.Tensor, min_depth: float = 0.0,
                   tangential: bool = False) -> torch.Tensor:
    """World points [..., 3] -> pixels [..., 2]: radial distortion, or with
    ``tangential`` the full model (``full_distort``).  ``min_depth > 0``
    keeps the perspective divide finite."""
    pc = _hom_transform(T_wc, pts_w)
    z = pc[..., 2:3]
    if min_depth > 0.0:
        z = torch.where(torch.abs(z) < min_depth,
                        torch.where(z < 0, -min_depth, min_depth), z)
    xy = pc[..., :2] / z
    xy = full_distort(xy, dist) if tangential else radial_distort(xy, dist)
    u = xy[..., 0] * K[..., 0, 0] + K[..., 0, 2]
    v = xy[..., 1] * K[..., 1, 1] + K[..., 1, 2]
    return torch.stack([u, v], -1)


def cam_centers_world(T_cw: torch.Tensor) -> torch.Tensor:
    """Camera origin in the world frame: the translation column."""
    return T_cw[..., :3, 3]


def pixel_rays_world(pix: torch.Tensor, K_inv: torch.Tensor,
                     T_cw: torch.Tensor) -> torch.Tensor:
    """Raw (distorted) pixel back-projection rotated into the world frame:
    R_cw · K⁻¹ · [u, v, 1]."""
    ph = torch.cat([pix, torch.ones_like(pix[..., :1])], -1)
    v = torch.sum(K_inv * ph[..., None, :], -1)
    return torch.sum(T_cw[..., :3, :3] * v[..., None, :], -1)


def undistorted_rays_world(pix: torch.Tensor, K: torch.Tensor,
                           dist: torch.Tensor, T_cw: torch.Tensor,
                           iters: int = 10) -> torch.Tensor:
    """Undistorted normalized point [x, y, 1] rotated to world (no
    translation)."""
    xn = undistort_points(pix, K, dist, iters=iters)
    v = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    return torch.sum(T_cw[..., :3, :3] * v[..., None, :], -1)


def save_rig_npz(path: str, rig: CameraRig) -> None:
    """Write a CameraRig as a flat npz, one array a field (the layout of
    ``mpe3d_tpu/geometry/camera.py::save_rig_npz``): the calibration that
    ``optimise_matrices`` training refines ships as ``refined_rig.npz``
    beside the checkpoint."""
    np.savez(path, **{f: np.asarray(a.cpu() if torch.is_tensor(a) else a)
                      for f, a in zip(CameraRig._fields, rig)})


def load_rig_npz(path: str) -> CameraRig:
    """The CameraRig of a ``save_rig_npz`` file, as host numpy arrays."""
    with np.load(path) as d:
        return CameraRig(**{f: d[f] for f in CameraRig._fields})
