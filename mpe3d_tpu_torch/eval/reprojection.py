"""Reprojection error of 3D poses, for datasets without 3D ground truth.

Port of ``mpe3d_tpu/eval/reprojection.py`` (reference
test/reprojection_error.py:89-107, 351-431): estimated 3D poses are
projected into every camera with the full distortion model (radial and
tangential, ``project_points(tangential=True)``), on the rig's device, and
compared with the observed 2D joints; per camera, the mean and median
pixel error.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from mpe3d_tpu_torch.geometry.camera import CameraRig, project_points


def reprojection_pixel_errors(poses: np.ndarray, kp: np.ndarray,
                              observed: np.ndarray, rig: CameraRig
                              ) -> List[List[float]]:
    """Per camera, the pixel errors |projected - observed| of the observed
    joints.  poses [P, J, 3] metres, world; kp [P, C, J, 2] the observed
    raw pixels of each person in each camera; observed [P, C, J] bool;
    ``rig`` the C cameras (tensors, on the device the projection runs
    on)."""
    C = rig.n_cameras
    if len(poses) == 0:
        return [[] for _ in range(C)]
    dev = rig.K.device
    pix = project_points(torch.as_tensor(np.asarray(poses, np.float32),
                                         device=dev)[:, None],
                         rig.T_wc[None, :, None], rig.K[None, :, None],
                         rig.dist[None, :, None], tangential=True)
    err = torch.linalg.norm(
        pix - torch.as_tensor(np.asarray(kp, np.float32), device=dev),
        dim=-1).cpu().numpy()                              # [P, C, J]
    return [err[:, c, :][observed[:, c, :]].tolist() for c in range(C)]


def per_camera_stats(errors: List[List[float]]) -> Dict[str, List[float]]:
    mean = [float(np.mean(e)) if e else float("nan") for e in errors]
    median = [float(np.median(e)) if e else float("nan") for e in errors]
    return {"mean_px": mean, "median_px": median}
