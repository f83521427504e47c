"""Lifter input packing: 14 numbers per (used camera, joint).

Port of ``mpe3d_tpu/lifting/pack.py::pack_lifter_input`` (:60), written for
a batch of persons (the reference vmaps one person).  Layout per
(camera, joint), flattened C-order [C, J, 14]:

  [0] wire valid flag  [1] (x - W/2)/(W/2)  [2] (y - H/2)/(H/2)  [3] prob
  [4:7] camera origin in world / 10
  [7:10] undistorted pixel ray, rotated to world, / 10
  [10] triangulated prior available  [11:14] triangulated 3D / 10

Quirks kept: joint id 0 never contributes to the prior (the reference gates
on ``pos[0] > 0.`` where ``pos[0]`` is the joint id, pack.py:126-132), and
``require_valid`` selects the training-path packing mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mpe3d_tpu_torch.geometry.camera import (CameraRig, cam_centers_world,
                                             project_points,
                                             undistorted_rays_world)
from mpe3d_tpu_torch.geometry.triangulate import (triangulate_irls,
                                                  triangulate_mean,
                                                  triangulate_median_filtered)

_PRIORS = {"mean": triangulate_mean, "median": triangulate_median_filtered,
           "irls": triangulate_irls}


def pack_lifter_input(kp: torch.Tensor, valid: torch.Tensor,
                      prob: torch.Tensor, observed: torch.Tensor,
                      rig: CameraRig, image_size: Tuple[float, float],
                      require_valid: bool = False,
                      skip_joint0_prior: bool = True, prior: str = "mean",
                      prior_gate_px: Optional[float] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLP input for persons given their per-used-camera skeletons.

    kp [..., C, J, 2] raw pixels; valid/prob [..., C, J]; observed
    [..., C, J] bool.  ``rig`` restricted to the used cameras (tensors).
    ``prior``: "mean", "median" or "irls" triangulation behind fields 10-13.
    ``prior_gate_px``: drop the prior of joints whose prior reprojects
    farther than this (masked lower median over the packed cameras) from
    their own 2D evidence; None = reference semantics.
    Returns (net [..., C*J*14], include [..., C, J])."""
    if prior not in _PRIORS:
        raise ValueError(
            f"prior must be 'mean', 'median' or 'irls', got {prior!r}")
    C, J = kp.shape[-3], kp.shape[-2]
    lead = kp.shape[:-3]
    W, H = image_size
    dt = kp.dtype
    include = observed & (valid >= 1.0) if require_valid else observed
    m = include.to(dt)[..., None]                             # [..., C, J, 1]

    nx = (kp[..., 0:1] - W / 2.0) / (W / 2.0)
    ny = (kp[..., 1:2] - H / 2.0) / (H / 2.0)
    f03 = torch.cat([valid[..., None], nx, ny, prob[..., None]], -1) * m
    centers = cam_centers_world(rig.T_cw)                     # [C, 3]
    f46 = (centers[:, None, :] / 10.0).expand(*lead, C, J, 3) * m
    rays = undistorted_rays_world(kp, rig.K[:, None], rig.dist[:, None],
                                  rig.T_cw[:, None])
    f79 = rays / 10.0 * m

    tri_obs = observed.to(dt)
    if skip_joint0_prior:
        tri_obs = tri_obs * (torch.arange(J, device=kp.device) > 0).to(dt)
    tri_xyz, tri_ok = _PRIORS[prior](kp, tri_obs, rig)        # [..., J, 3]
    if prior_gate_px is not None:
        pix = project_points(tri_xyz[..., None, :, :], rig.T_wc[:, None],
                             rig.K[:, None], rig.dist[:, None],
                             min_depth=1e-4)                  # [..., C, J, 2]
        mg = m[..., 0]
        d = torch.linalg.norm(torch.clamp(kp - pix, -1e5, 1e5), dim=-1)
        nv = torch.sum(mg, -2)                                # [..., J]
        ds = torch.sort(torch.where(mg > 0, d, torch.full_like(d, float("inf"))),
                        dim=-2).values
        idx = torch.clamp(torch.ceil(nv / 2.0) - 1, min=0).long()
        resid = torch.take_along_dim(ds, idx[..., None, :], dim=-2)[..., 0, :]
        tri_ok = tri_ok & ~((nv > 0) & (resid > prior_gate_px))
    okf = tri_ok.to(dt)[..., None]                            # [..., J, 1]
    f10 = okf[..., None, :, :].expand(*lead, C, J, 1)
    f1113 = (tri_xyz * okf / 10.0)[..., None, :, :].expand(*lead, C, J, 3)
    net = torch.cat([f03, f46, f79, f10, f1113], -1)          # [..., C, J, 14]
    return net.reshape(*lead, C * J * 14), include
