"""Lifter input packing: 14 numbers per (used camera, joint).

Port of ``mpe3d_tpu/lifting/pack.py::pack_lifter_input`` (:60), written for
a batch of persons (the reference vmaps one person), of
``pack_slot_fields09`` (:170), the same fields 0-9 for every detection slot,
and of the training side: ``pack_error_input`` (:43, the loss's raw-pixel
features), ``apply_camera_dropout`` and ``apply_prior_dropout``
(:207-241, the dataset's augmentation masks).
Layout per (camera, joint), flattened C-order [C, J, 14]:

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


def _fields09(kp: torch.Tensor, valid: torch.Tensor, prob: torch.Tensor,
              m: torch.Tensor, rig: CameraRig,
              image_size: Tuple[float, float], n_mid: int = 0
              ) -> torch.Tensor:
    """Fields 0-9 of kp [..., C, (n_mid axes), J, 2], masked by m (the same
    shape with 1 last)."""
    W, H = image_size
    nx = (kp[..., 0:1] - W / 2.0) / (W / 2.0)
    ny = (kp[..., 1:2] - H / 2.0) / (H / 2.0)
    f03 = torch.cat([valid[..., None], nx, ny, prob[..., None]], -1) * m
    sel = (slice(None),) + (None,) * (n_mid + 1)    # camera, then the rest
    centers = cam_centers_world(rig.T_cw)                     # [C, 3]
    f46 = (centers[sel] / 10.0).expand(*kp.shape[:-1], 3) * m
    rays = undistorted_rays_world(kp, rig.K[sel], rig.dist[sel],
                                  rig.T_cw[sel])
    return torch.cat([f03, f46, rays / 10.0 * m], -1)


def triangulated_prior(kp: torch.Tensor, observed: torch.Tensor,
                       include: torch.Tensor, rig: CameraRig,
                       skip_joint0_prior: bool = True, prior: str = "mean",
                       prior_gate_px: Optional[float] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prior behind fields 10-13: (xyz [..., J, 3] with zeros where not
    ok, ok [..., J]).  kp [..., C, J, 2]; observed/include [..., C, J]."""
    if prior not in _PRIORS:
        raise ValueError(
            f"prior must be 'mean', 'median' or 'irls', got {prior!r}")
    J = kp.shape[-2]
    dt = kp.dtype
    tri_obs = observed.to(dt)
    if skip_joint0_prior:
        tri_obs = tri_obs * (torch.arange(J, device=kp.device) > 0).to(dt)
    tri_xyz, tri_ok = _PRIORS[prior](kp, tri_obs, rig)        # [..., J, 3]
    if prior_gate_px is not None:
        resid = gate_residual_px(kp, include, tri_xyz, rig)
        tri_ok = tri_ok & ~(resid > prior_gate_px)
    return tri_xyz, tri_ok


def gate_residual_px(kp: torch.Tensor, include: torch.Tensor,
                     xyz: torch.Tensor, rig: CameraRig) -> torch.Tensor:
    """The prior gate's statistic [..., J]: the masked LOWER median over the
    included cameras of the prior's reprojection residual (px); -inf where
    no camera is included, so no gate drops such a joint.  kp [..., C, J, 2],
    include [..., C, J], xyz [..., J, 3]."""
    pix = project_points(xyz[..., None, :, :], rig.T_wc[:, None],
                         rig.K[:, None], rig.dist[:, None],
                         min_depth=1e-4)                      # [..., C, J, 2]
    d = torch.linalg.norm(torch.clamp(kp - pix, -1e5, 1e5), dim=-1)
    nv = torch.sum(include.to(kp.dtype), -2)                  # [..., J]
    ds = torch.sort(torch.where(include, d, torch.full_like(d, float("inf"))),
                    dim=-2).values
    idx = torch.clamp(torch.ceil(nv / 2.0) - 1, min=0).long()
    resid = torch.take_along_dim(ds, idx[..., None, :], dim=-2)[..., 0, :]
    return torch.where(nv > 0, resid,
                       torch.full_like(resid, float("-inf")))


def prior_fields(tri_xyz: torch.Tensor, tri_ok: torch.Tensor,
                 n_cameras: int) -> torch.Tensor:
    """Fields 10-13 of every camera block: [..., C, J, 4]."""
    okf = tri_ok.to(tri_xyz.dtype)[..., None]                 # [..., J, 1]
    f = torch.cat([okf, tri_xyz * okf / 10.0], -1)            # [..., J, 4]
    return f[..., None, :, :].expand(*f.shape[:-2], n_cameras, *f.shape[-2:])


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
    C, J = kp.shape[-3], kp.shape[-2]
    lead = kp.shape[:-3]
    include = observed & (valid >= 1.0) if require_valid else observed
    f09 = _fields09(kp, valid, prob, include.to(kp.dtype)[..., None], rig,
                    image_size)
    tri_xyz, tri_ok = triangulated_prior(kp, observed, include, rig,
                                         skip_joint0_prior, prior,
                                         prior_gate_px)
    net = torch.cat([f09, prior_fields(tri_xyz, tri_ok, C)], -1)
    return net.reshape(*lead, C * J * 14), include


def pack_slot_fields09(kp: torch.Tensor, valid: torch.Tensor,
                       prob: torch.Tensor, observed: torch.Tensor,
                       rig: CameraRig, image_size: Tuple[float, float]
                       ) -> torch.Tensor:
    """Per-(camera, slot) lifter-input fields 0-9, prior fields zeroed: the
    person-independent part of :func:`pack_lifter_input`, so gathering a
    person's slots from it equals packing the gathered observations.

    kp [C, S, J, 2] raw pixels; valid/prob/observed [C, S, J]; ``rig``
    restricted to the used cameras.  Returns [C, S, J, 14] float32."""
    f09 = _fields09(kp, valid, prob, observed.to(kp.dtype)[..., None], rig,
                    image_size, n_mid=1)
    return torch.cat([f09, torch.zeros_like(f09[..., :4])], -1)


def pack_error_input(kp: torch.Tensor, valid: torch.Tensor,
                     prob: torch.Tensor, observed: torch.Tensor
                     ) -> torch.Tensor:
    """The loss's raw-pixel features (reference:
    pose_estimator_dataset_from_json.py:181-184): [valid, x, y, prob] a
    (camera, joint), zeros where not observed.  kp [..., C, J, 2];
    valid/prob/observed [..., C, J].  Returns [..., C*J*4]."""
    m = observed.to(kp.dtype)
    feats = torch.stack([valid * m, kp[..., 0] * m, kp[..., 1] * m,
                         prob * m], -1)
    return feats.reshape(*kp.shape[:-3], -1)


def apply_camera_dropout(net_input: torch.Tensor, cam_keep: torch.Tensor,
                         n_joints: int) -> torch.Tensor:
    """Zero fields 0-9 of dropped cameras and keep the prior fields 10-13
    (reference pose_estimator_dataset_from_json.py:219-229).  net_input
    [..., C*J*14]; cam_keep [..., C] 0/1."""
    shape = net_input.shape
    C = cam_keep.shape[-1]
    x = net_input.reshape(*shape[:-1], C, n_joints, 14)
    field_is_obs = (torch.arange(14, device=x.device) < 10).to(x.dtype)
    keep = cam_keep[..., :, None, None]
    x = x * (keep * field_is_obs + (1.0 - field_is_obs))
    return x.reshape(shape)


def apply_prior_dropout(net_input: torch.Tensor, joint_keep: torch.Tensor,
                        n_joints: int) -> torch.Tensor:
    """Zero the prior fields 10-13 of dropped joints in every camera block
    and keep fields 0-9 (an augmentation with no reference counterpart: it
    shows the lifter prior-less joints).  joint_keep [..., J] 0/1."""
    shape = net_input.shape
    x = net_input.reshape(*shape[:-1], -1, n_joints, 14)
    field_is_prior = (torch.arange(14, device=x.device) >= 10).to(x.dtype)
    keep = joint_keep[..., None, :, None]
    x = x * (1.0 - field_is_prior * (1.0 - keep))
    return x.reshape(shape)
