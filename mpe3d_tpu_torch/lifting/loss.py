"""Self-supervised multi-view reprojection loss.

Port of ``mpe3d_tpu/lifting/loss.py`` (:43-105), the reference's
``compute_error`` (pose_estimator/train_pose_estimator.py:69-102): the
predicted pose (decameters, x10 for metres) is projected into every camera
(world -> camera, perspective divide, radial distortion, K) and compared
with the observed raw pixels, masked by each (camera, joint)'s validity.
One projection over [B, C, J]; autograd gives the gradient.

``reprojection_loss(kind=...)``:

* ``"reference"``: the mean over the batch of the squared per-sample sum
  of |du| + |dv| (reference :216-218);
* ``"per_term"``: the masked mean of du^2 + dv^2;
* ``"huber"``: the masked mean of a per-coordinate Huber with
  ``huber_delta`` px.

Early predictions can put a joint on a camera plane: the divide keeps a
depth of at least ``min_depth=1e-4``, each coordinate's residual is clipped
to +-1e5 and each (camera, joint)'s L1 term capped at 1e5, so the loss
stays finite for the gradient clip to recover.
"""

from __future__ import annotations

import torch

from mpe3d_tpu_torch.geometry.camera import CameraRig, project_points

LOSS_KINDS = ("reference", "per_term", "huber")


def _reprojection_residuals(pred: torch.Tensor, error_input: torch.Tensor,
                            rig: CameraRig, n_joints: int):
    """Per-term pixel residuals d [B, C, J, 2] and validity [B, C, J]."""
    B, C, J = pred.shape[0], rig.n_cameras, n_joints
    pts_w = pred.reshape(B, J, 3) * 10.0                        # metres
    err_in = error_input.reshape(B, C, J, 4)
    pix = project_points(pts_w[:, None], rig.T_wc[None, :, None],
                         rig.K[None, :, None], rig.dist[None, :, None],
                         min_depth=1e-4)
    valid = (err_in[..., 0] >= 0.5).to(pred.dtype)
    d = torch.clamp(err_in[..., 1:3] - pix, -1e5, 1e5)
    return d, valid


def reprojection_error(pred: torch.Tensor, error_input: torch.Tensor,
                       rig: CameraRig, n_joints: int) -> torch.Tensor:
    """Per-sample summed |du| + |dv| over the valid (camera, joint) pairs
    [B].  pred [B, J*3] decameters; error_input [B, C*J*4] ([valid, x, y,
    prob] raw pixels); ``rig`` the full rig (every camera, in
    camera_names order, as tensors)."""
    d, valid = _reprojection_residuals(pred, error_input, rig, n_joints)
    l1 = torch.clamp(torch.sum(torch.abs(d), -1) * valid, max=1e5)
    return torch.sum(l1, dim=(1, 2))


def reprojection_loss(pred: torch.Tensor, error_input: torch.Tensor,
                      rig: CameraRig, n_joints: int,
                      kind: str = "reference",
                      huber_delta: float = 10.0) -> torch.Tensor:
    """The scalar training loss of ``kind`` (module header)."""
    if kind == "reference":
        err = reprojection_error(pred, error_input, rig, n_joints)
        return torch.mean(err * err)
    if kind not in LOSS_KINDS:
        raise ValueError(f"kind must be 'reference', 'per_term' or "
                         f"'huber', got {kind!r}")
    d, valid = _reprojection_residuals(pred, error_input, rig, n_joints)
    denom = torch.clamp(torch.sum(valid), min=1.0)
    if kind == "per_term":
        return torch.sum(torch.sum(d * d, -1) * valid) / denom
    a = torch.abs(d)
    h = torch.where(a <= huber_delta, 0.5 * a * a,
                    huber_delta * (a - 0.5 * huber_delta))
    return torch.sum(torch.sum(h, -1) * valid) / denom
