"""Batched DLT triangulation on torch tensors.

Port of ``mpe3d_tpu/geometry/triangulate.py``: ``_solve3x3`` (adjugate, :39),
``triangulate_pair`` (2 refinement steps, :64), ``triangulate_mean`` (:122),
``triangulate_median_filtered`` (:141), ``triangulate_irls`` (:172).

Points are ``[..., C, J, 2]`` raw pixels with validity ``[..., C, J]``: the
leading axes (persons) are a batch written out, where the reference vmaps.
Fixed shapes and masks, no LAPACK: element-wise arithmetic only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.geometry.camera import CameraRig, undistort_points


def _camera_pairs(n: int) -> np.ndarray:
    """All unordered camera pairs in itertools.combinations order."""
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    dtype=np.int64).reshape(-1, 2)


def _solve3x3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve via the adjugate.  M [..., 3, 3], b [..., 3]."""
    a, d, g = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, h, c = M[..., 1, 1], M[..., 1, 2], M[..., 1, 0]
    f, i, k = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00 = e * k - h * i
    A01 = h * f - c * k
    A02 = c * i - e * f
    A10 = g * i - d * k
    A11 = a * k - g * f
    A12 = d * f - a * i
    A20 = d * h - g * e
    A21 = g * c - a * h
    A22 = a * e - d * c
    det = a * A00 + d * A01 + g * A02
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    x0 = (A00 * b[..., 0] + A10 * b[..., 1] + A20 * b[..., 2]) / det
    x1 = (A01 * b[..., 0] + A11 * b[..., 1] + A21 * b[..., 2]) / det
    x2 = (A02 * b[..., 0] + A12 * b[..., 1] + A22 * b[..., 2]) / det
    return torch.stack([x0, x1, x2], -1)


def triangulate_pair(xn1: torch.Tensor, xn2: torch.Tensor, P1: torch.Tensor,
                     P2: torch.Tensor, refine_steps: int = 2) -> torch.Tensor:
    """Two-view DLT, inhomogeneous least squares with iterative refinement.
    xn1, xn2 [..., 2] undistorted normalized coords; P1, P2 [..., 3, 4]."""
    A = torch.stack([
        xn1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        xn1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        xn2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        xn2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], -2)                                                   # [..., 4, 4]
    B, d = A[..., :3], A[..., 3]
    M = torch.sum(B[..., :, :, None] * B[..., :, None, :], -3)
    x = _solve3x3(M, -torch.sum(B * d[..., None], -2))
    for _ in range(refine_steps):
        r = torch.sum(B * x[..., None, :], -1) + d
        x = x + _solve3x3(M, -torch.sum(B * r[..., None], -2))
    return x


def _pairwise_points(points, valid, rig: CameraRig):
    """All-pair triangulations: (pts [..., P, J, 3], pair_valid [..., P, J])."""
    pairs = _camera_pairs(rig.n_cameras)
    i = torch.as_tensor(pairs[:, 0], device=points.device)
    j = torch.as_tensor(pairs[:, 1], device=points.device)
    xn = undistort_points(points, rig.K[:, None], rig.dist[:, None])
    P = rig.T_wc[:, :3, :]
    pts = triangulate_pair(xn[..., i, :, :], xn[..., j, :, :],
                           P[i][:, None], P[j][:, None])
    pv = (valid[..., i, :] > 0.5) & (valid[..., j, :] > 0.5)
    return pts, pv


def triangulate_mean(points: torch.Tensor, valid: torch.Tensor,
                     rig: CameraRig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of all valid camera-pair triangulations per joint:
    (xyz [..., J, 3], ok [..., J])."""
    pts, pv = _pairwise_points(points, valid, rig)
    w = pv.to(points.dtype)[..., None]
    n = torch.sum(w, -3)
    mean = torch.sum(pts * w, -3) / torch.clamp(n, min=1.0)
    ok = n[..., 0] > 0.5
    return torch.where(ok[..., None], mean, torch.zeros_like(mean)), ok


def triangulate_median_filtered(points: torch.Tensor, valid: torch.Tensor,
                                rig: CameraRig, check_axis: int = 0,
                                inlier_tol: float = 0.05
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairs within ``inlier_tol`` of the median along ``check_axis``
    (median of n = sorted[n // 2]), averaged."""
    pts, pv = _pairwise_points(points, valid, rig)          # [..., P, J, 3]
    coord = pts[..., check_axis]                             # [..., P, J]
    big = torch.finfo(points.dtype).max
    coord_sorted = torch.sort(
        torch.where(pv, coord, torch.full_like(coord, big)), dim=-2).values
    n_valid = torch.sum(pv, -2)                              # [..., J]
    med_idx = torch.clamp(n_valid // 2, min=0)
    median = torch.take_along_dim(coord_sorted, med_idx[..., None, :],
                                  dim=-2)[..., 0, :]
    inlier = pv & (torch.abs(coord - median[..., None, :]) < inlier_tol)
    w = inlier.to(points.dtype)[..., None]
    n = torch.sum(w, -3)
    mean = torch.sum(pts * w, -3) / torch.clamp(n, min=1.0)
    ok = n_valid > 0
    return torch.where(ok[..., None], mean, torch.zeros_like(mean)), ok


def triangulate_irls(points: torch.Tensor, valid: torch.Tensor,
                     rig: CameraRig, n_iters: int = 5, delta_px: float = 4.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-view DLT with per-camera Huber weights from reprojection
    residuals, ``n_iters`` rounds; ``delta_px`` is the Huber knee in pixels.
    Returns (xyz [..., J, 3], ok [..., J]); ok needs >= 2 valid cameras."""
    dt = points.dtype
    xn = undistort_points(points, rig.K[:, None], rig.dist[:, None])
    P = rig.T_wc[:, :3, :]                                   # [C, 3, 4]
    v = (valid > 0.5).to(dt)                                 # [..., C, J]
    f = (rig.K[:, 0, 0] + rig.K[:, 1, 1]) * 0.5
    delta = delta_px / f                                     # [C]
    Pr = P[:, None, :, :]                                    # [C, 1, 3, 4]
    a1 = xn[..., 0:1] * Pr[..., 2, :] - Pr[..., 0, :]        # [..., C, J, 4]
    a2 = xn[..., 1:2] * Pr[..., 2, :] - Pr[..., 1, :]
    B1, d1 = a1[..., :3], a1[..., 3]
    B2, d2 = a2[..., :3], a2[..., 3]
    eye = torch.eye(3, dtype=dt, device=points.device)

    def solve(w):                                            # w [..., C, J]
        wj = (w * v)[..., None]
        B1w, B2w = B1 * wj, B2 * wj
        M = (torch.sum(B1w[..., :, None] * B1[..., None, :], -4)
             + torch.sum(B2w[..., :, None] * B2[..., None, :], -4))
        b = (torch.sum(B1w * d1[..., None], -3)
             + torch.sum(B2w * d2[..., None], -3))
        return _solve3x3(M + 1e-8 * eye, -b)                 # [..., J, 3]

    x = solve(torch.ones_like(v))
    zero = torch.zeros_like(v)
    for _ in range(n_iters):
        xc = (torch.sum(P[:, None, :, :3] * x[..., None, :, None, :], -1)
              + P[:, None, :, 3])                            # [..., C, J, 3]
        z = torch.clamp(xc[..., 2], min=1e-4)
        r = torch.linalg.norm(xc[..., :2] / z[..., None] - xn, dim=-1)
        w = torch.clamp(delta[:, None] / torch.clamp(r, min=1e-12), max=1.0)
        # hard-zero the far tail, but only where >= 3 cameras remain
        wz = torch.where(r > 10.0 * delta[:, None], zero, w)
        nz = torch.sum((wz > 0) & (v > 0), -2)
        w = torch.where(nz[..., None, :] >= 3, wz, w)
        # drop behind-camera views only where >= 2 weighted views remain
        wb = torch.where(xc[..., 2] > 1e-4, w, zero)
        nzb = torch.sum((wb > 0) & (v > 0), -2)
        w = torch.where(nzb[..., None, :] >= 2, wb, w)
        x = solve(w)
    ok = torch.sum(v, -2) > 1.5
    return torch.where(ok[..., None], x, torch.zeros_like(x)), ok
