"""Camera geometry and triangulation in plain PyTorch (float32): the
projection with radial distortion, 10-step undistortion, ray directions
and the two-view DLT with two refinement steps, averaged over camera
pairs ("mean" prior)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TorchRig(NamedTuple):
    K: torch.Tensor       # [C, 3, 3]
    K_inv: torch.Tensor   # [C, 3, 3]
    T_wc: torch.Tensor    # [C, 4, 4]
    T_cw: torch.Tensor    # [C, 4, 4]
    dist: torch.Tensor    # [C, 5] (k1, k2, p1, p2, k3)

    @property
    def n_cameras(self) -> int:
        return self.K.shape[0]


def torch_rig(rig, device) -> TorchRig:
    """A ``frames.Rig`` as float32 tensors on ``device``."""
    return TorchRig(*(torch.as_tensor(np.asarray(a, np.float32),
                                      device=device)
                      for a in (rig.K, rig.K_inv, rig.T_wc, rig.T_cw,
                                rig.dist)))


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.sum(T[..., :3, :3] * p[..., None, :], -1) + T[..., :3, 3]


def project(pts_w, T_wc, K, dist, min_depth: float = 1e-4) -> torch.Tensor:
    """World points [..., 3] -> pixels [..., 2], radial distortion, the
    depth kept at least ``min_depth`` away from 0."""
    pc = transform(T_wc, pts_w)
    z = pc[..., 2:3]
    z = torch.where(torch.abs(z) < min_depth,
                    torch.where(z < 0, -min_depth, min_depth), z)
    xy = pc[..., :2] / z
    k1, k2, k3 = dist[..., 0:1], dist[..., 1:2], dist[..., 4:5]
    r2 = torch.sum(xy * xy, -1, keepdim=True)
    xy = xy * (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
    return torch.stack([xy[..., 0] * K[..., 0, 0] + K[..., 0, 2],
                        xy[..., 1] * K[..., 1, 1] + K[..., 1, 2]], -1)


def undistort(pix, K, dist, iters: int = 10) -> torch.Tensor:
    """Normalised undistorted coordinates of raw pixels (fixed point)."""
    xd = torch.stack([(pix[..., 0] - K[..., 0, 2]) / K[..., 0, 0],
                      (pix[..., 1] - K[..., 1, 2]) / K[..., 1, 1]], -1)
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


def raw_rays(pix, K_inv, T_cw) -> torch.Tensor:
    """R_cw K^-1 [u, v, 1] of raw pixels."""
    ph = torch.cat([pix, torch.ones_like(pix[..., :1])], -1)
    v = torch.sum(K_inv * ph[..., None, :], -1)
    return torch.sum(T_cw[..., :3, :3] * v[..., None, :], -1)


def undistorted_rays(pix, K, dist, T_cw) -> torch.Tensor:
    xn = undistort(pix, K, dist)
    v = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    return torch.sum(T_cw[..., :3, :3] * v[..., None, :], -1)


def _solve3(M, b):
    a, d, g = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, h, c = M[..., 1, 1], M[..., 1, 2], M[..., 1, 0]
    f, i, k = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00, A01, A02 = e * k - h * i, h * f - c * k, c * i - e * f
    A10, A11, A12 = g * i - d * k, a * k - g * f, d * f - a * i
    A20, A21, A22 = d * h - g * e, g * c - a * h, a * e - d * c
    det = a * A00 + d * A01 + g * A02
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    return torch.stack([(A00 * b[..., 0] + A10 * b[..., 1] + A20 * b[..., 2]),
                        (A01 * b[..., 0] + A11 * b[..., 1] + A21 * b[..., 2]),
                        (A02 * b[..., 0] + A12 * b[..., 1] + A22 * b[..., 2])],
                       -1) / det[..., None]


def _pair_dlt(x1, x2, P1, P2, refine: int = 2):
    A = torch.stack([x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
                     x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
                     x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
                     x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], -2)
    B, d = A[..., :3], A[..., 3]
    M = torch.sum(B[..., :, :, None] * B[..., :, None, :], -3)
    x = _solve3(M, -torch.sum(B * d[..., None], -2))
    for _ in range(refine):
        r = torch.sum(B * x[..., None, :], -1) + d
        x = x + _solve3(M, -torch.sum(B * r[..., None], -2))
    return x


def triangulate_mean(pix, use, rig: TorchRig):
    """Mean of the two-view triangulations over every camera pair that
    sees a joint: pix [..., C, J, 2], use [..., C, J] -> (xyz [..., J, 3],
    ok [..., J])."""
    C = rig.n_cameras
    pairs = [(i, j) for i in range(C) for j in range(i + 1, C)]
    i = torch.tensor([p[0] for p in pairs], device=pix.device)
    j = torch.tensor([p[1] for p in pairs], device=pix.device)
    xn = undistort(pix, rig.K[:, None], rig.dist[:, None])
    P = rig.T_wc[:, :3, :]
    pts = _pair_dlt(xn[..., i, :, :], xn[..., j, :, :], P[i][:, None],
                    P[j][:, None])
    w = ((use[..., i, :] > 0.5) & (use[..., j, :] > 0.5)).to(pix.dtype)
    n = torch.sum(w[..., None], -3)
    mean = torch.sum(pts * w[..., None], -3) / torch.clamp(n, min=1.0)
    ok = n[..., 0] > 0.5
    return torch.where(ok[..., None], mean, torch.zeros_like(mean)), ok
