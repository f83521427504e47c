"""Label-free lifter training in plain PyTorch: the reference that judges
the training cell.  The lifter MLP (fp32 weights and sums, TF32 off;
LeakyReLU between layers), the reprojection loss of kind "reference" (the
batch mean of the squared per-sample sum of |du| + |dv| over the valid
(camera, joint) terms, the pose x10 projected into every camera with
radial distortion, the depth kept 1e-4 from 0, each residual clipped to
+-1e5 and each term's L1 capped at 1e5), the gradients by autograd, the
clip of their global norm to ``grad_clip_norm`` and Adam (b1 0.9, b2
0.999, eps 1e-8, bias-corrected).  Under "control" every matmul takes
TF32-rounded operands."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.geometry import TorchRig, project
from portbench.reference.pose import matmul

torch.backends.cuda.matmul.allow_tf32 = False

B1, B2, EPS = 0.9, 0.999, 1e-8


def forward(params: List[torch.Tensor], x: torch.Tensor, slope: float,
            precision: str = "fp32") -> torch.Tensor:
    """params: (b0, w0, b1, w1, ...) as the trainer orders its leaves."""
    h = x
    n = len(params) // 2
    for i in range(n):
        b, w = params[2 * i], params[2 * i + 1]
        h = matmul(h, w, precision) + b
        if i < n - 1:
            # LeakyReLU as torch's: at exactly 0 the slope's gradient
            h = torch.where(h > 0, h, slope * h)
    return h


def loss(pred: torch.Tensor, err_in: torch.Tensor, rig: TorchRig,
         n_joints: int) -> torch.Tensor:
    B, C, J = pred.shape[0], rig.n_cameras, n_joints
    pts = pred.reshape(B, J, 3) * 10.0
    e = err_in.reshape(B, C, J, 4)
    pix = project(pts[:, None], rig.T_wc[None, :, None], rig.K[None, :, None],
                  rig.dist[None, :, None])
    valid = (e[..., 0] >= 0.5).to(pred.dtype)
    d = torch.clamp(e[..., 1:3] - pix, -1e5, 1e5)
    l1 = torch.clamp(torch.sum(torch.abs(d), -1) * valid, max=1e5)
    err = torch.sum(l1, dim=(1, 2))
    return torch.mean(err * err)


def follow(init: List[torch.Tensor], net: torch.Tensor, err: torch.Tensor,
           batches: torch.Tensor, rig: TorchRig, tcfg: dict, n_joints: int,
           slope: float, keep_after: int, precision: str = "fp32",
           half: bool = False) -> Dict:
    """Train from ``init`` on the batches (rows of net/err) in order:
    the loss of each step, the gradient of step 1 and the parameters after
    ``keep_after`` steps.  ``half``: the planted fault that leaves out half
    of each batch and takes the mean over the rest."""
    params = [p.detach().clone().float().requires_grad_(True) for p in init]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    out: Dict = {"losses": []}
    for step, idx in enumerate(batches, start=1):
        if half:
            idx = idx[:len(idx) // 2]
        lv = loss(forward(params, net[idx], slope, precision), err[idx], rig,
                  n_joints)
        grads = list(torch.autograd.grad(lv, params))
        out["losses"].append(float(lv.detach()))
        if step == 1:
            out["grads"] = [g.detach().clone() for g in grads]
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if float(gn) >= tcfg["grad_clip_norm"]:
                grads = [(g / gn) * tcfg["grad_clip_norm"] for g in grads]
            c1, c2 = 1.0 - B1 ** step, 1.0 - B2 ** step
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(B1).add_((1.0 - B1) * g)
                v.mul_(B2).add_((1.0 - B2) * (g * g))
                p.add_(-tcfg["lr"] * ((m / c1) / (torch.sqrt(v / c2) + EPS)))
        if step == keep_after:
            out["params"] = [p.detach().clone() for p in params]
    return out
