"""The served pose pipeline in plain PyTorch and numpy: the reference that
judges the batch cells.

For one frame of C matching cameras x S slots (every used camera matches,
as in the configurations here), the alt-3 graph: H = C*S head nodes and
E = C(C-1)/2 * S^2 edge nodes in (c1 < c2, s1, s2) order; head features
(2 one-hot + 10 numbers per (camera, joint), only the head's own camera
block filled); the GAT stack (per layer fc1 -> LeakyReLU(alpha) -> fc2,
attention over an edge's {itself, its two heads} and over a head's
{itself, its live incident edges} weighted by the pair weights,
LeakyReLU(hidden_slope) between layers); scores sigmoid(logit) * pair
weight; the greedy camera-consistent decode over the ``top_k`` best
eligible pairs (ties to the lower pair index) with the reference's merge
quirk; each person's observations gathered; the 14-numbers-a-(camera,
joint) lifter input with the "mean" triangulated prior; the lifter MLP
(bf16 weights, bf16-rounded activations, fp32 sums); poses x10 in metres;
the quality column (mean reprojection residual in pixels).

``precision``: "fp32" is the configuration's (the GAT in float32 with
TF32 off, the lifter on its bf16 weights, the quality column in
float32); "control" is the next precision down of each: the GAT's
products with TF32-rounded operands, the lifter on int8 weights (a scale
a column) with bf16 activations, the quality column in bf16.  A correct
comparison must tell it apart.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from portbench.reference.geometry import (TorchRig, project, raw_rays,
                                          triangulate_mean, undistorted_rays)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("fp32", "control")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even), the
    operand rounding of a TF32 matmul, exactly, on any device."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with TF32-rounded operands, forward and backward (the
    backward's two products round theirs too), as a TF32 matmul trains."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).transpose(-1, -2), tf32(a).transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32 ("fp32", TF32 off) or with TF32 operands
    ("control")."""
    return _Tf32Matmul.apply(a, b) if precision == "control" else a @ b


# ---- topology -------------------------------------------------------------

class Topology(NamedTuple):
    C: int
    S: int
    e1: np.ndarray       # [E] head of endpoint 1
    e2: np.ndarray       # [E]
    inc: np.ndarray      # [H, D] incident edges of each head, ascending
    a: np.ndarray        # [E] endpoint roles in the decode (set order)
    b: np.ndarray

    @property
    def H(self) -> int:
        return self.C * self.S

    @property
    def E(self) -> int:
        return len(self.e1)


def _set2_order(x: int, y: int) -> Tuple[int, int]:
    """Iteration order of the CPython set {x, y} (add x, then y): the
    endpoint roles the reference decode reads."""
    table: Dict[int, int] = {}
    for v in (x, y):
        i, perturb = v & 7, v
        while i in table:
            perturb >>= 5
            i = (i * 5 + 1 + perturb) & 7
        table[i] = v
    out = [table[i] for i in sorted(table)]
    return out[0], out[1]


def topology(C: int, S: int) -> Topology:
    e1, e2 = [], []
    for c1 in range(C):
        for c2 in range(c1 + 1, C):
            for s1 in range(S):
                for s2 in range(S):
                    e1.append(c1 * S + s1)
                    e2.append(c2 * S + s2)
    lists: List[List[int]] = [[] for _ in range(C * S)]
    for e, (p, q) in enumerate(zip(e1, e2)):
        lists[p].append(e)
        lists[q].append(e)
    ab = [_set2_order(p, q) for p, q in zip(e1, e2)]
    return Topology(C, S, np.asarray(e1), np.asarray(e2),
                    np.asarray(lists).reshape(C * S, -1),
                    np.asarray([t[0] for t in ab]),
                    np.asarray([t[1] for t in ab]))


# ---- matcher --------------------------------------------------------------

def head_features(kp, valid, prob, obs, present, rig: TorchRig,
                  image_size) -> torch.Tensor:
    """[H, 2 + C*J*10] alt-3 head features of one frame's buffers
    [C, S, ...]."""
    C, S, J, _ = kp.shape
    W, Hi = image_size
    m = obs.to(kp.dtype)[..., None]
    ni = (kp[..., 0:1] - W / 2.0) / (W / 2.0)
    nj = (Hi / 2.0 - kp[..., 1:2]) / (Hi / 2.0)
    centre = rig.T_cw[:, None, None, :3, 3].expand(C, S, J, 3)
    rays = raw_rays(kp, rig.K_inv[:, None, None], rig.T_cw[:, None, None])
    per = torch.cat([ni, nj, valid[..., None], prob[..., None], centre,
                     rays], -1) * m                          # [C, S, J, 10]
    feats = torch.zeros(C, S, 2 + C * J * 10, dtype=kp.dtype,
                        device=kp.device)
    feats[..., 0] = 1.0
    for c in range(C):
        feats[c, :, 2 + c * J * 10:2 + (c + 1) * J * 10] = \
            per[c].reshape(S, J * 10)
    return feats.reshape(C * S, -1) * present.reshape(-1, 1).to(kp.dtype)


def _leaky(v, a):
    return torch.where(v >= 0, v, a * v)


def gat_logits(x, pw, topo: Topology, layers, cfg, precision: str
               ) -> torch.Tensor:
    """Logits [E] of node rows x [H+E, in_dim] (heads, then edge nodes),
    pair weights pw [E]; ``layers``: per layer a dict of w1, b1, w2, b2,
    attn_l, attn_r."""
    H, E = topo.H, topo.E
    dev = x.device
    e1 = torch.as_tensor(topo.e1, device=dev)
    e2 = torch.as_tensor(topo.e2, device=dev)
    inc = torch.as_tensor(topo.inc, device=dev)
    pw_inc = pw[inc]
    live = (pw_inc > 0)[..., None]
    alpha, slope = cfg["alpha"], cfg["hidden_slope"]
    n = len(layers)
    for li, p in enumerate(layers):
        nh, d = p["attn_l"].shape
        h1 = _leaky(matmul(x, p["w1"], precision) + p["b1"], alpha)
        z = (matmul(h1, p["w2"], precision) + p["b2"]).view(-1, nh, d)
        a1 = (z * p["attn_l"]).sum(-1)
        a2 = (z * p["attn_r"]).sum(-1)
        zh, ze = z[:H], z[H:]
        a1h, a2h, a1e, a2e = a1[:H], a2[:H], a1[H:], a2[H:]
        att = torch.softmax(torch.stack([_leaky(a1e + a2e, alpha),
                                         _leaky(a1h[e1] + a2e, alpha),
                                         _leaky(a1h[e2] + a2e, alpha)], -1),
                            -1)
        out_e = (att[..., 0:1] * ze + att[..., 1:2] * zh[e1]
                 + att[..., 2:3] * zh[e2])
        if li == n - 1:
            return out_e.reshape(E)
        ls = _leaky(a1h + a2h, alpha)
        lg = torch.where(live, _leaky(a1e[inc] + a2h[:, None], alpha),
                         torch.tensor(float("-inf"), device=dev))
        mx = torch.maximum(ls, lg.amax(1))
        es = torch.exp(ls - mx)
        xw = torch.exp(lg - mx[:, None]) * pw_inc[..., None]
        out_h = ((es[..., None] * zh + (xw[..., None] * ze[inc]).sum(1))
                 / (es + xw.sum(1))[..., None])
        x = _leaky(torch.cat([out_h.reshape(H, -1), out_e.reshape(E, -1)]),
                   slope)
    raise ValueError("no layers")


def frame_scores(frame, topo: Topology, layers, mcfg, rig: TorchRig,
                 image_size, precision: str) -> torch.Tensor:
    """Scores [E] of one frame: ``frame`` holds kp, valid, prob, in_view,
    present tensors [C, S, ...] of the matching cameras."""
    kp, valid, prob, obs, present = frame
    heads = head_features(kp, valid, prob, obs, present, rig, image_size)
    edges = torch.zeros(topo.E, heads.shape[1], device=kp.device)
    edges[:, 1] = 1.0
    pf = present.reshape(-1).to(torch.float32)
    pw = pf[torch.as_tensor(topo.e1, device=kp.device)] * \
        pf[torch.as_tensor(topo.e2, device=kp.device)]
    logits = gat_logits(torch.cat([heads, edges]), pw, topo, layers, mcfg,
                        precision)
    return torch.sigmoid(logits) * pw


# ---- decode (numpy) --------------------------------------------------------

def decode(scores: np.ndarray, present: np.ndarray, topo: Topology,
           threshold: float, top_k: int, min_views: int, p_max: int
           ) -> np.ndarray:
    """Persons [n, C] (slot a camera, -1 = none) of one frame: the greedy
    camera-consistent merge over the ``top_k`` best eligible pairs
    (score above ``threshold``, both slots present), best first, ties to
    the lower pair index; clusters of at least ``min_views`` heads, at
    most ``p_max`` of them."""
    C, S, H = topo.C, topo.S, topo.H
    pf = present.reshape(-1)
    pmask = pf[topo.e1] & pf[topo.e2]
    eligible = pmask & (scores > threshold)
    order = np.argsort(-np.where(eligible, scores, -np.inf), kind="stable")
    n_live = min(int(eligible.sum()), top_k if top_k else topo.E)
    cluster = np.full(H, -1)
    linked = (np.arange(H) // S)[:, None] == np.arange(C)[None, :]
    ccams = np.zeros((H, C), bool)
    for e in order[:n_live]:
        a, b = int(topo.a[e]), int(topo.b[e])
        ca, cb = a // S, b // S
        ka, kb = int(cluster[a]), int(cluster[b])
        a_has, b_has = ka >= 0, kb >= 0
        cc_a, cc_b = ccams[max(ka, 0)], ccams[max(kb, 0)]
        if (linked[b, ca] or linked[a, cb] or (a_has and cc_a[cb])
                or (b_has and cc_b[ca])
                or (a_has and b_has and bool(np.any(cc_a & cc_b)))):
            continue
        root = ka if a_has else (kb if b_has else a)
        merge = a_has and b_has
        if merge:
            cluster[cluster == kb] = root
        cluster[a] = cluster[b] = root
        if not a_has and not b_has:
            ccams[root, ca] = ccams[root, cb] = True
        elif not merge:
            ccams[root, cb if a_has else ca] = True
        if merge and kb != root:
            ccams[kb] = False
        linked[a, cb] = linked[b, ca] = True
    counts = np.bincount(cluster[cluster >= 0], minlength=H)
    root_ok = counts >= min_views
    rank = np.cumsum(root_ok) - 1
    persons = np.full((p_max + 1, C), -1)
    for h in range(H):
        k = cluster[h]
        if k >= 0 and root_ok[k]:
            p = min(int(rank[k]), p_max)
            persons[p, h // S] = max(persons[p, h // S], h % S)
    return persons[:min(int(root_ok.sum()), p_max)]


# ---- lifter input, lifter, quality ------------------------------------------

def gather(persons: np.ndarray, frame):
    """Each person's observations (kp [P, C, J, 2], valid, prob, obs
    [P, C, J]); zeros where the person has no slot."""
    kp, valid, prob, obs, _ = frame
    dev = kp.device
    pr = torch.as_tensor(persons, device=dev).long()
    has = pr >= 0
    take = torch.clamp(pr, min=0)
    cams = torch.arange(kp.shape[0], device=dev)[None, :]
    return (kp[cams, take] * has[..., None, None],
            valid[cams, take] * has[..., None],
            prob[cams, take] * has[..., None],
            obs[cams, take] & has[..., None])


def lifter_input(gkp, gval, gprob, gobs, rig: TorchRig, image_size
                 ) -> torch.Tensor:
    """[P, C*J*14]: per (camera, joint) valid, normalised x and y, prob,
    camera centre / 10, undistorted ray / 10, then the "mean" prior's ok
    flag and xyz / 10 (joint 0 never contributes to the prior)."""
    P, C, J, _ = gkp.shape
    W, Hi = image_size
    m = gobs.to(gkp.dtype)[..., None]
    nx = (gkp[..., 0:1] - W / 2.0) / (W / 2.0)
    ny = (gkp[..., 1:2] - Hi / 2.0) / (Hi / 2.0)
    f03 = torch.cat([gval[..., None], nx, ny, gprob[..., None]], -1) * m
    centre = (rig.T_cw[:, None, :3, 3] / 10.0).expand(P, C, J, 3) * m
    rays = undistorted_rays(gkp, rig.K[:, None], rig.dist[:, None],
                            rig.T_cw[:, None]) / 10.0 * m
    use = gobs.to(gkp.dtype) * (torch.arange(J, device=gkp.device)
                                > 0).to(gkp.dtype)
    xyz, ok = triangulate_mean(gkp, use, rig)
    okf = ok.to(gkp.dtype)[..., None]
    prior = torch.cat([okf, xyz * okf / 10.0], -1)[:, None].expand(P, C, J, 4)
    return torch.cat([f03, centre, rays, prior], -1).reshape(P, -1)


def lift(net, layers, slope: float, precision: str) -> torch.Tensor:
    """The lifter MLP on rows net [M, K]: bf16 weights (``layers``: w [K,
    N] bf16, b [N] fp32), bf16-rounded inputs to each layer, fp32 sums;
    under "control" the weights in int8 (a scale a column)."""
    h = net
    for i, p in enumerate(layers):
        w = p["w"].float()
        if precision == "control":
            s = torch.clamp(w.abs().amax(0), min=1e-12) / 127.0
            w = torch.clamp(torch.round(w / s), -127, 127) * s
        h = h.to(torch.bfloat16).float() @ w + p["b"]
        if i < len(layers) - 1:
            h = torch.where(h >= 0, h, slope * h)
    return h


def quality(poses, gkp, gval, gobs, rig: TorchRig,
            precision: str = "fp32") -> torch.Tensor:
    """[P] masked mean reprojection residual (px), -1 where a person has
    no valid observation; under "control" computed in bf16."""
    dt = torch.bfloat16 if precision == "control" else torch.float32
    poses, gkp = poses.to(dt), gkp.to(dt)
    T_wc, K, dist = (t.to(dt) for t in (rig.T_wc, rig.K, rig.dist))
    pix = project(poses[:, None], T_wc[None, :, None], K[None, :, None],
                  dist[None, :, None])
    m = ((gval > 0) & gobs).to(dt)
    d = torch.linalg.norm(torch.clamp(gkp - pix, -1e5, 1e5), dim=-1)
    tot = m.sum((1, 2))
    q = (d * m).sum((1, 2)) / torch.clamp(tot, min=1.0)
    return torch.where(tot > 0, q, torch.full_like(q, -1.0)).float()
