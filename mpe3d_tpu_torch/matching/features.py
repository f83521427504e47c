"""Skeleton-matching graph over a static topology (alt-3 and alt-2 graphs).

Port of ``mpe3d_tpu/matching/features.py``: ``PairTopology``,
``build_topology`` (:64, exact pair order), ``head_features`` for alt-3
and alt-2 (:93, flipped y), ``edge_node_features`` (:145), ``pair_mask_from_present``
(:156), and the crowded-bucket pair pruning ``pair_ray_distances`` (:163)
and ``prune_pair_candidates`` (:224), plain PyTorch as they are XLA code in
the reference.  Every (camera, slot) is a potential head node and every
cross-camera slot pair a potential edge node, with presence masks.

Head-node feature layout (alt-3): [0] head one-hot, [1] edge-node one-hot,
then 10 numbers per (matching camera, joint), only the head's own camera
block filled: i = (x - W/2)/(W/2), j = (H/2 - y)/(H/2) (y flipped), valid,
prob, camera origin in world, raw-pixel ray R_cw K^-1 [x, y, 1].  Alt-2
keeps the first 4 of them (i, j, valid, prob) per (camera, joint).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.geometry.camera import (CameraRig, cam_centers_world,
                                             pixel_rays_world)


class PairTopology(NamedTuple):
    """Static matcher topology for (C cameras x S slots).  Heads are
    h = c*S + s; edge nodes enumerate cross-camera slot pairs in
    (c1 < c2, s1, s2) order: E = C(C-1)/2 * S^2."""

    n_cameras: int
    n_slots: int
    e1: np.ndarray      # [E] head index of endpoint 1 (int32)
    e2: np.ndarray      # [E] head index of endpoint 2
    cam1: np.ndarray    # [E] camera of endpoint 1
    cam2: np.ndarray    # [E] camera of endpoint 2

    @property
    def n_heads(self) -> int:
        return self.n_cameras * self.n_slots

    @property
    def n_pairs(self) -> int:
        return len(self.e1)


def build_topology(n_cameras: int, n_slots: int) -> PairTopology:
    """Pair order of the reference's test graphs: outer loop camera pairs
    (c1 < c2), inner loops the slots of each camera
    (graph_generator.py:854-864)."""
    e1, e2, cam1, cam2 = [], [], [], []
    for c1 in range(n_cameras):
        for c2 in range(c1 + 1, n_cameras):
            for s1 in range(n_slots):
                for s2 in range(n_slots):
                    e1.append(c1 * n_slots + s1)
                    e2.append(c2 * n_slots + s2)
                    cam1.append(c1)
                    cam2.append(c2)
    i32 = lambda v: np.asarray(v, np.int32).reshape(-1)  # noqa: E731
    return PairTopology(n_cameras, n_slots, i32(e1), i32(e2), i32(cam1),
                        i32(cam2))


def incident_edges(topo: PairTopology) -> np.ndarray:
    """[H, D] int32: the edges incident to each head, ascending.  Every head
    of this topology has the same degree D = (C-1)*S."""
    H = topo.n_heads
    lists = [[] for _ in range(H)]
    for e, (a, b) in enumerate(zip(topo.e1, topo.e2)):
        lists[a].append(e)
        lists[b].append(e)
    return np.asarray(lists, np.int32).reshape(H, -1)


def head_features(kp: torch.Tensor, valid: torch.Tensor, prob: torch.Tensor,
                  observed: torch.Tensor, present: torch.Tensor,
                  rig: CameraRig, image_size: Tuple[float, float],
                  alt: str = "3") -> Tuple[torch.Tensor, torch.Tensor]:
    """Alt-3 (default) or alt-2 head-node features for every (camera,
    slot).

    kp [..., C, S, J, 2] raw pixels; valid/prob/observed [..., C, S, J];
    present [..., C, S] (leading dims: a batch of frames); ``rig``
    restricted to the matching cameras (tensors; alt-2 reads none of it).
    Returns (feats [..., H, 2 + C*J*n], head_mask [..., H]), H = C*S,
    n = 10 (alt-3) or 4 (alt-2)."""
    if alt not in ("2", "3"):
        raise ValueError(f"head_features: alt must be '2' or '3', got "
                         f"{alt!r}")
    C, S, J, _ = kp.shape[-4:]
    lead = tuple(kp.shape[:-4])
    W, H_img = image_size
    m = observed.to(kp.dtype)[..., None]
    ni = (kp[..., 0:1] - W / 2.0) / (W / 2.0)
    nj = (H_img / 2.0 - kp[..., 1:2]) / (H_img / 2.0)          # flipped y
    parts = [ni, nj, valid[..., None], prob[..., None]]
    if alt == "3":
        parts.append(cam_centers_world(rig.T_cw)[:, None, None, :].expand(
            *lead, C, S, J, 3))
        parts.append(pixel_rays_world(kp, rig.K_inv[:, None, None],
                                      rig.T_cw[:, None, None]))
    per_joint = torch.cat(parts, -1) * m                      # [C,S,J,n]
    npj = per_joint.shape[-1]
    flat = per_joint.reshape(*lead, C, S, J * npj)
    # each head's block goes to its own camera section of the C*J*n vector:
    # the (camera, camera) diagonal of [..., C, S, C, J*n]
    blocks = torch.zeros(lead + (C, S, C, J * npj), dtype=kp.dtype,
                         device=kp.device)
    blocks.diagonal(dim1=-4, dim2=-2).copy_(flat.movedim(-3, -1))
    one_hot = torch.zeros(lead + (C * S, 2), dtype=kp.dtype,
                          device=kp.device)
    one_hot[..., 0] = 1.0
    feats = torch.cat([one_hot, blocks.reshape(*lead, C * S, C * J * npj)],
                      -1)
    head_mask = present.reshape(*lead, C * S).to(kp.dtype)
    return feats * head_mask[..., None], head_mask


def edge_node_features(n_pairs: int, feat_dim: int,
                       dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Edge-node features: the 'edge_node' one-hot only
    (graph_generator.py:627-631)."""
    f = torch.zeros((n_pairs, feat_dim), dtype=dtype, device=device)
    f[:, 1] = 1.0
    return f


def pair_mask_from_present(present: torch.Tensor, e1: torch.Tensor,
                           e2: torch.Tensor) -> torch.Tensor:
    """pair valid <=> both endpoint slots occupied.  present [..., C, S];
    e1/e2 [E] head indices (tensors on present's device) -> [..., E]."""
    flat = present.reshape(*present.shape[:-2], -1).to(torch.float32)
    return flat[..., e1.long()] * flat[..., e2.long()]


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def pair_ray_distances(kp: torch.Tensor, shared: torch.Tensor,
                       rig: CameraRig, topo: PairTopology) -> torch.Tensor:
    """Triangulation-consistency distance per candidate pair, in metres
    (``mpe3d_tpu/matching/features.py:163``): the mean closest-approach
    distance between the raw-pixel world rays of the joints both skeletons
    share.  kp [C, S, J, 2] raw pixels; shared [C, S, J] per-joint usability
    (valid & observed); ``rig`` restricted to the matching cameras; the
    topology's index arrays may be numpy or tensors on kp's device.
    Returns d [E]; pairs with no shared joint get the sentinel 1e3.

    The reference selects endpoints with 0/1 incidence matmuls (exact, one
    nonzero a row) in a [3, J, E] layout for the TPU's lanes; here they are
    gathered by index in [E, J, 3]."""
    C, S, J, _ = kp.shape
    dev = kp.device
    e1, e2 = _index(topo.e1, dev), _index(topo.e2, dev)
    cam1, cam2 = _index(topo.cam1, dev), _index(topo.cam2, dev)
    rays = pixel_rays_world(kp, rig.K_inv[:, None, None],
                            rig.T_cw[:, None, None]).reshape(C * S, J, 3)
    sh = shared.reshape(C * S, J).to(kp.dtype)
    v1, v2 = rays[e1], rays[e2]                                  # [E, J, 3]
    both = sh[e1] * sh[e2]                                       # [E, J]
    centers = cam_centers_world(rig.T_cw)                        # [C, 3]
    dp = (centers[cam2] - centers[cam1])[:, None, :]             # [E, 1, 3]
    n = torch.cross(v1, v2, dim=-1)
    nn = torch.sqrt(torch.sum(n * n, -1))                        # [E, J]
    d_skew = torch.abs(torch.sum(dp * n, -1)) / torch.clamp(nn, min=1e-9)
    # (near-)parallel rays: perpendicular distance of the baseline to v1
    v1n = v1 / torch.clamp(torch.sqrt(torch.sum(v1 * v1, -1)),
                           min=1e-9)[..., None]
    perp = dp - torch.sum(dp * v1n, -1)[..., None] * v1n
    d = torch.where(nn > 1e-6, d_skew, torch.sqrt(torch.sum(perp * perp, -1)))
    cnt = torch.sum(both, -1)
    mean_d = torch.sum(d * both, -1) / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0, mean_d, torch.full_like(mean_d, 1e3))


def prune_pair_candidates(kp: torch.Tensor, shared: torch.Tensor,
                          rig: CameraRig, topo: PairTopology,
                          pair_mask: torch.Tensor, prune_dist: float,
                          cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Geometric candidate-pair gate and compaction for the crowded match
    stage (``mpe3d_tpu/matching/features.py:224``).  Pairs whose mean ray
    distance exceeds ``prune_dist`` metres are pruned; pairs with no shared
    joint (the 1e3 sentinel) are kept, ranked last among the kept.  The
    ``cap`` best-ranked pairs are gathered: ties go to the lower pair index,
    as ``lax.top_k`` breaks them (a stable ascending sort, not
    ``torch.topk``).  Returns (idx [cap] int64 indices into the E pairs,
    w [cap] fp32: 1 for a live kept pair, 0 for a pruned or padding one)."""
    E = pair_mask.shape[0]
    cap = min(int(cap), E)
    d = pair_ray_distances(kp, shared, rig, topo)
    unknown = d >= 999.0
    d_rank = torch.where(unknown, torch.full_like(d, prune_dist), d)
    keep = (pair_mask > 0) & (d_rank <= prune_dist)
    rank = torch.where(keep, d_rank, 1e6 + d_rank)
    idx = torch.sort(rank, stable=True).indices[:cap]
    return idx, keep[idx].to(torch.float32)
