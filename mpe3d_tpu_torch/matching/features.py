"""Skeleton-matching graph over a static topology (alt-3 graph).

Port of ``mpe3d_tpu/matching/features.py``: ``PairTopology``,
``build_topology`` (:64, exact pair order), ``head_features`` for alt-3
(:93, flipped y), ``edge_node_features`` (:145), ``pair_mask_from_present``
(:156).  Every (camera, slot) is a potential head node and every
cross-camera slot pair a potential edge node, with presence masks.

Head-node feature layout (alt-3): [0] head one-hot, [1] edge-node one-hot,
then 10 numbers per (matching camera, joint), only the head's own camera
block filled: i = (x - W/2)/(W/2), j = (H/2 - y)/(H/2) (y flipped), valid,
prob, camera origin in world, raw-pixel ray R_cw K^-1 [x, y, 1].
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
                  rig: CameraRig, image_size: Tuple[float, float]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alt-3 head-node features for every (camera, slot).

    kp [C, S, J, 2] raw pixels; valid/prob/observed [C, S, J]; present
    [C, S]; ``rig`` restricted to the matching cameras (tensors).
    Returns (feats [H, 2 + C*J*10], head_mask [H]), H = C*S."""
    C, S, J, _ = kp.shape
    W, H_img = image_size
    m = observed.to(kp.dtype)[..., None]
    ni = (kp[..., 0:1] - W / 2.0) / (W / 2.0)
    nj = (H_img / 2.0 - kp[..., 1:2]) / (H_img / 2.0)          # flipped y
    line_p = cam_centers_world(rig.T_cw)[:, None, None, :].expand(C, S, J, 3)
    line_v = pixel_rays_world(kp, rig.K_inv[:, None, None],
                              rig.T_cw[:, None, None])
    per_joint = torch.cat([ni, nj, valid[..., None], prob[..., None],
                           line_p, line_v], -1) * m               # [C,S,J,10]
    flat = per_joint.reshape(C, S, J * 10)
    # each head's block goes to its own camera section of the C*J*10 vector
    blocks = torch.zeros((C, S, C, J * 10), dtype=kp.dtype, device=kp.device)
    cams = torch.arange(C, device=kp.device)
    blocks[cams, :, cams] = flat
    one_hot = torch.zeros((C * S, 2), dtype=kp.dtype, device=kp.device)
    one_hot[:, 0] = 1.0
    feats = torch.cat([one_hot, blocks.reshape(C * S, C * J * 10)], -1)
    head_mask = present.reshape(C * S).to(kp.dtype)
    return feats * head_mask[:, None], head_mask


def edge_node_features(n_pairs: int, feat_dim: int,
                       dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Edge-node features: the 'edge_node' one-hot only
    (graph_generator.py:627-631)."""
    f = torch.zeros((n_pairs, feat_dim), dtype=dtype, device=device)
    f[:, 1] = 1.0
    return f


def pair_mask_from_present(present: torch.Tensor, e1: torch.Tensor,
                           e2: torch.Tensor) -> torch.Tensor:
    """pair valid <=> both endpoint slots occupied.  present [C, S];
    e1/e2 [E] head indices (tensors on present's device)."""
    flat = present.reshape(-1).to(torch.float32)
    return flat[e1.long()] * flat[e2.long()]
