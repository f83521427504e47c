"""Graph alternative '1': one node per joint and body-skeleton edges.

Port of ``mpe3d_tpu/matching/alt1.py``: the relation vocabularies with the
reference's left-ear quirk (:41-135), ``Alt1Topology`` and
``build_alt1_topology`` (:137-217, the same numpy arrays),
``alt1_feature_dim`` and ``alt1_node_features`` (:219-288) and
``apply_matcher_alt1`` (:290-392).  Per (camera, slot) one head node and
one node per joint, connected by the body-relation vocabulary; cross-camera
edge nodes connect heads as in alt-3.  Node ids:

    heads        h = c*S + s                   in [0, H)
    joints       H + h*J + j                   in [H, H + H*J)
    edge nodes   H + H*J + k                   in [H + H*J, N)

over a fixed edge list built once per (C, S, J, format), with per-edge
weights from node liveness (0 = absent).  Attention is a masked
per-destination segment softmax: the segment max by ``scatter_reduce(...,
"amax")``, the sums by ``index_add_`` over the edge list.

The reference quirk, reproduced: both ears abbreviate to 're'
(graph_generator.py:152-153), so only the later-keyed live ear has edges.
Statically, ear edges exist for both ears, the left-ear ones with a
"suppressor": live only when the right ear is absent.

The reference runs this graph in XLA, with no Pallas kernel, so it is plain
PyTorch on the card too (``segment_sum`` there, ``index_add_`` here).
``index_add_`` on CUDA sums with atomics in no fixed order: scores on the
card differ from the CPU's by rounding, run to run, and are held to them
within the stated tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import JOINT_NAMES_BY_FORMAT
from mpe3d_tpu_torch.matching.features import PairTopology
from mpe3d_tpu_torch.ops.fused_proj import proj_plain
from mpe3d_tpu_torch.ops.gat_kernel import layer_views, shortcut

# reference graph_generator.py:100-106 (verbatim, with left_ear -> 're')
_BODY_PARTS_ABBREVIATION = {
    "nose": "n", "neck": "ne", "right_shoulder": "rs", "right_elbow": "rel",
    "right_hand": "rha", "left_shoulder": "ls", "left_elbow": "lel",
    "left_hand": "lha", "hip": "hi", "right_hip": "rhip", "right_knee": "rk",
    "right_ankle": "ra", "left_hip": "lhip", "left_knee": "lk",
    "left_ankle": "la", "right_eye": "rey", "left_eye": "ley",
    "right_ear": "re", "left_ear": "re", "left_foot_ball": "lfb",
    "left_toes": "lto", "left_heel": "lhe", "right_foot_ball": "rfb",
    "right_toes": "rto", "right_heel": "rhe", "right_wrist": "rw",
    "left_wrist": "lw",
}

# reference graph_generator.py:144-149 / :78-82
_BODY_RELS = {
    "COCO": {"s_el", "el_w", "s_hip", "hip_k", "k_a", "n_e", "n_ne", "ne_s",
             "n_ey"},
    "BODY_25": {"e_ey", "n_ey", "n_ne", "ne_s", "s_el", "el_ha", "ne_hi",
                "hi_hip", "hip_k", "k_a", "a_he", "a_fb", "fb_to"},
}
_BODY_PARTS = {
    "COCO": {"e", "ey", "n", "s", "el", "w", "hip", "k", "a", "ne"},
    "BODY_25": {"e", "ey", "n", "s", "el", "hi", "hip", "ha", "he", "k", "a",
                "ne", "fb", "to"},
}


def alt1_relations(joint_format: str) -> List[str]:
    """The alt-1 relation vocabulary, sorted (reference
    graph_generator.py:153-205)."""
    rels: set = set()
    for r in _BODY_RELS.get(joint_format, set()):
        a, b = r.split("_")
        if a == "n":
            if b == "ne":
                rels.add(r)
            else:
                rels.add(f"n_r{b}")
                rels.add(f"n_l{b}")
        elif a == "ne":
            if b == "hi":
                rels.add(r)
            else:
                rels.add(f"ne_r{b}")
                rels.add(f"ne_l{b}")
        elif a == "hi":
            rels.add(f"hi_r{b}")
            rels.add(f"hi_l{b}")
        else:
            rels.add(f"r{a}_r{b}")
            rels.add(f"l{a}_l{b}")
    for p in _BODY_PARTS.get(joint_format, set()):
        if p == "n":
            rels.update({"h_n", "n_n"})
        elif p == "ne":
            rels.update({"h_ne", "ne_ne"})
        elif p == "hi":
            rels.update({"h_hi", "hi_hi"})
        else:
            rels.update({f"r{p}_l{p}", f"r{p}_r{p}", f"l{p}_l{p}",
                         f"h_r{p}", f"h_l{p}"})
    for r in list(rels):
        a, b = r.split("_")
        rels.add(f"{b}_{a}")
    rels.update({"h_h", "link", "link_link"})
    return sorted(rels)


def _abbr_candidates(joint_format: str) -> Dict[str, List[int]]:
    """abbr token -> joint indices in wire-key order (the later index wins
    where an abbr is aliased, the reference's dict overwrite)."""
    cands: Dict[str, List[int]] = {}
    for idx, name in enumerate(JOINT_NAMES_BY_FORMAT[joint_format]):
        cands.setdefault(_BODY_PARTS_ABBREVIATION[name], []).append(idx)
    return cands


def _resolve(tok: str, cands: Dict[str, List[int]]
             ) -> List[Tuple[Optional[int], Optional[int]]]:
    """Instances of a relation endpoint: [(joint or None for the head,
    suppressor joint or None)].  A suppressed instance is live only when
    the later-keyed joint of the same abbr is absent."""
    if tok == "h":
        return [(None, None)]
    lst = cands.get(tok, [])
    return [(j, lst[i + 1] if i + 1 < len(lst) else None)
            for i, j in enumerate(lst)]


class Alt1Topology(NamedTuple):
    """Static alt-1 graph over (C cameras x S slots x J joints + E pairs)."""

    n_cameras: int
    n_slots: int
    n_joints: int
    n_pairs: int
    src: np.ndarray        # [Et] int32 global node ids
    dst: np.ndarray        # [Et]
    sup1: np.ndarray       # [Et] suppressor node id for src (-1: none)
    sup2: np.ndarray       # [Et] suppressor node id for dst (-1: none)
    pair_idx: np.ndarray   # [Et] pair index of a link edge (-1: intra)
    to_head: np.ndarray    # [Et] bool: link edge with a head destination

    @property
    def n_heads(self) -> int:
        return self.n_cameras * self.n_slots

    @property
    def n_nodes(self) -> int:
        return self.n_heads * (1 + self.n_joints) + self.n_pairs

    @property
    def edge_node_offset(self) -> int:
        return self.n_heads * (1 + self.n_joints)


def build_alt1_topology(topo: PairTopology, n_joints: int,
                        joint_format: str = "COCO") -> Alt1Topology:
    """Static edge list: each slot's body graph, then each pair's 5 link
    edges (graph_generator.py:627-651)."""
    C, S, J = topo.n_cameras, topo.n_slots, n_joints
    H = C * S
    cands = _abbr_candidates(joint_format)
    # intra-skeleton pattern of one head slot: (src joint | None = head,
    # dst joint | None, suppressor of src, suppressor of dst); h_h first
    pattern = [(None, None, None, None)]
    for rel in alt1_relations(joint_format):
        if rel in ("h_h", "link", "link_link"):
            continue
        a, b = rel.split("_")
        for j1, s1 in _resolve(a, cands):
            for j2, s2 in _resolve(b, cands):
                pattern.append((j1, j2, s1, s2))

    def jid(h: int, j: Optional[int]) -> int:
        return h if j is None else H + h * J + j

    rows = []
    for h in range(H):
        for j1, j2, s1, s2 in pattern:
            rows.append((jid(h, j1), jid(h, j2),
                         -1 if s1 is None else jid(h, s1),
                         -1 if s2 is None else jid(h, s2), -1, False))
    en0 = H * (1 + J)
    for k in range(topo.n_pairs):
        en, h1, h2 = en0 + k, int(topo.e1[k]), int(topo.e2[k])
        for s, d, th in ((h1, en, False), (en, h1, True),
                         (h2, en, False), (en, h2, True), (en, en, False)):
            rows.append((s, d, -1, -1, k, th))
    cols = list(zip(*rows))
    i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
    return Alt1Topology(C, S, J, topo.n_pairs, i32(cols[0]), i32(cols[1]),
                        i32(cols[2]), i32(cols[3]), i32(cols[4]),
                        np.asarray(cols[5], bool))


class Alt1Graph(NamedTuple):
    """An ``Alt1Topology``'s edge arrays as int64 tensors on one device."""

    topo: Alt1Topology
    src: torch.Tensor
    dst: torch.Tensor
    sup1: torch.Tensor
    sup2: torch.Tensor
    pair_idx: torch.Tensor
    to_head: torch.Tensor      # bool


def alt1_graph(topo1: Alt1Topology, device) -> Alt1Graph:
    t = lambda a: torch.as_tensor(a, device=device).long()  # noqa: E731
    return Alt1Graph(topo1, t(topo1.src), t(topo1.dst), t(topo1.sup1),
                     t(topo1.sup2), t(topo1.pair_idx),
                     torch.as_tensor(topo1.to_head, device=device))


def alt1_feature_dim(n_joints: int, n_cameras: int) -> int:
    """['head', 'edge_node'] + joint one-hots + camera one-hots +
    [i, j, valid2D, probability] + [n_joints] (reference FEATURES['1'],
    graph_generator.py:119-120)."""
    return 2 + n_joints + n_cameras + 4 + 1


def alt1_node_features(kp: torch.Tensor, valid: torch.Tensor,
                       prob: torch.Tensor, observed: torch.Tensor,
                       present: torch.Tensor,
                       image_size: Tuple[float, float],
                       joint_format: str = "COCO"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alt-1 features of the head and joint nodes (reference :319-386).
    kp [C, S, J, 2] raw pixels; valid/prob/observed [C, S, J]; present
    [C, S].  Returns (feats [H + H*J, F], node_live [H + H*J])."""
    C, S, J, _ = kp.shape
    H = C * S
    W, Himg = image_size
    dt, dev = kp.dtype, kp.device
    F = alt1_feature_dim(J, C)
    neck = JOINT_NAMES_BY_FORMAT[joint_format].index("neck")

    pres = present.to(dt)
    live_j = observed.to(dt) * (valid > 0.5).to(dt) * pres[..., None]
    ni = (kp[..., 0] - W / 2.0) / (W / 2.0)
    nj = (Himg / 2.0 - kp[..., 1]) / (Himg / 2.0)                # flipped y
    cam_blk = torch.eye(C, dtype=dt, device=dev)[:, None, :].expand(C, S, C)

    neck_live = live_j[..., neck]
    head_rows = torch.cat([
        torch.ones((C, S, 1), dtype=dt, device=dev),             # 'head'
        torch.zeros((C, S, 1 + J), dtype=dt, device=dev),
        cam_blk,
        (ni[..., neck] * neck_live)[..., None],
        (nj[..., neck] * neck_live)[..., None],
        neck_live[..., None],                                    # valid2D
        (prob[..., neck] * neck_live)[..., None],
        (live_j.sum(-1) / J)[..., None],                         # n_joints
    ], -1) * pres[..., None]                                     # [C, S, F]

    jrows = torch.cat([
        torch.zeros((C, S, J, 2), dtype=dt, device=dev),
        torch.eye(J, dtype=dt, device=dev)[None, None].expand(C, S, J, J),
        cam_blk[:, :, None, :].expand(C, S, J, C),
        ni[..., None], nj[..., None],
        torch.ones((C, S, J, 1), dtype=dt, device=dev),          # valid2D
        prob[..., None],
        torch.zeros((C, S, J, 1), dtype=dt, device=dev),         # n_joints
    ], -1) * live_j[..., None]                                   # [C,S,J,F]
    feats = torch.cat([head_rows.reshape(H, F), jrows.reshape(H * J, F)])
    live = torch.cat([pres.reshape(H), live_j.reshape(H * J)])
    return feats, live


def apply_matcher_alt1(matcher, feats: torch.Tensor, node_live: torch.Tensor,
                       pair_mask: torch.Tensor,
                       graph: Alt1Graph) -> torch.Tensor:
    """The GAT stack over the alt-1 edge list: sigmoid scores [E].

    ``matcher``: a ``models/gat.py::Matcher`` (its packed layers, bias flag
    and residual shortcuts; cfg.in_dim = alt1_feature_dim).  feats
    [n_nodes, F]: the head and joint rows (``alt1_node_features``), then
    the edge-node rows (``features.edge_node_features``).  Per layer as
    the reference (gat2.py:50-88): fc1 -> LeakyReLU -> fc2, per-edge logits
    LeakyReLU(a_l z_src + a_r z_dst), a softmax over each destination's
    live in-edges, the weighted sum; the residual shortcut on every layer
    but the first."""
    cfg = matcher.cfg
    topo1 = graph.topo
    N = topo1.n_nodes
    src, dst = graph.src, graph.dst
    dt = feats.dtype
    # per-edge weight: both endpoints live, suppressors dead; an edge
    # node's link edges to its heads carry the pair weight
    lv = torch.cat([node_live.to(dt), (pair_mask > 0).to(dt)])   # [N]
    one = torch.ones((), dtype=dt, device=feats.device)
    w = (lv[src] * lv[dst]
         * torch.where(graph.sup1 >= 0,
                       1.0 - lv[torch.clamp(graph.sup1, min=0)], one)
         * torch.where(graph.sup2 >= 0,
                       1.0 - lv[torch.clamp(graph.sup2, min=0)], one))
    w = torch.where(graph.to_head,
                    pair_mask[torch.clamp(graph.pair_idx, min=0)], w)
    dead = (w <= 0)[:, None]
    shortcuts = matcher.shortcuts()
    x = feats
    dims = matcher.dims
    for l, ((d_in, d, nh), (w1, b1, w2, b2, al, ar)) in enumerate(
            zip(dims, layer_views(matcher.flat, dims))):
        if not cfg.bias:
            b1 = b2 = None
        z = proj_plain(x, w1, b1, w2, b2, cfg.alpha).view(N, nh, d)
        a1 = (z * al).sum(-1)                                     # [N, nh]
        a2 = (z * ar).sum(-1)
        v = a1[src] + a2[dst]
        logits = torch.where(v >= 0, v, cfg.alpha * v)            # [Et, nh]
        masked = torch.where(dead, float("-inf"), logits)
        m = torch.full((N, nh), float("-inf"), dtype=dt,
                       device=feats.device).scatter_reduce(
            0, dst[:, None].expand(-1, nh), masked, "amax")
        m = torch.where(torch.isfinite(m), m, 0.0)
        ex = torch.where(dead, 0.0, torch.exp(logits - m[dst])) * w[:, None]
        denom = torch.zeros((N, nh), dtype=dt,
                            device=feats.device).index_add_(0, dst, ex)
        num = torch.zeros((N, nh * d), dtype=dt,
                          device=feats.device).index_add_(
            0, dst, (ex[..., None] * z[src]).reshape(-1, nh * d))
        den = denom[..., None]
        out = torch.where(den > 0, num.view(N, nh, d)
                          / torch.clamp(den, min=1e-30), 0.0)
        if shortcuts is not None and shortcuts[l] is not None:
            out = out + shortcut(x, shortcuts[l], nh, d)
        if l < len(dims) - 1:
            o = out.reshape(N, nh * d)
            x = torch.where(o >= 0, o, cfg.hidden_slope * o)
        else:
            x = out.reshape(N)
    return torch.sigmoid(x[topo1.edge_node_offset:])
