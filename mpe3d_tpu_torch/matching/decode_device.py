"""Person-proposal decode on the device: the greedy camera-consistent merge.

Port of ``mpe3d_tpu/matching/decode_device.py::decode_person_proposals_device``
(:37), same semantics as the reference's greedy decode
(utils/skeleton_matching_utils.py:12-132): eligible pairs (score above the
threshold, both endpoints present) in score-descending order; a pair is
rejected if either endpoint is linked to the other's camera or either
cluster already covers the other's camera (or both clusters' camera sets
intersect); otherwise the clusters unify.  Components with at least
``min_views`` heads become persons.

State on the device: ``cluster [H]`` (cluster id = founding head, -1 = none),
``linked [H, C]`` (starts as each head's own camera) and ``ccams [H, C]``
(cameras covered by the cluster rooted at each id).  Every update is a dense
masked one.  The loop runs once per live candidate; its trip count is read
back once per frame.

Order: ``lax.top_k`` keeps the lower index on ties and ``torch.topk`` promises
no tie order, so candidates are ranked with a stable descending sort.
``order_scores`` (the geometric rerank) replaces the scores in that order;
eligibility still comes from the scores.
``reference_merge_quirk`` (the default) keeps the reference's camera-list
loss on cluster-cluster merges, with endpoint roles in CPython's
set-iteration order (``matching/decode.py::reference_pair_order``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.matching.decode import reference_pair_order
from mpe3d_tpu_torch.matching.features import PairTopology


def decode_pairs(topo: PairTopology,
                 reference_merge_quirk: bool = True) -> np.ndarray:
    """[E, 4] int32 per pair: endpoint heads (a, b) in the decode's roles
    and their cameras (a // S, b // S)."""
    if reference_merge_quirk:
        a, b = reference_pair_order(topo.e1, topo.e2)
    else:
        a, b = topo.e1, topo.e2
    S = topo.n_slots
    return np.stack([a, b, a // S, b // S], 1).astype(np.int32)


def decode_person_proposals_device(
        scores: torch.Tensor, pair_mask: torch.Tensor, topo: PairTopology,
        min_views: int = 2, threshold: float = 0.5, max_persons: int = 0,
        top_k: int = 0, reference_merge_quirk: bool = True,
        order_scores: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores/pair_mask [E] -> (persons [P_max, C] int64 slot per camera,
    -1 = none; person_mask [P_max] bool), P_max = max_persons or
    H // min_views.  ``top_k`` bounds the loop to the K best candidates
    (0 = all E); ``order_scores`` [E] ranks them instead of ``scores``."""
    E, H = topo.n_pairs, topo.n_heads
    pairs = torch.as_tensor(decode_pairs(topo, reference_merge_quirk),
                            device=scores.device)
    return greedy_decode(
        scores, pair_mask, pairs, topo.n_cameras, topo.n_slots, min_views,
        threshold, max_persons or max(H // max(min_views, 1), 1),
        min(top_k, E) if top_k else E, reference_merge_quirk, order_scores)


def greedy_decode(scores: torch.Tensor, pair_mask: torch.Tensor,
                  pairs: torch.Tensor, C: int, S: int, min_views: int,
                  threshold: float, P_max: int, K: int,
                  reference_merge_quirk: bool = True,
                  order_scores: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode on explicit pairs [E, 4] (``decode_pairs``): at most K
    trips, in the order of ``order_scores`` where given; persons
    [P_max, C] int64 and person_mask [P_max]."""
    dev = scores.device
    H = C * S
    ends = pairs[:, :2].long()                                    # [E, 2]
    cams = pairs[:, 2:].long()

    eligible = (pair_mask > 0.5) & (scores > threshold)
    rank = scores if order_scores is None else order_scores
    masked = torch.where(eligible, rank,
                         torch.full_like(rank, float("-inf")))
    order = torch.sort(masked, descending=True, stable=True).indices[:K]
    n_live = min(int(eligible.sum()), K)

    iota_h = torch.arange(H, device=dev)
    iota_c = torch.arange(C, device=dev)
    cluster = torch.full((H,), -1, dtype=torch.long, device=dev)
    linked = (iota_h // S)[:, None] == iota_c[None, :]           # [H, C]
    ccams = torch.zeros((H, C), dtype=torch.bool, device=dev)
    none_c = torch.zeros((C,), dtype=torch.bool, device=dev)

    oe = ends[order[:n_live]]                                     # [n, 2]
    oc = cams[order[:n_live]]
    for i in range(n_live):
        ab = oe[i]
        a, b = ab[0], ab[1]
        oa, ob = iota_h == a, iota_h == b
        oca, ocb = iota_c == oc[i, 0], iota_c == oc[i, 1]
        kab = cluster[ab]
        ka, kb = kab[0], kab[1]
        a_has, b_has = ka >= 0, kb >= 0
        cc = ccams[torch.clamp(kab, min=0)]
        ccams_a, ccams_b = cc[0], cc[1]
        lk = linked[ab]
        reject = torch.any(torch.cat([
            lk[1] & oca, lk[0] & ocb,
            a_has & ccams_a & ocb,
            b_has & ccams_b & oca,
            (a_has & b_has) & ccams_a & ccams_b]))
        do = ~reject

        root = torch.where(a_has, ka, torch.where(b_has, kb, a))
        oroot = iota_h == root
        merge = a_has & b_has
        relabel = (merge & (cluster == kb)) | oa | ob
        cluster = torch.where(do & relabel, root, cluster)

        # cameras added to the surviving root: a new pair adds both, an
        # extension only the other endpoint's camera, a merge nothing under
        # the quirk (reference skeleton_matching_utils.py:85-104)
        if reference_merge_quirk:
            add = torch.where(~a_has & ~b_has, oca | ocb,
                              torch.where(merge, none_c,
                                          torch.where(a_has, ocb, oca)))
        else:
            add = oca | ocb | torch.where(merge, ccams_b, none_c)
        okb = iota_h == torch.clamp(kb, min=0)
        clear = do & merge & (kb != root)
        ccams = ((ccams | ((do & oroot)[:, None] & add[None, :]))
                 & ~(clear & okb)[:, None])
        linked = linked | (do & ((oa[:, None] & ocb[None, :])
                                 | (ob[:, None] & oca[None, :])))

    # components -> persons (cluster ids are head ids)
    assigned = cluster >= 0
    root_of = torch.clamp(cluster, min=0)
    counts = torch.zeros((H,), dtype=torch.long, device=dev).index_add_(
        0, root_of, assigned.long())
    root_ok = counts >= min_views
    root_rank = torch.cumsum(root_ok.long(), 0) - 1
    person_of_head = torch.where(assigned & root_ok[root_of],
                                 root_rank[root_of],
                                 torch.full_like(root_rank, -1))
    n_persons = root_ok.long().sum()
    valid_head = person_of_head >= 0
    # row P_max collects the unassigned heads and persons beyond P_max
    # (the reference's scatter drops those)
    p_idx = torch.where(valid_head, torch.clamp(person_of_head, max=P_max),
                        torch.full_like(person_of_head, P_max))
    slot = torch.where(valid_head, iota_h % S, torch.full_like(iota_h, -1))
    # max: under the merge quirk a cluster can hold two heads of one
    # camera; the reference keeps the larger head id (the larger slot)
    persons = torch.full(((P_max + 1) * C,), -1, dtype=torch.long,
                         device=dev).scatter_reduce(
        0, p_idx * C + iota_h // S, slot, reduce="amax", include_self=True)
    persons = persons.view(P_max + 1, C)[:P_max]
    person_mask = torch.arange(P_max, device=dev) < n_persons
    return persons, person_mask
