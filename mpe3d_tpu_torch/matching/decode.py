"""Person-proposal decode on the host (numpy): the greedy camera-consistent
merge of the staged path.

Port of ``mpe3d_tpu/matching/decode.py`` (``_cpython_set2_order`` :30,
``reference_pair_order`` :58, ``decode_person_proposals`` :77,
``single_camera_bypass`` :176), the reference's greedy decode
(utils/skeleton_matching_utils.py:12-132): pairs scoring above the
threshold (both endpoints present), in descending score order (or
``order_scores`` order: the geometric rerank), merge heads into clusters
under the camera-consistency rules:

* a cluster holds at most one head per camera,
* two clusters merge only if their camera sets are disjoint,
* a pair is skipped if either head is already linked to the other's camera;

clusters of at least ``min_views`` heads become persons.  The device decode
(``decode_device.py``) computes the same function on tensors.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mpe3d_tpu_torch.matching.features import PairTopology


def _cpython_set2_order(x: int, y: int):
    """Iteration order of the CPython set ``{x, y}`` built by add(x) then
    add(y), for non-negative ints (hash(int) == int): 8-slot open
    addressing, slot = hash & 7, on collision i = i*5 + 1 + (perturb >>= 5)
    (setobject.c's linear probes are skipped whenever i + 9 > mask, always
    true for an 8-slot table).  The reference reads a pair's endpoints as
    ``list`` of such a set, and under the merge quirk which endpoint comes
    first decides which cluster's camera list survives."""
    mask = 7
    table = {}
    for v in (x, y):
        i = v & mask
        perturb = v
        while i in table:
            perturb >>= 5
            i = (i * 5 + 1 + perturb) & mask
        table[i] = v
    out = [table[i] for i in sorted(table)]
    return out[0], out[1]


_PAIR_ORDER_CACHE: dict = {}


def reference_pair_order(e1: np.ndarray, e2: np.ndarray):
    """Per-pair (a, b) endpoint roles in the reference's set-iteration
    order, memoised on the edge lists (the staged host decode asks for it
    every frame; a handful of topologies exist)."""
    key = (np.asarray(e1).tobytes(), np.asarray(e2).tobytes())
    hit = _PAIR_ORDER_CACHE.get(key)
    if hit is not None:
        return hit
    a = np.empty_like(e1)
    b = np.empty_like(e2)
    for k in range(len(e1)):
        a[k], b[k] = _cpython_set2_order(int(e1[k]), int(e2[k]))
    if len(_PAIR_ORDER_CACHE) > 32:
        _PAIR_ORDER_CACHE.clear()
    _PAIR_ORDER_CACHE[key] = (a, b)
    return a, b


def decode_person_proposals(scores: np.ndarray, pair_mask: np.ndarray,
                            topo: PairTopology, min_views: int = 2,
                            threshold: float = 0.5,
                            order_scores: Optional[np.ndarray] = None,
                            reference_merge_quirk: bool = True
                            ) -> np.ndarray:
    """Greedy camera-consistent clustering of heads.

    scores/pair_mask [E]; ``order_scores`` [E] (optional) replaces
    ``scores`` for the greedy order only, eligibility still thresholds
    ``scores``.  Returns persons [P, C] int64: the slot of each person in
    each matching camera, -1 where it has none.

    ``reference_merge_quirk`` (the default): on a cluster-cluster merge the
    absorbed cluster's camera list is dropped, not folded into the
    survivor (skeleton_matching_utils.py:100-104), and a person with two
    heads of one camera keeps the larger head id; False unions the camera
    sets."""
    S = topo.n_slots
    C = topo.n_cameras
    keep = (np.asarray(pair_mask) > 0.5) & (np.asarray(scores) > threshold)
    idx = np.nonzero(keep)[0]
    rank = np.asarray(scores if order_scores is None else order_scores)
    order = idx[np.argsort(-rank[idx], kind="stable")]
    if reference_merge_quirk:
        pe1, pe2 = reference_pair_order(topo.e1, topo.e2)
    else:
        pe1, pe2 = topo.e1, topo.e2

    H = topo.n_heads
    cluster = -np.ones(H, np.int64)          # head -> cluster id
    cams_of_cluster: List[set] = []
    # the reference's heads_linked_in_cameras: each head's own camera first
    linked_cams = [{int(h) // S} for h in range(H)]

    for e in order:
        a, b = int(pe1[e]), int(pe2[e])
        ca, cb = a // S, b // S
        if ca in linked_cams[b] or cb in linked_cams[a]:
            continue
        if cluster[a] >= 0 and cb in cams_of_cluster[cluster[a]]:
            continue
        if cluster[b] >= 0 and ca in cams_of_cluster[cluster[b]]:
            continue
        if cluster[a] < 0 and cluster[b] < 0:
            cid = len(cams_of_cluster)
            cams_of_cluster.append({ca, cb})
            cluster[a] = cluster[b] = cid
        elif cluster[a] >= 0 and cluster[b] < 0:
            cluster[b] = cluster[a]
            cams_of_cluster[cluster[a]].add(cb)
        elif cluster[b] >= 0 and cluster[a] < 0:
            cluster[a] = cluster[b]
            cams_of_cluster[cluster[b]].add(ca)
        else:
            ka, kb = cluster[a], cluster[b]
            # one cluster shares all its cameras with itself, so a pair
            # inside a cluster is rejected here, and its links are not
            # updated (skeleton_matching_utils.py:90-104)
            if cams_of_cluster[ka] & cams_of_cluster[kb]:
                continue
            if not reference_merge_quirk:
                cams_of_cluster[ka] |= cams_of_cluster[kb]
            cluster[cluster == kb] = ka
            cams_of_cluster[kb] = set()
        linked_cams[a].add(cb)
        linked_cams[b].add(ca)

    persons = []
    for cid in sorted(set(cluster[cluster >= 0].tolist())):
        members = np.nonzero(cluster == cid)[0]
        if len(members) < min_views:
            continue
        person = -np.ones(C, np.int64)
        for h in members:
            person[h // S] = h % S
        persons.append(person)
    if not persons:
        return np.zeros((0, C), np.int64)
    return np.stack(persons)


def single_camera_bypass(present: np.ndarray) -> np.ndarray:
    """One matching camera: every present skeleton is its own person
    (reference test/metrics_from_model.py:218-228).  present [1, S] ->
    persons [P, 1] int64."""
    slots = np.nonzero(present[0])[0]
    persons = -np.ones((len(slots), 1), np.int64)
    persons[:, 0] = slots
    return persons
