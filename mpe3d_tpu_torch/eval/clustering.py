"""Clustering-quality metrics for skeleton matching, with numpy alone.

The port's own copy of ``mpe3d_tpu/eval/clustering.py``: the reference
scores matching with sklearn's adjusted Rand index, homogeneity,
completeness and V-measure (reference: test/sm_metrics.py:220-229,
test/sm_metrics_without_gt.py:141-162), here from their definitions over
the label contingency table (Hubert & Arabie 1985; Rosenberg & Hirschberg
2007).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _contingency(labels_true: np.ndarray, labels_pred: np.ndarray
                 ) -> np.ndarray:
    t_vals, t_idx = np.unique(labels_true, return_inverse=True)
    p_vals, p_idx = np.unique(labels_pred, return_inverse=True)
    m = np.zeros((len(t_vals), len(p_vals)), np.int64)
    np.add.at(m, (t_idx, p_idx), 1)
    return m


def adjusted_rand_index(labels_true, labels_pred) -> float:
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = len(labels_true)
    if n < 2:
        return 1.0
    m = _contingency(labels_true, labels_pred)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(m).sum()
    a = comb2(m.sum(axis=1)).sum()
    b = comb2(m.sum(axis=0)).sum()
    total = comb2(n)
    expected = a * b / total if total else 0.0
    max_index = (a + b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def homogeneity_completeness_v(labels_true, labels_pred
                               ) -> Tuple[float, float, float]:
    labels_true = np.asarray(labels_true)
    labels_pred = np.asarray(labels_pred)
    n = len(labels_true)
    if n == 0:
        return 1.0, 1.0, 1.0
    m = _contingency(labels_true, labels_pred).astype(np.float64)
    h_c = _entropy(m.sum(axis=1))           # classes (true)
    h_k = _entropy(m.sum(axis=0))           # clusters (predicted)
    pc = m.sum(axis=1) / n
    pk = m.sum(axis=0) / n
    ti, ki = np.nonzero(m)
    p = m[ti, ki] / n
    h_c_given_k = float(-(p * (np.log(p) - np.log(pk[ki]))).sum())
    h_k_given_c = float(-(p * (np.log(p) - np.log(pc[ti]))).sum())
    homogeneity = 1.0 if h_c == 0 else 1.0 - h_c_given_k / h_c
    completeness = 1.0 if h_k == 0 else 1.0 - h_k_given_c / h_k
    if homogeneity + completeness == 0:
        v = 0.0
    else:
        v = 2.0 * homogeneity * completeness / (homogeneity + completeness)
    return float(homogeneity), float(completeness), float(v)


def clustering_report(labels_true, labels_pred) -> Dict[str, float]:
    h, c, v = homogeneity_completeness_v(labels_true, labels_pred)
    return {"ari": adjusted_rand_index(labels_true, labels_pred),
            "homogeneity": h, "completeness": c, "v_measure": v}


def persons_to_head_labels(persons: np.ndarray, n_heads: int,
                           n_slots: int) -> np.ndarray:
    """Each head's person index from decoded proposals (-1: unassigned),
    the reference's head-node -> person vectors (test/sm_metrics.py:
    211-218).  persons [P, C]: the slot of each person in each camera."""
    labels = -np.ones(n_heads, np.int64)
    for pi, person in enumerate(persons):
        for c, s in enumerate(person):
            if s >= 0:
                labels[c * n_slots + s] = pi
    return labels
