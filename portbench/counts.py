"""Operations and bytes that the work of a batch needs, counted from the
frames' own skeletons and pairs and the configuration's widths (frozen
here, after the cost functions of the port's chip check, so that a change
to the program cannot move them).  Nothing depends on how the program
buckets, pads or chunks a batch: padded slots, absent pairs and repeated
weight reads are not work the inputs need.  Each input byte is counted
read once and each output byte written once, per batch (weights once a
batch, as a program that keeps them in cache would read them)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.weights import lifter_dims, matcher_dims


def frame_sizes(present: np.ndarray) -> Tuple[int, int]:
    """(heads, pairs) of one frame's present skeletons, present [C, S]
    bool: every present skeleton a head, every two of different cameras a
    pair."""
    n = present.sum(axis=1)
    return int(n.sum()), int((n.sum() ** 2 - (n * n).sum()) // 2)


def gat_costs(mcfg: dict, heads: np.ndarray, pairs: np.ndarray
              ) -> Tuple[float, float]:
    """(operations, bytes) of the GAT stack over frames with these head
    and pair counts: layer 0 projects the H head rows and the one shared
    edge row, later layers all H + E rows; the attention terms, the edge
    softmax and output (6 E F), the head sums (4 E F) on each hidden
    layer.  Bytes: the head rows and the edge row read, the pair weights,
    endpoints and incidence read, the logits written, the weights once."""
    dims = matcher_dims(mcfg)
    n_weights = sum(di * di + di + di * nh * d + nh * d + 2 * nh * d
                    for di, d, nh in dims)
    ops = 0.0
    for H, E in zip(heads.astype(float), pairs.astype(float)):
        for li, (di, d, nh) in enumerate(dims):
            F = nh * d
            rows = H + 1 if li == 0 else H + E
            ops += 2 * rows * (di * di + di * F) + 4 * rows * F + 6 * E * F
            if li < len(dims) - 1:
                ops += 4 * E * F
    byt = 4.0 * n_weights + float(
        np.sum(4 * ((heads + 1) * mcfg["in_dim"] + 5 * pairs) + 4 * pairs))
    return ops, byt


def lifter_costs(lcfg: dict, rows: int, stored: str = "bf16"
                 ) -> Tuple[float, float]:
    """(operations, bytes) of the lifter on ``rows`` person rows: 2 K N a
    row and layer; the rows read (fp32) and the poses written, the weights
    and fp32 biases once.  ``stored`` "bf16": 2 bytes a weight; "int8":
    every layer but the head 1 byte a weight and 4 a row scale (K), a
    column scale (N) and a bias (N), the head as bf16."""
    dims = lifter_dims(lcfg)
    kn = sum(k * n for k, n in dims)
    ops = 2.0 * rows * kn
    io = 4.0 * rows * (lcfg["in_dim"] + lcfg["out_dim"])
    if stored == "bf16":
        return ops, 2.0 * kn + 4.0 * sum(n for _, n in dims) + io
    if stored != "int8":
        raise ValueError(f"no count for lifter weights stored {stored!r}")
    (hk, hn), body = dims[-1], dims[:-1]
    return ops, (float(sum(k * n + 4 * (k + 2 * n) for k, n in body))
                 + 2.0 * hk * hn + 4.0 * hn + io)


def prior_ops(prior: str, n_cameras: int, n_joints: int) -> float:
    """Floating-point operations of one person's prior over its joints,
    counted from the kernel's branches (``csrc/frame_decode_pack.cu``:
    ``triangulate_pair``, ``pair_prior``, ``irls``, ``solve3x3``): a
    multiply, add, subtract, divide, square root, min or max one each, a
    k-term sum from zero k products and k adds; compares, selects,
    negations and absolute values nothing.  A 3x3 solve: the adjugate 27,
    the determinant 5, the three quotients 18: 50.  A pair triangulation:
    the 4 DLT rows 24 and their offsets 8, the normal matrix 72 and right
    side 24, a solve, 2 refinement steps of 105 (residuals 28, right side
    24, a solve, the update 3): 388.

    * "mean": the C(C-1)/2 camera pairs' triangulations, 388 a pair (the
      sum over the pairs is not counted), on every joint;
    * "median": the mean's, and the keep test's subtraction a pair: 389
      a pair (the rank tests are compares), on every joint;
    * "irls": joint 0 never contributes, so the chain runs on J - 1
      joints (each counted as seen by two cameras or more): the DLT rows
      and offsets, 16 a camera; 6 weighted solves, each 54 a camera (for
      each of 3 rows 2 weights, 12 for the two normal matrices, 4 for the
      right sides) and 65 (the two systems summed with the diagonal 12,
      the right side 3, a solve); 5 Huber rounds of 32 a camera (the
      projection 18, the depth clamp 1, the residual 8, the weight 3, the
      far-tail tests 2): 500 C + 390 a joint."""
    C, J = n_cameras, n_joints
    cp = C * (C - 1) // 2
    if prior == "mean":
        return float(J * cp * 388)
    if prior == "median":
        return float(J * cp * 389)
    if prior == "irls":
        return float((J - 1) * (500 * C + 390))
    raise ValueError(f"no count for the {prior!r} prior")


def decode_costs(n_cameras: int, n_joints: int, heads: np.ndarray,
                 pairs: np.ndarray, live: np.ndarray, persons: np.ndarray,
                 prior: str = "mean") -> Tuple[float, float]:
    """(operations, bytes) of decode + gather + pack over frames: ordering
    the E present pairs (E log2 E compares), each of the ``live``
    candidate trips' camera checks (4 C), and per person and (camera,
    joint) the undistortion (10 steps of 27) and fields 0-9 (30), per
    person the prior (``prior_ops``).  Bytes: the present pairs' scores
    and endpoints, the present skeletons' buffers (kp, valid, prob,
    observed), the camera tables read; the persons, the lifter rows and
    the gathered observations written."""
    C, J = n_cameras, n_joints
    E = pairs.astype(float)
    per_person = C * J * (10 * 27 + 30) + prior_ops(prior, C, J)
    ops = float(np.sum(E * np.log2(np.maximum(E, 2.0)) + live * 4 * C
                       + persons * per_person))
    byt = float(np.sum(E * (4 + 16) + heads * J * (8 + 4 + 4 + 1)
                       + persons * (4 * C + 4 * C * J * 14
                                    + C * J * (8 + 4 + 1)))) + C * 33 * 4
    return ops, byt


def lifter_weight_count(lcfg: dict) -> int:
    return sum(k * n + n for k, n in lifter_dims(lcfg))


def train_step_ops(lcfg: dict, rows: int) -> float:
    """Model operations of one training step: 6 a weight and row (the
    forward's 2 and the backward's 4)."""
    return 6.0 * lifter_weight_count(lcfg) * rows


def batch_costs(cfg: dict, present: np.ndarray, live: np.ndarray,
                persons: np.ndarray) -> Dict[str, Tuple[float, float]]:
    """The three layers' (operations, bytes) of one batch: present
    [B, C, S] bool, live [B] candidate trips, persons [B] decoded."""
    sizes = np.array([frame_sizes(p) for p in present], float)
    heads, pairs = sizes[:, 0], sizes[:, 1]
    return {"gat": gat_costs(cfg["matcher"], heads, pairs),
            "decode": decode_costs(present.shape[1], cfg["n_joints"], heads,
                                   pairs, live, persons,
                                   cfg["lifter"]["prior"]),
            "lifter": lifter_costs(cfg["lifter"], int(persons.sum()),
                                   cfg["lifter"].get("stored", "bf16"))}
