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


def lifter_costs(lcfg: dict, rows: int) -> Tuple[float, float]:
    """(operations, bytes) of the lifter on ``rows`` person rows: 2 K N a
    row and layer; the rows read (fp32) and the poses written, the bf16
    weights and fp32 biases once."""
    dims = lifter_dims(lcfg)
    kn = sum(k * n for k, n in dims)
    ops = 2.0 * rows * kn
    byt = (2.0 * kn + 4.0 * sum(n for _, n in dims)
           + 4.0 * rows * (lcfg["in_dim"] + lcfg["out_dim"]))
    return ops, byt


def decode_costs(n_cameras: int, n_joints: int, heads: np.ndarray,
                 pairs: np.ndarray, live: np.ndarray, persons: np.ndarray
                 ) -> Tuple[float, float]:
    """(operations, bytes) of decode + gather + pack over frames: ordering
    the E present pairs (E log2 E compares), each of the ``live``
    candidate trips' camera checks (4 C), and per person and (camera,
    joint) the undistortion (10 steps of 27) and fields 0-9 (30), per
    person and joint the mean prior (388 a camera pair).  Bytes: the
    present pairs' scores and endpoints, the present skeletons' buffers
    (kp, valid, prob, observed), the camera tables read; the persons, the
    lifter rows and the gathered observations written."""
    C, J = n_cameras, n_joints
    cp = C * (C - 1) // 2
    E = pairs.astype(float)
    ops = float(np.sum(E * np.log2(np.maximum(E, 2.0)) + live * 4 * C
                       + persons * (C * J * (10 * 27 + 30) + J * cp * 388)))
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
                                   pairs, live, persons),
            "lifter": lifter_costs(cfg["lifter"], int(persons.sum()))}
