"""A replica of the reference's GAT (GraphAttention2 / GAT2) without DGL.

The port's own copy of ``mpe3d_tpu/convert/gat2_replica.py``: a behavioural
mirror of reference skeleton_matching/gat2.py:17-155 (the fc1 ->
LeakyReLU -> fc2 projection, a per-destination edge softmax over an
explicit (src, dst) edge list, the residual shortcut and the inter-layer
LeakyReLU), written against torch alone, since the reference's DGL runtime
is not a dependency.  Its edge softmax loops over destinations, the
semantics of DGL's ``edge_softmax``.

Its state_dict has the keys of the reference's ``skeleton_matching.tch``
(``layers.{l}.fc1/fc2/attn_l/attn_r/res_fc``), so ``convert/torch_import.py``
reads it, and its scores are the oracle the port's GAT is held to on the
reference's graph (``build_real_graph``: only the present heads and the
live pairs are nodes).

It ships with the port beside the converters because it is the
reference's model for the ``.tch`` files they read and write: a user of
the port loads a ``skeleton_matching.tch`` (the reference's, or one that
``export-torch`` wrote) into it with ``load_state_dict`` and scores it in
plain torch, without DGL and without the JAX package, which the port never
imports.  The serving and training paths do not call it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _Layer(nn.Module):
    def __init__(self, din: int, dout: int, nh: int, res: bool,
                 alpha: float):
        super().__init__()
        self.fc1 = nn.Linear(din, din, bias=True)
        self.fc2 = nn.Linear(din, nh * dout, bias=True)
        self.attn_l = nn.Parameter(torch.empty(nh, dout, 1))
        self.attn_r = nn.Parameter(torch.empty(nh, dout, 1))
        for p in (self.fc1.weight, self.fc2.weight, self.attn_l,
                  self.attn_r):
            nn.init.xavier_normal_(p.data, gain=1.414)
        self.nh, self.dout, self.alpha = nh, dout, alpha
        if res and din != dout:
            self.res_fc = nn.Linear(din, nh * dout, bias=True)
            nn.init.xavier_normal_(self.res_fc.weight.data, gain=1.414)
        self.residual = res

    def forward(self, x, src, dst):
        N = x.shape[0]
        z = self.fc2(F.leaky_relu(self.fc1(x), self.alpha)).reshape(
            N, self.nh, self.dout)
        a1 = torch.einsum("nhd,hd->nh", z, self.attn_l[..., 0])
        a2 = torch.einsum("nhd,hd->nh", z, self.attn_r[..., 0])
        logits = F.leaky_relu(a1[src] + a2[dst], self.alpha)    # [Et, nh]
        out = torch.zeros_like(z)
        for d in sorted(set(dst)):                 # per-dst edge_softmax
            sel = [k for k, dd in enumerate(dst) if dd == d]
            att = torch.softmax(logits[sel], dim=0)             # [k, nh]
            out[d] = torch.einsum("kh,khd->hd", att,
                                  z[[src[k] for k in sel]])
        if self.residual:
            if hasattr(self, "res_fc"):
                out = out + self.res_fc(x).reshape(N, self.nh, self.dout)
            else:
                out = out + x.unsqueeze(1)
        return out


class GAT2Replica(nn.Module):
    """The reference GAT: ``forward(x, src, dst)`` -> sigmoid scores of
    every node [N]."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 heads: Sequence[int], alpha: float = 0.15,
                 residual: bool = False, hidden_slope: float = 0.01):
        super().__init__()
        dims, d_in = [], in_dim
        for h, nh in zip(hidden, heads):
            dims.append((d_in, h, nh))
            d_in = h * nh
        dims.append((d_in, 1, 1))
        self.dims, self.hidden_slope = dims, hidden_slope
        self.layers = nn.ModuleList(
            [_Layer(din, dout, nh, residual and li > 0, alpha)
             for li, (din, dout, nh) in enumerate(dims)])

    def forward(self, x, src, dst):
        h = x
        for li, (_, dout, nh) in enumerate(self.dims):
            out = self.layers[li](h, src, dst)
            if li < len(self.dims) - 1:
                h = F.leaky_relu(out.reshape(len(x), nh * dout),
                                 self.hidden_slope)
            else:
                h = out.reshape(len(x))
        return torch.sigmoid(h)


def build_gat2_replica(in_dim: int, hidden: Sequence[int],
                       heads: Sequence[int], alpha: float = 0.15,
                       residual: bool = False,
                       hidden_slope: float = 0.01) -> GAT2Replica:
    """The replica with a fresh Xavier init (seed with
    ``torch.manual_seed`` before the call)."""
    return GAT2Replica(in_dim, hidden, heads, alpha, residual, hidden_slope)


def build_real_graph(topo, head_mask: np.ndarray, pair_mask: np.ndarray
                     ) -> Tuple[np.ndarray, List[int], List[int],
                                List[int], int]:
    """The graph the reference builds (graph_generator.py, alt-3 wiring):
    only the present heads and the live pairs are nodes; edges are the
    self-loops, the head <-> edge-node incidences both ways and the edge
    node's self edge.  Returns (the present heads, src, dst, the live pair
    indices, the number of present heads); node order: the present heads,
    then the live pairs."""
    real_heads = np.nonzero(head_mask)[0]
    remap = {int(h): i for i, h in enumerate(real_heads)}
    real_pairs = [k for k in range(len(pair_mask)) if pair_mask[k] > 0]
    H = len(real_heads)
    src, dst = list(range(H)), list(range(H))
    for i, k in enumerate(real_pairs):
        e = H + i
        h1, h2 = remap[int(topo.e1[k])], remap[int(topo.e2[k])]
        for s, d in ((h1, e), (e, h1), (h2, e), (e, h2), (e, e)):
            src.append(s)
            dst.append(d)
    return real_heads, src, dst, real_pairs, H
