"""The GAT matcher as an ``nn.Module`` (alt-3 graph, inference).

Port of ``mpe3d_tpu/models/gat.py::apply_matcher`` (:272-330) with no
residual and no dropout: per layer a shared fc1 -> LeakyReLU(alpha) -> fc2
projection, per-destination edge softmax over the alt-3 topology (an edge
node's in-neighbours are {itself, head1, head2}; a head's are {itself} and
its incident live edge nodes, weighted by the pair weights), LeakyReLU
(hidden_slope) between layers, sigmoid scores from the 1-class output.

The stack runs in one of two forms on the same packed weights (one flat
fp32 buffer, the layout the kernels read), chosen by the caller (the
pipeline resolves it per bucket, ``PoseEstimationPipeline.serving_path``):

* ``"stack"``: ``ops/gat_kernel.py::gat_stack``, the whole stack in one
  host call (small buckets; heads of at most 64 incident edges);
* ``"tiled"``: ``ops/gat_tiled.py::gat_stack_tiled``, two kernels per
  layer (crowded buckets, any head degree, compacted pruned edge sets);
* ``"layer"``: the per-layer form of the reference's XLA program
  (``_gat_layer`` :132 in the loop of ``apply_matcher`` :310-330, without
  dropout and residual): per layer one projection of the concatenated
  ``[heads; edges]`` rows through ``ops/fused_proj.py::
  fused_linear_leaky_linear`` (one kernel launch), then the attention
  terms, endpoint gathers, pair-weighted softmaxes and the inter-layer
  LeakyReLU in PyTorch: the plain stack's own per-layer math
  (``ops/gat_kernel.py::gat_stack_plain``) with the kernel as its
  projection.  It projects every edge row.

Each takes its CUDA kernels for CUDA tensors and its plain version for CPU
tensors.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from mpe3d_tpu_torch.config import MatcherConfig
from mpe3d_tpu_torch.matching.features import PairTopology, incident_edges
from mpe3d_tpu_torch.ops.fused_proj import fused_linear_leaky_linear
from mpe3d_tpu_torch.ops.gat_kernel import (GatTopology, gat_stack,
                                            gat_stack_plain)
from mpe3d_tpu_torch.ops.gat_tiled import gat_stack_tiled

FORMS = ("stack", "tiled", "layer")
_LAYER_ORDER = ("w1", "b1", "w2", "b2", "attn_l", "attn_r")


def gat_topology(topo: PairTopology, device,
                 form: str = "stack") -> GatTopology:
    """Index tensors of a pair topology on ``device``: the endpoints, and
    for the stack and layer forms each head's incident edges."""
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32,  # noqa: E731
                                     device=device).contiguous()
    if form not in FORMS:
        raise ValueError(f"matcher form must be one of {FORMS}, got {form!r}")
    return GatTopology(as_t(topo.e1), as_t(topo.e2), topo.n_heads,
                       None if form == "tiled"
                       else as_t(incident_edges(topo)))


class Matcher(nn.Module):
    """Alt-3 GAT matcher.  ``layers``: per layer a dict of fp32 tensors
    w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F], attn_l/attn_r [nh, d]
    (the JAX package's parameter layout)."""

    def __init__(self, cfg: MatcherConfig, layers: List[Dict[str, torch.Tensor]]):
        super().__init__()
        if cfg.residual or not cfg.bias:
            raise NotImplementedError("residual or bias-free matchers")
        self.cfg = cfg
        self.dims = cfg.layer_dims()
        if len(layers) != len(self.dims):
            raise ValueError(f"{len(layers)} layers, config has "
                             f"{len(self.dims)}")
        parts = []
        for layer, (d_in, d, nh) in zip(layers, self.dims):
            want = {"w1": (d_in, d_in), "b1": (d_in,), "w2": (d_in, nh * d),
                    "b2": (nh * d,), "attn_l": (nh, d), "attn_r": (nh, d)}
            for k in _LAYER_ORDER:
                t = torch.as_tensor(layer[k], dtype=torch.float32)
                if tuple(t.shape) != want[k]:
                    raise ValueError(f"matcher {k}: shape {tuple(t.shape)}, "
                                     f"expected {want[k]}")
                parts.append(t.reshape(-1))
        self.register_buffer("flat", torch.cat(parts).contiguous())

    def forward(self, x_all: torch.Tensor, pair_w: torch.Tensor,
                topo: GatTopology, form: str = "stack",
                edge_const: bool = False) -> torch.Tensor:
        """Logits [E] for node features x_all [H+E, in_dim] and pair weights
        pair_w [E] (0 = absent pair), through the stack, tiled or layer
        form.  ``edge_const`` (tiled form): every edge row of x_all is the
        same vector, so layer 0 projects it once."""
        args = (x_all.contiguous(), pair_w.contiguous(), topo, self.flat,
                self.dims, self.cfg.alpha, self.cfg.hidden_slope)
        if form == "tiled":
            return gat_stack_tiled(*args, edge_const=edge_const)
        if form == "layer":
            return gat_stack_plain(*args, proj=fused_linear_leaky_linear)
        if form != "stack":
            raise ValueError(f"matcher form must be one of {FORMS}, got "
                             f"{form!r}")
        return gat_stack(*args)


def apply_matcher(matcher: Matcher, head_feats: torch.Tensor,
                  edge_feats: torch.Tensor, topo: GatTopology,
                  pair_mask: torch.Tensor) -> torch.Tensor:
    """Sigmoid scores per candidate pair [E]."""
    x_all = torch.cat([head_feats, edge_feats], 0)
    return torch.sigmoid(matcher(x_all, pair_mask, topo))


def apply_matcher_tiled(matcher: Matcher, head_feats: torch.Tensor,
                        edge_feats: torch.Tensor, topo: GatTopology,
                        pair_w: torch.Tensor,
                        edge_const: bool = False) -> torch.Tensor:
    """Sigmoid scores per candidate pair [E] through the tiled form
    (``mpe3d_tpu/ops/gat_tiled.py::apply_matcher_tiled`` :363, with
    ``edge_const`` stated by the caller)."""
    x_all = torch.cat([head_feats, edge_feats], 0)
    return torch.sigmoid(matcher(x_all, pair_w, topo, "tiled", edge_const))
