"""The GAT matcher as an ``nn.Module`` (alt-3 and alt-2 graphs): serving
(``Matcher``) and training (``TrainableMatcher``).

Port of ``mpe3d_tpu/models/gat.py::apply_matcher`` (:272-330): per layer a
shared fc1 -> LeakyReLU(alpha) -> fc2
projection, per-destination edge softmax over the alt-3 topology (an edge
node's in-neighbours are {itself, head1, head2}; a head's are {itself} and
its incident live edge nodes, weighted by the pair weights), LeakyReLU
(hidden_slope) between layers, sigmoid scores from the 1-class output.

The stack runs in one of two forms on the same packed weights (one flat
fp32 buffer, the layout the kernels read), chosen by the caller (the
pipeline resolves it per bucket, ``PoseEstimationPipeline.serving_path``):

* ``"stack"``: ``ops/gat_kernel.py::gat_stack``, the whole stack in one
  host call (small buckets; heads of at most 64 incident edges; with
  ``edge_const`` layer 0 projects the shared edge row once);
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

Residual matchers (``cfg.residual``: every layer but the first adds the
shortcut ``_residual_val`` of its input to its head and edge outputs,
``mpe3d_tpu/models/gat.py:112-122, 266-268``) serve through the layer form
only, as the reference keeps them off its megakernel and tiled form
(:298, :304); the shortcut's product runs in ``torch.matmul`` (fp32, TF32
off), as the reference's is an XLA dot.  A bias-free matcher
(``cfg.bias`` off) packs zero biases, so the stack and tiled kernels
compute its function unchanged (a zero bias adds exactly nothing); the
layer form gives the projection no biases at all.  The alt-1 graph has a
matcher of its own (``matching/alt1.py``) on the same parameters.

``TrainableMatcher`` is the training form: one ``nn.Parameter`` per leaf
of the JAX tree, run through the plain stack's math
(``ops/gat_kernel.py::gat_layers``, the reference's XLA layer
``_gat_layer`` :132-269) and autograd (the reference trains outside its
kernels, with ``use_pallas_matcher`` off), with dropout (``_dropout`` :125)
drawn from a ``torch.Generator`` the caller passes.  It runs a batch of scenes as one
graph, the disjoint union of their graphs (``union_topology``): the
per-destination softmaxes never cross two scenes, so each scene's scores
are its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from mpe3d_tpu_torch.config import MatcherConfig
from mpe3d_tpu_torch.matching.features import PairTopology, incident_edges
from mpe3d_tpu_torch.ops.fused_proj import fused_linear_leaky_linear
from mpe3d_tpu_torch.ops.gat_kernel import (GatTopology, gat_layers,
                                            gat_stack, gat_stack_plain,
                                            layer_views)
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


def union_topology(gtopo: GatTopology, n: int, n_pairs: int) -> GatTopology:
    """The disjoint union of ``n`` copies of a graph of ``n_pairs`` edges:
    heads of copy b offset by b*H, edges (the incidence list) by b*E."""
    if n == 1:
        return gtopo
    H = gtopo.n_heads
    off = torch.arange(n, dtype=torch.int32, device=gtopo.e1.device)

    def shift(t, step):
        lead = off.view(-1, *([1] * t.dim())) * step
        return (t[None] + lead).reshape(-1, *t.shape[1:]).contiguous()

    return GatTopology(shift(gtopo.e1, H), shift(gtopo.e2, H), n * H,
                       None if gtopo.inc is None else shift(gtopo.inc,
                                                            n_pairs))


def _shapes(d_in: int, d: int, nh: int) -> Dict[str, tuple]:
    return {"w1": (d_in, d_in), "b1": (d_in,), "w2": (d_in, nh * d),
            "b2": (nh * d,), "attn_l": (nh, d), "attn_r": (nh, d),
            "wr": (d_in, nh * d), "br": (nh * d,)}


def check_layers(cfg: MatcherConfig, layers) -> List[Dict[str, torch.Tensor]]:
    """The layers as fp32 tensors, after checking that each has the
    parameters ``cfg`` gives it (no biases when ``cfg.bias`` is off, the
    shortcut wr (and br) on the layers after the first of a residual
    matcher whose widths differ) at their shapes."""
    dims = cfg.layer_dims()
    if len(layers) != len(dims):
        raise ValueError(f"{len(layers)} layers, config has {len(dims)}")
    out = []
    for li, (layer, (d_in, d, nh)) in enumerate(zip(layers, dims)):
        want = _shapes(d_in, d, nh)
        keys = set(_LAYER_ORDER) - ({"b1", "b2"} if not cfg.bias else set())
        if cfg.residual and li > 0 and d_in != d:
            keys |= {"wr", "br"} if cfg.bias else {"wr"}
        if set(layer) != keys:
            raise ValueError(f"matcher layer {li}: parameters "
                             f"{sorted(layer)}, the config needs "
                             f"{sorted(keys)}")
        ts = {k: torch.as_tensor(layer[k], dtype=torch.float32)
              for k in sorted(keys)}
        for k, t in ts.items():
            if tuple(t.shape) != want[k]:
                raise ValueError(f"matcher {k}: shape {tuple(t.shape)}, "
                                 f"expected {want[k]}")
        out.append(ts)
    return out


class Matcher(nn.Module):
    """GAT matcher.  ``layers``: per layer a dict of fp32 tensors
    w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F], attn_l/attn_r [nh, d]
    (the JAX package's parameter layout), without b1/b2 for a bias-free
    matcher, with the shortcut wr [d_in, F] (and br [F]) on the layers
    after the first of a residual matcher whose widths differ."""

    def __init__(self, cfg: MatcherConfig, layers: List[Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.dims = cfg.layer_dims()
        parts = []
        for li, (layer, (d_in, d, nh)) in enumerate(
                zip(check_layers(cfg, layers), self.dims)):
            for k in _LAYER_ORDER:
                parts.append(layer[k].reshape(-1) if k in layer
                             else torch.zeros(_shapes(d_in, d, nh)[k])
                             .reshape(-1))
            if "wr" in layer:
                self.register_buffer(f"wr{li}", layer["wr"].contiguous())
                self.register_buffer(f"br{li}", layer.get("br"))
        self.register_buffer("flat", torch.cat(parts).contiguous())

    def layer_params(self):
        """Per layer (w1, b1, w2, b2, attn_l, attn_r), the biases None for
        a bias-free matcher."""
        return [(w1, b1, w2, b2, al, ar) if self.cfg.bias
                else (w1, None, w2, None, al, ar)
                for w1, b1, w2, b2, al, ar in layer_views(self.flat,
                                                          self.dims)]

    def shortcuts(self):
        """Per layer the residual shortcut of a residual matcher (None on
        the first layer; "identity" where its widths agree; else (wr, br or
        None)), or None for a matcher without."""
        if not self.cfg.residual:
            return None
        return [None if li == 0 else
                (getattr(self, f"wr{li}"), getattr(self, f"br{li}"))
                if hasattr(self, f"wr{li}") else "identity"
                for li in range(len(self.dims))]

    def forward(self, x_all: torch.Tensor, pair_w: torch.Tensor,
                topo: GatTopology, form: str = "stack",
                edge_const: bool = False) -> torch.Tensor:
        """Logits [E] for node features x_all [H+E, in_dim] and pair weights
        pair_w [E] (0 = absent pair), through the stack, tiled or layer
        form.  ``edge_const`` (stack and tiled forms): every edge row of
        x_all is the same vector, so layer 0 projects it once."""
        args = (x_all.contiguous(), pair_w.contiguous(), topo, self.flat,
                self.dims, self.cfg.alpha, self.cfg.hidden_slope)
        if form == "layer":
            return gat_stack_plain(*args, proj=fused_linear_leaky_linear,
                                   bias=self.cfg.bias,
                                   shortcuts=self.shortcuts())
        if form not in FORMS:
            raise ValueError(f"matcher form must be one of {FORMS}, got "
                             f"{form!r}")
        if self.cfg.residual:
            raise ValueError(f"a residual matcher serves through the layer "
                             f"form, not {form!r} (the reference keeps it "
                             f"off its stack and tiled kernels)")
        if form == "tiled":
            return gat_stack_tiled(*args, edge_const=edge_const)
        return gat_stack(*args, edge_const=edge_const)


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


class TrainableMatcher(nn.Module):
    """The training form of the matcher (module header).  ``layers``: the
    JAX tree's layers, the keys ``Matcher`` takes; each leaf becomes the
    parameter ``{key}{layer}`` (``w10``, ``attn_l3``, ...)."""

    def __init__(self, cfg: MatcherConfig, layers: List[Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.dims = cfg.layer_dims()
        self.keys = []
        for li, layer in enumerate(check_layers(cfg, layers)):
            self.keys.append(tuple(sorted(layer)))
            for k in self.keys[-1]:
                self.register_parameter(f"{k}{li}",
                                        nn.Parameter(layer[k].clone()))

    def tree_params(self) -> List[nn.Parameter]:
        """The parameters in the JAX tree's flatten order (layer by layer,
        keys sorted), the order of the optimizer state's leaves."""
        return [getattr(self, f"{k}{li}")
                for li, keys in enumerate(self.keys) for k in keys]

    def layer_params(self):
        """Per layer (w1, b1, w2, b2, attn_l, attn_r), None for a missing
        bias."""
        get = lambda k, li: getattr(self, f"{k}{li}", None)  # noqa: E731
        return [tuple(get(k, li) for k in _LAYER_ORDER)
                for li in range(len(self.dims))]

    def shortcuts(self):
        """As ``Matcher.shortcuts``."""
        if not self.cfg.residual:
            return None
        return [None if li == 0 else
                (getattr(self, f"wr{li}"), getattr(self, f"br{li}", None))
                if "wr" in self.keys[li] else "identity"
                for li in range(len(self.dims))]

    def forward(self, x_all: torch.Tensor, pair_w: torch.Tensor,
                topo: GatTopology,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [E] for node features x_all [H+E, in_dim] (heads, then
        edge nodes) and pair weights pair_w [E] (0 = absent; the pair
        multiplicities weigh the head softmax) over ``topo`` (with its
        incidence list), through ``gat_layers``, the plain stack's math.
        Dropout (``feat_drop``, ``attn_drop``) runs when ``generator`` is
        given (train mode), drawn from it."""
        cfg = self.cfg
        train = generator is not None
        return gat_layers(x_all, pair_w, topo, self.layer_params(), self.dims,
                          cfg.alpha, cfg.hidden_slope,
                          shortcuts=self.shortcuts(), generator=generator,
                          feat_drop=cfg.feat_drop if train else 0.0,
                          attn_drop=cfg.attn_drop if train else 0.0)
