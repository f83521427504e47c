"""Carry model weights from the JAX package's parameter trees into the port.

A JAX tree given as arrays (numpy, anything ``np.asarray`` takes, or torch
tensors) becomes the port's module state, so both packages compute with the
same numbers:

* matcher ``{"layers": [{attn_l, attn_r, b1, b2, w1, w2}, ...]}`` -> ``Matcher``
  (fp32);
* lifter ``{"layers": [{"w", "b"}, ...]}`` -> ``Lifter``, weights as bf16:
  bf16 arrays (ml_dtypes ``bfloat16`` or uint16 bit patterns) are taken bit
  for bit, fp32 ones rounded to nearest even as ``astype(bfloat16)`` does.

Also numpy-seeded random trees in the JAX layout (the same distribution
families as ``init_matcher``/``init_lifter``), for runs without trained
weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import bf16_from_bits
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig
from mpe3d_tpu_torch.models.gat import Matcher
from mpe3d_tpu_torch.models.mlp import Lifter

Tree = Dict[str, Any]


def _f32(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().cpu().to(torch.bfloat16)
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return bf16_from_bits(a.view(np.uint16))
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16)


def matcher_from_tree(tree: Tree, cfg: MatcherConfig, device) -> Matcher:
    layers = [{k: _f32(v) for k, v in layer.items()}
              for layer in tree["layers"]]
    return Matcher(cfg, layers).to(device)


def lifter_from_tree(tree: Tree, cfg: LifterConfig, device) -> Lifter:
    layers = [(_bf16(layer["w"]), _f32(layer["b"]))
              for layer in tree["layers"]]
    return Lifter(cfg, layers).to(device)


def random_matcher_tree(cfg: MatcherConfig, seed: int) -> Tree:
    """Xavier-normal (gain 1.414) weights, uniform biases, as numpy."""
    rng = np.random.default_rng(seed)
    gain = 1.414

    def xavier(fan_in, fan_out, shape):
        std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def bias(fan_in, n):
        bound = 1.0 / fan_in ** 0.5
        return rng.uniform(-bound, bound, n).astype(np.float32)

    layers = []
    for d_in, d, nh in cfg.layer_dims():
        layers.append({"attn_l": xavier(d, 1, (nh, d)),
                       "attn_r": xavier(d, 1, (nh, d)),
                       "b1": bias(d_in, d_in), "b2": bias(d_in, nh * d),
                       "w1": xavier(d_in, d_in, (d_in, d_in)),
                       "w2": xavier(d_in, nh * d, (d_in, nh * d))})
    return {"layers": layers}


def random_lifter_tree(cfg: LifterConfig, seed: int) -> Tree:
    """torch.nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and
    biases, as numpy fp32."""
    rng = np.random.default_rng(seed)
    layers = []
    for d_in, d_out in cfg.layer_dims():
        bound = 1.0 / d_in ** 0.5
        layers.append({
            "b": rng.uniform(-bound, bound, d_out).astype(np.float32),
            "w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32)})
    return {"layers": layers}
