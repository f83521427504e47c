"""Carry model weights from the JAX package's parameter trees into the port.

A JAX tree given as arrays (numpy, anything ``np.asarray`` takes, or torch
tensors) becomes the port's module state, so both packages compute with the
same numbers:

* matcher ``{"layers": [{attn_l, attn_r, b1, b2, w1, w2}, ...]}`` (with
  ``wr``/``br`` of a residual matcher, without ``b1``/``b2`` of a bias-free
  one) -> ``Matcher`` (fp32);
* lifter ``{"layers": [...]}`` -> ``Lifter``, served in the dtype
  ``serve_dtype`` resolves to (``mpe3d_tpu/pipeline.py:412-456``): a tree
  with int8 layers (``{"wq", "scale", "rscale", "b"}``) always serves int8;
  ``"int8"`` quantises a plain tree (``quantize_lifter_weights``); ``"fp32"``
  keeps fp32 weights; ``None`` serves bf16 weights, the reference's TPU
  default.  Under int8 the kept-fp head is served in bf16, as the
  reference's int8 serving sets ``compute_dtype=bfloat16``.  bf16 arrays
  (ml_dtypes ``bfloat16`` or uint16 bit patterns) are taken bit for bit,
  fp32 ones rounded to nearest even as ``astype(bfloat16)`` does.

Also numpy-seeded random trees in the JAX layout (the same distribution
families as ``init_matcher``/``init_lifter``), for runs without trained
weights, and the training forms: ``trainable_lifter_from_tree`` and
``trainable_matcher_from_tree`` build a ``TrainableLifter`` /
``TrainableMatcher`` from a tree (how tests carry the JAX package's
``init_lifter`` / ``init_matcher`` draws across), ``lifter_tree`` and
``matcher_tree`` give their weights back as the numpy trees the serving
modules take and the npz checkpoint stores.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import bf16_from_bits
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig
from mpe3d_tpu_torch.models.gat import Matcher, TrainableMatcher
from mpe3d_tpu_torch.models.mlp import (Lifter, TrainableLifter,
                                        cast_lifter_weights,
                                        lifter_is_quantized,
                                        quantize_lifter_weights)

Tree = Dict[str, Any]


def _f32(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _weight(a) -> torch.Tensor:
    """A weight matrix as a CPU tensor: bf16 kept bit for bit, int8 kept,
    anything else fp32."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return a if a.dtype in (torch.bfloat16, torch.int8) else a.float()
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return bf16_from_bits(a.view(np.uint16))
    if a.dtype == np.int8:
        return torch.from_numpy(np.array(a))
    return _f32(a)


SERVE_DTYPES = (None, "fp32", "int8")   # None: bf16 weights


def matcher_from_tree(tree: Tree, cfg: MatcherConfig, device) -> Matcher:
    layers = [{k: _f32(v) for k, v in layer.items()}
              for layer in tree["layers"]]
    return Matcher(cfg, layers).to(device)


def trainable_matcher_from_tree(tree: Tree, cfg: MatcherConfig,
                                device) -> TrainableMatcher:
    layers = [{k: _f32(v) for k, v in layer.items()}
              for layer in tree["layers"]]
    return TrainableMatcher(cfg, layers).to(device)


def matcher_tree(matcher: TrainableMatcher) -> Tree:
    """A trainable matcher's weights as the numpy fp32 tree of the JAX
    layout."""
    return {"layers": [
        {k: getattr(matcher, f"{k}{li}").detach().cpu().numpy().copy()
         for k in keys} for li, keys in enumerate(matcher.keys)]}


def lifter_from_tree(tree: Tree, cfg: LifterConfig, device,
                     serve_dtype: Optional[str] = None) -> Lifter:
    """The lifter of a JAX-layout tree, served in ``serve_dtype`` (None for
    bf16, "fp32", "int8"; module header).  ``Lifter.serve_dtype`` holds the
    resolved dtype ("bf16", "fp32" or "int8")."""
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(f"serve_dtype must be one of {SERVE_DTYPES}, got "
                         f"{serve_dtype!r}")
    tree = {"layers": [{k: (_weight(v) if k in ("w", "wq") else _f32(v))
                        for k, v in layer.items()}
                       for layer in tree["layers"]]}
    if lifter_is_quantized(tree) or serve_dtype == "int8":
        tree = quantize_lifter_weights(tree)
        layers = [layer if "wq" in layer
                  else cast_lifter_weights({"layers": [layer]},
                                           torch.bfloat16)["layers"][0]
                  for layer in tree["layers"]]
    else:
        layers = cast_lifter_weights(
            tree, torch.float32 if serve_dtype == "fp32"
            else torch.bfloat16)["layers"]
    return Lifter(cfg, layers).to(device)


def trainable_lifter_from_tree(tree: Tree, cfg: LifterConfig, device,
                               compute_dtype: Optional[str] = None
                               ) -> TrainableLifter:
    """The trainable lifter (fp32 master weights) of a plain fp32 tree
    ``{"layers": [{"b", "w"}, ...]}``; quantised or bf16-stored trees have
    no fp32 master and raise."""
    if lifter_is_quantized(tree):
        raise ValueError("an int8 lifter tree has no fp32 master weights "
                         "to train")
    layers = []
    for layer in tree["layers"]:
        w = _weight(layer["w"])
        if w.dtype != torch.float32:
            raise ValueError(f"a lifter tree of {w.dtype} weights has no "
                             f"fp32 master weights to train")
        layers.append({"w": w, "b": _f32(layer["b"])})
    return TrainableLifter(cfg, layers, compute_dtype).to(device)


def lifter_tree(lifter: TrainableLifter) -> Tree:
    """A trainable lifter's weights as the numpy fp32 tree
    ``{"layers": [{"b", "w"}, ...]}``."""
    return {"layers": [
        {"b": getattr(lifter, f"b{i}").detach().cpu().numpy().copy(),
         "w": getattr(lifter, f"w{i}").detach().cpu().numpy().copy()}
        for i in range(lifter.n_layers)]}


def random_matcher_tree(cfg: MatcherConfig, seed: int) -> Tree:
    """Xavier-normal (gain 1.414) weights, uniform biases, as numpy; the
    keys ``init_matcher`` gives ``cfg`` (no biases when ``cfg.bias`` is
    off; a residual matcher's shortcut wr/br on the layers after the first
    whose widths differ)."""
    rng = np.random.default_rng(seed)
    gain = 1.414

    def xavier(fan_in, fan_out, shape):
        std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def bias(fan_in, n):
        bound = 1.0 / fan_in ** 0.5
        return rng.uniform(-bound, bound, n).astype(np.float32)

    layers = []
    for li, (d_in, d, nh) in enumerate(cfg.layer_dims()):
        layer = {"attn_l": xavier(d, 1, (nh, d)),
                 "attn_r": xavier(d, 1, (nh, d))}
        if cfg.bias:
            layer["b1"] = bias(d_in, d_in)
            layer["b2"] = bias(d_in, nh * d)
        layer["w1"] = xavier(d_in, d_in, (d_in, d_in))
        layer["w2"] = xavier(d_in, nh * d, (d_in, nh * d))
        if cfg.residual and li > 0 and d_in != d:
            layer["wr"] = xavier(d_in, nh * d, (d_in, nh * d))
            if cfg.bias:
                layer["br"] = bias(d_in, nh * d)
        layers.append(layer)
    return {"layers": layers}


def random_lifter_tree(cfg: LifterConfig, seed: int) -> Tree:
    """torch.nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and
    biases, as numpy fp32: the family of ``init_lifter``, drawn with numpy
    (the port does not reproduce ``jax.random``, so the same seed gives
    other numbers than the JAX package's).  ``init_lifter`` zeroes the head
    of a ``residual_prior`` lifter; the trainer does that for a fresh run
    (``train/lifter.py``)."""
    rng = np.random.default_rng(seed)
    layers = []
    for d_in, d_out in cfg.layer_dims():
        bound = 1.0 / d_in ** 0.5
        layers.append({
            "b": rng.uniform(-bound, bound, d_out).astype(np.float32),
            "w": rng.uniform(-bound, bound, (d_in, d_out)).astype(np.float32)})
    return {"layers": layers}
