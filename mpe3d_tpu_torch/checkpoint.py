"""Reader for the JAX package's npz checkpoints, with numpy alone.

Format (written by ``mpe3d_tpu/train/checkpoint.py::save_checkpoint``):
``<stem>.npz`` holds the parameter leaves as ``p.leaf_NNNNN`` in
``jax.tree_util`` flatten order — dicts flatten with their keys sorted, so a
matcher layer's leaves come as ``attn_l, attn_r, b1, b2, w1, w2`` and a
lifter layer's as ``b, w`` — plus the meta JSON as a uint8 leaf
``__meta_json__``; ``<stem>.json`` is a sidecar copy of the meta.  bf16
servable exports (meta ``"stored": "bf16"``) store the weight bit patterns as
uint16, which are viewed back as bfloat16 here, never cast.  int8 servable
exports (``"stored": "int8"``) hold the tree of
``quantize_lifter_weights`` with its defaults: every layer but the last as
``b, rscale, scale, wq`` (int8 ``wq`` unpadded, fp32 scales), the last as
``b, w`` (fp32).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig, config_from_meta

_MATCHER_KEYS = ("attn_l", "attn_r", "b1", "b2", "w1", "w2")
_LIFTER_KEYS = ("b", "w")
_INT8_KEYS = ("b", "rscale", "scale", "wq")


def read_checkpoint(stem: str) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """The parameter leaves of ``<stem>.npz`` in flatten order, and the meta
    (embedded copy first, the sidecar where the npz has none)."""
    with np.load(stem + ".npz") as data:
        names = sorted(k for k in data.files if k.startswith("p.leaf_"))
        leaves = [data[k] for k in names]
        raw = data["__meta_json__"] if "__meta_json__" in data.files else None
    if [int(n[len("p.leaf_"):]) for n in names] != list(range(len(names))):
        raise ValueError(f"{stem}.npz: parameter leaves are not contiguous")
    if raw is not None:
        meta = json.loads(bytes(raw).decode())
    elif os.path.exists(stem + ".json"):
        with open(stem + ".json") as f:
            meta = json.load(f)
    else:
        meta = {}
    return leaves, meta


def bf16_from_bits(u16: np.ndarray) -> torch.Tensor:
    """bfloat16 tensor with the given uint16 bit patterns."""
    u16 = np.ascontiguousarray(u16, dtype=np.uint16)
    return torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)


def _unflatten(leaves, keys, n_layers: int, stem: str):
    if len(leaves) != len(keys) * n_layers:
        raise ValueError(f"{stem}: {len(leaves)} leaves, expected "
                         f"{len(keys)} x {n_layers} layers")
    return {"layers": [dict(zip(keys, leaves[i * len(keys):
                                             (i + 1) * len(keys)]))
                       for i in range(n_layers)]}


def load_matcher_checkpoint(stem: str, default_cfg: MatcherConfig
                            ) -> Tuple[Dict[str, Any], MatcherConfig]:
    """Matcher tree ``{"layers": [{attn_l, attn_r, b1, b2, w1, w2}, ...]}`` of
    numpy arrays, and the architecture stored in the meta."""
    leaves, meta = read_checkpoint(stem)
    cfg = config_from_meta(MatcherConfig, meta.get("matcher_config"),
                           default_cfg)
    if cfg.residual or not cfg.bias:
        raise NotImplementedError(
            f"{stem}: residual or bias-free matchers are not ported")
    return _unflatten(leaves, _MATCHER_KEYS, cfg.n_layers, stem), cfg


def load_lifter_checkpoint(stem: str, default_cfg: LifterConfig
                           ) -> Tuple[Dict[str, Any], LifterConfig, str]:
    """Lifter tree ``{"layers": [{"b", "w"}, ...]}`` (bf16 weights as
    bfloat16 tensors, everything else numpy; int8 exports: ``{"b", "rscale",
    "scale", "wq"}`` layers and a ``{"b", "w"}`` head), the architecture
    stored in the meta, and the packing prior (meta key ``prior``)."""
    leaves, meta = read_checkpoint(stem)
    cfg = config_from_meta(LifterConfig, meta.get("lifter_config"),
                           default_cfg)
    stored = meta.get("stored", "fp32")
    n_layers = len(cfg.widths) + 1
    if stored == "int8":
        n_q = len(_INT8_KEYS) * (n_layers - 1)
        tree = _unflatten(leaves[:n_q], _INT8_KEYS, n_layers - 1, stem)
        tree["layers"] += _unflatten(leaves[n_q:], _LIFTER_KEYS, 1,
                                     stem)["layers"]
        if any(layer["wq"].dtype != np.int8 for layer in tree["layers"][:-1]):
            raise ValueError(f"{stem}: stored int8 layers without int8 wq")
        return tree, cfg, meta.get("prior", "mean")
    if stored not in ("fp32", "bf16"):
        raise NotImplementedError(
            f"{stem}: stored={stored!r} lifters are not ported")
    tree = _unflatten(leaves, _LIFTER_KEYS, n_layers, stem)
    if stored == "bf16":
        for layer in tree["layers"]:
            layer["w"] = bf16_from_bits(layer["w"])
    return tree, cfg, meta.get("prior", "mean")
