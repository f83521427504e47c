"""Read the reference's torch model files into the JAX-layout trees.

The port's own copy of ``mpe3d_tpu/convert/torch_import.py``:

* ``load_reference_lifter`` <- ``pose_estimator.pytorch``: a dict with
  ``model_state_dict`` of the 9-Linear MLP (reference:
  pose_estimator/train_pose_estimator.py:269-277, utils/mlp.py:3-31);
* ``load_reference_matcher`` <- ``skeleton_matching.tch`` (the GAT's
  state_dict) and ``skeleton_matching.prms`` (its hyper-parameter pickle,
  which holds the torch activation modules: the inter-layer LeakyReLU's
  slope, the residual flag and the dropout rates ride along; reference:
  train_skeleton_matching.py:229-246, gat2.py:17-135).

torch stores Linear weights [out, in] and the trees hold [in, out], so
every weight matrix is transposed.  Both files are pickles of whole Python
objects, not bare tensors: they are read with ``torch.load(...,
weights_only=False)`` (torch 2.6 and later default to ``weights_only=True``,
which refuses them) and ``pickle.load``, only for these two named files,
which can run code as they load: read only files from a source you trust.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def load_reference_lifter(path: str) -> Tuple[Dict, LifterConfig]:
    """``pose_estimator.pytorch`` -> (lifter tree ``{"layers": [{"b", "w"},
    ...]}``, its LifterConfig)."""
    saved = _torch_load(path)
    state = saved.get("model_state_dict", saved)
    # keys 'layers.1.weight' (a Sequential in self.layers) or '1.weight':
    # the integer is the Sequential index
    weights = {}
    for k, v in state.items():
        parts = k.split(".")
        weights.setdefault(int(parts[-2]), {})[parts[-1]] = v
    layers, dims = [], []
    for i in sorted(weights):
        w = weights[i]["weight"]                        # [out, in]
        layers.append({"w": np.ascontiguousarray(_np(w).T),
                       "b": _np(weights[i]["bias"])})
        dims.append(tuple(w.shape))
    cfg = LifterConfig(in_dim=dims[0][1], out_dim=dims[-1][0],
                       widths=tuple(d[0] for d in dims[:-1]))
    return {"layers": layers}, cfg


def load_reference_matcher(tch_path: str, prms_path: str
                           ) -> Tuple[Dict, MatcherConfig]:
    """``skeleton_matching.tch`` + ``.prms`` -> (matcher tree, its
    MatcherConfig)."""
    with open(prms_path, "rb") as f:
        prms = pickle.load(f)
    state = _torch_load(tch_path)
    cfg = MatcherConfig(
        in_dim=int(prms["num_feats"]),
        hidden=tuple(int(h) for h in prms["num_hidden"]),
        heads=tuple(int(h) for h in prms["heads"]),
        n_classes=int(prms["n_classes"]),
        alpha=float(prms["alpha"]),
        residual=bool(prms["residual"]),
        feat_drop=float(prms.get("in_drop", 0.0)),
        attn_drop=float(prms.get("attn_drop", 0.0)),
        # the reference pickles the inter-layer activation module itself
        # (train_skeleton_matching.py:54, 239): carry its slope
        hidden_slope=float(getattr(prms.get("nonlinearity"),
                                   "negative_slope", 0.01)),
    )
    layers = []
    for l in range(len(cfg.hidden) + 1):
        pre = f"layers.{l}."
        p = {"w1": np.ascontiguousarray(_np(state[pre + "fc1.weight"]).T),
             "w2": np.ascontiguousarray(_np(state[pre + "fc2.weight"]).T),
             # attention tensors are [nh, d, 1] in torch
             "attn_l": _np(state[pre + "attn_l"])[..., 0],
             "attn_r": _np(state[pre + "attn_r"])[..., 0]}
        if pre + "fc1.bias" in state:
            p["b1"] = _np(state[pre + "fc1.bias"])
            p["b2"] = _np(state[pre + "fc2.bias"])
        # the residual projection shortcut (reference gat2.py:42-48)
        if pre + "res_fc.weight" in state:
            p["wr"] = np.ascontiguousarray(_np(state[pre + "res_fc.weight"]).T)
            if pre + "res_fc.bias" in state:
                p["br"] = _np(state[pre + "res_fc.bias"])
        layers.append(p)
    return {"layers": layers}, cfg
