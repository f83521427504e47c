"""Write JAX-layout trees as the reference's torch model files, the inverse
of ``convert/torch_import.py``.

The port's own copy of ``mpe3d_tpu/convert/torch_export.py``:

* ``pose_estimator.pytorch``: ``{'model_state_dict': ...}`` keyed by the
  reference MLP's ``nn.Sequential`` indices (``Flatten`` at 0, ``Linear``
  at 1, 3, 5, ... with the activations between; reference utils/mlp.py:
  3-31, saved at pose_estimator/train_pose_estimator.py:269-277);
* ``skeleton_matching.tch``: the GAT's state_dict, ``layers.{l}.fc1/fc2/
  attn_l/attn_r`` (and the biases, ``res_fc``), attention tensors
  ``[heads, d, 1]`` (reference gat2.py:17-48, saved at
  train_skeleton_matching.py:229-230);
* ``skeleton_matching.prms``: the hyper-parameter pickle the reference
  writes beside it (:230-246), with its torch activation modules.

Every weight matrix is transposed from the trees' [in, out] to torch's
[out, in].
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig


def _t(a) -> torch.Tensor:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return torch.from_numpy(np.array(a, np.float32, copy=True, order="C"))


def export_reference_lifter(params, path: str,
                            cfg: Optional[LifterConfig] = None) -> None:
    """Write a lifter tree as a ``pose_estimator.pytorch`` the reference's
    ``PoseEstimatorMLP`` loads with ``load_state_dict``.  ``cfg`` is
    required: a residual-prior lifter's weights look like an absolute one's,
    and only its config tells the export (refused: the reference's MLP
    would output the correction, not poses) apart, as it tells a LeakyReLU
    slope other than the reference's 0.1."""
    if cfg is None:
        raise ValueError(
            "export_reference_lifter requires cfg= (the checkpoint's "
            "LifterConfig, checkpoint.lifter_config_from_meta): "
            "residual_prior and negative_slope cannot be read from the "
            "weights, and an export without checking them can compute "
            "another function in the reference stack")
    if cfg.residual_prior:
        raise ValueError(
            "residual-prior lifters have no reference counterpart: the "
            "torch MLP would output the correction, not poses; only "
            "absolute-coordinate lifters export")
    if cfg.negative_slope != 0.1:
        raise ValueError(
            f"the reference PoseEstimatorMLP hardcodes LeakyReLU("
            f"negative_slope=0.1) (utils/mlp.py:7); a lifter trained with "
            f"negative_slope {cfg.negative_slope} would compute another "
            f"function there")
    state = {}
    for i, layer in enumerate(params["layers"]):
        idx = 1 + 2 * i      # Flatten at 0, activations at even indices
        state[f"layers.{idx}.weight"] = _t(np.asarray(layer["w"]).T)
        state[f"layers.{idx}.bias"] = _t(layer["b"])
    torch.save({"model_state_dict": state}, path)


def export_reference_matcher(params, cfg: MatcherConfig, tch_path: str,
                             prms_path: str) -> None:
    """Write a matcher tree as ``skeleton_matching.tch`` + ``.prms``."""
    state = {}
    for l, p in enumerate(params["layers"]):
        pre = f"layers.{l}."
        state[pre + "fc1.weight"] = _t(np.asarray(p["w1"]).T)
        state[pre + "fc2.weight"] = _t(np.asarray(p["w2"]).T)
        state[pre + "attn_l"] = _t(np.asarray(p["attn_l"])[..., None])
        state[pre + "attn_r"] = _t(np.asarray(p["attn_r"])[..., None])
        if "b1" in p:
            state[pre + "fc1.bias"] = _t(p["b1"])
            state[pre + "fc2.bias"] = _t(p["b2"])
        if "wr" in p:
            state[pre + "res_fc.weight"] = _t(np.asarray(p["wr"]).T)
            if "br" in p:
                state[pre + "res_fc.bias"] = _t(p["br"])
    torch.save(state, tch_path)
    prms = {
        "loss": 0.0,
        "net": "gat",
        "gnn_layers": len(cfg.hidden) + 1,
        "num_feats": int(cfg.in_dim),
        "num_hidden": [int(h) for h in cfg.hidden],
        "graph_type": "1",
        "n_classes": int(cfg.n_classes),
        "heads": [int(h) for h in cfg.heads],
        # the reference rebuilds its GAT with these modules, so the trained
        # slope rides along (the torch default 0.01 at
        # train_skeleton_matching.py:54)
        "nonlinearity": torch.nn.LeakyReLU(
            negative_slope=float(cfg.hidden_slope)),
        "final_activation": torch.nn.Sigmoid(),
        "in_drop": float(cfg.feat_drop),
        "attn_drop": float(cfg.attn_drop),
        "alpha": float(cfg.alpha),
        "residual": bool(cfg.residual),
    }
    with open(prms_path, "wb") as f:
        pickle.dump(prms, f)
