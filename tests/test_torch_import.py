"""Parity tests for the reference-torch checkpoint importers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpe3d_tpu.config import MatcherConfig  # noqa: E402
from mpe3d_tpu.convert.torch_import import (load_reference_lifter,  # noqa: E402
                                            load_reference_matcher)
from mpe3d_tpu.models.mlp import apply_lifter  # noqa: E402

import torch_testing  # noqa: E402,F401


def _reference_mlp(in_dim=1260, out_dim=54):
    """The reference lifter architecture (utils/mlp.py:3-31), rebuilt in
    torch for a weight-level parity check (not copied — the topology is the
    spec)."""
    import torch.nn as nn
    widths = [3072, 3072, 2048, 2048, 1024, 1024, 1024, 1024]
    dims = [in_dim] + widths + [out_dim]
    layers = [nn.Flatten()]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(nn.Linear(a, b))
        if i < len(dims) - 2:
            layers.append(nn.LeakyReLU(negative_slope=0.1))
    return nn.Sequential(*layers)


def test_lifter_import_matches_torch(tmp_path):
    torch.manual_seed(0)
    model = _reference_mlp()
    path = str(tmp_path / "pose_estimator.pytorch")
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()}, path)

    params, cfg = load_reference_lifter(path)
    assert cfg.in_dim == 1260 and cfg.out_dim == 54
    assert cfg.widths == (3072, 3072, 2048, 2048, 1024, 1024, 1024, 1024)

    x = np.random.default_rng(1).normal(size=(3, 1260)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    got = np.asarray(apply_lifter(params, jnp.asarray(x), cfg))
    assert np.allclose(got, ref, atol=2e-3), np.abs(got - ref).max()


def test_matcher_import_shapes(tmp_path):
    """Importer reads a gat2-shaped state_dict + prms pickle correctly."""
    import pickle

    cfg = MatcherConfig()
    state = {}
    d_in = cfg.in_dim
    dims = list(zip(list(cfg.hidden) + [cfg.n_classes],
                    list(cfg.heads) + [1]))
    for l, (d_out, nh) in enumerate(dims):
        state[f"layers.{l}.fc1.weight"] = torch.randn(d_in, d_in)
        state[f"layers.{l}.fc1.bias"] = torch.randn(d_in)
        state[f"layers.{l}.fc2.weight"] = torch.randn(nh * d_out, d_in)
        state[f"layers.{l}.fc2.bias"] = torch.randn(nh * d_out)
        state[f"layers.{l}.attn_l"] = torch.randn(nh, d_out, 1)
        state[f"layers.{l}.attn_r"] = torch.randn(nh, d_out, 1)
        d_in = nh * d_out
    tch = str(tmp_path / "skeleton_matching.tch")
    torch.save(state, tch)
    prms = {"num_feats": cfg.in_dim, "num_hidden": list(cfg.hidden),
            "heads": list(cfg.heads), "n_classes": 1, "alpha": 0.15,
            "residual": False, "gnn_layers": 5}
    prms_path = str(tmp_path / "skeleton_matching.prms")
    with open(prms_path, "wb") as f:
        pickle.dump(prms, f)

    params, got_cfg = load_reference_matcher(tch, prms_path)
    assert got_cfg.hidden == cfg.hidden and got_cfg.heads == cfg.heads
    assert len(params["layers"]) == 5
    l0 = params["layers"][0]
    assert l0["w1"].shape == (902, 902)
    assert l0["w2"].shape == (902, 400)
    assert l0["attn_l"].shape == (10, 40)
    assert l0["b1"].shape == (902,)
    # transposition check: torch [out, in] → ours [in, out]
    assert np.allclose(l0["w2"][5, 7],
                       state["layers.0.fc2.weight"].numpy()[7, 5])