"""The port's reference-format model files against the JAX package's
converters on the CPU.

``convert/torch_export.py`` and ``convert/torch_import.py`` must write and
read the files the JAX package writes and reads: a port export read by
the JAX importer, and a JAX export read by the port's importer, give equal
arrays and configs (residual and plain matchers with their slopes and
dropout rates; the lifter), and the lifter export refuses what the JAX one
refuses.  ``convert/gat2_replica.py`` (the reference's GAT without DGL)
saved in the reference's layout and read by the port's importer: the
port's GAT (the stack's and the layer form's plain versions) gives its
scores within 1e-5 on the reference's graph of present heads and live
pairs, plain and residual.  A reference-format lifter serves in the port
as the JAX importer's tree does in JAX (``apply_lifter``, fp32).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.convert import torch_export as jexport
from mpe3d_tpu.convert import torch_import as jimport
from mpe3d_tpu.models.gat import init_matcher
from mpe3d_tpu.models.mlp import apply_lifter, init_lifter
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig
from mpe3d_tpu_torch.convert import torch_export, torch_import
from mpe3d_tpu_torch.convert.gat2_replica import (build_gat2_replica,
                                                  build_real_graph)
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.models.gat import gat_topology

MATCHER_FIELDS = ("in_dim", "hidden", "heads", "n_classes", "alpha",
                  "residual", "feat_drop", "attn_drop", "hidden_slope")


def _leaves(tree):
    return [np.asarray(v) for layer in tree["layers"]
            for _, v in sorted(layer.items())]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("residual", [False, True])
def test_matcher_files_both_ways(tmp_path, residual):
    cfg = MatcherConfig(in_dim=24, hidden=(8, 6), heads=(2, 3),
                        residual=residual, feat_drop=0.1, attn_drop=0.2,
                        hidden_slope=0.2)
    tree = weights.random_matcher_tree(cfg, 1)
    tch, prms = str(tmp_path / "p.tch"), str(tmp_path / "p.prms")
    torch_export.export_reference_matcher(tree, cfg, tch, prms)
    back, back_cfg = jimport.load_reference_matcher(tch, prms)
    _assert_trees_equal(tree, back)
    for f in MATCHER_FIELDS:
        assert getattr(back_cfg, f) == getattr(cfg, f), f
    # JAX's export read by the port
    jcfg = JMatcherConfig(**dataclasses.asdict(cfg))
    jtree = jax.tree_util.tree_map(np.asarray,
                                   init_matcher(jax.random.PRNGKey(2), jcfg))
    jtch, jprms = str(tmp_path / "j.tch"), str(tmp_path / "j.prms")
    jexport.export_reference_matcher(jtree, jcfg, jtch, jprms)
    got, got_cfg = torch_import.load_reference_matcher(jtch, jprms)
    _assert_trees_equal(jtree, got)
    assert got_cfg == cfg
    # the state dicts the two exporters write are the same
    a, b = torch.load(tch, weights_only=False), torch.load(jtch,
                                                           weights_only=False)
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape for k in a)


def test_lifter_files_both_ways(tmp_path):
    cfg = LifterConfig(in_dim=32, out_dim=9, widths=(16, 8))
    tree = weights.random_lifter_tree(cfg, 3)
    path = str(tmp_path / "p.pytorch")
    torch_export.export_reference_lifter(tree, path, cfg=cfg)
    back, back_cfg = jimport.load_reference_lifter(path)
    _assert_trees_equal(tree, back)
    assert (back_cfg.in_dim, back_cfg.out_dim, back_cfg.widths) == (
        32, 9, (16, 8))
    jcfg = JLifterConfig(in_dim=32, out_dim=9, widths=(16, 8))
    jtree = jax.tree_util.tree_map(np.asarray,
                                   init_lifter(jax.random.PRNGKey(4), jcfg))
    jpath = str(tmp_path / "j.pytorch")
    jexport.export_reference_lifter(jtree, jpath, cfg=jcfg)
    got, got_cfg = torch_import.load_reference_lifter(jpath)
    _assert_trees_equal(jtree, got)
    assert got_cfg == cfg
    # served in the port (fp32) as JAX serves the same file
    x = np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32)
    lifter = weights.lifter_from_tree(got, got_cfg, "cpu", "fp32")
    with torch.no_grad():
        out = lifter(torch.from_numpy(x)).numpy()
    ref = np.asarray(apply_lifter(jimport.load_reference_lifter(jpath)[0],
                                  jnp.asarray(x), jcfg))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("cfg, message", [
    (LifterConfig(in_dim=32, out_dim=9, widths=(16,), residual_prior=True),
     "residual-prior"),
    (LifterConfig(in_dim=32, out_dim=9, widths=(16,), negative_slope=0.2),
     "negative_slope"),
    (None, "requires cfg")])
def test_lifter_export_refusals(tmp_path, cfg, message):
    tree = weights.random_lifter_tree(LifterConfig(in_dim=32, out_dim=9,
                                                   widths=(16,)), 5)
    with pytest.raises(ValueError, match=message):
        torch_export.export_reference_lifter(tree, str(tmp_path / "x"),
                                             cfg=cfg)


@pytest.mark.parametrize("residual", [False, True])
def test_port_gat_matches_gat2_replica(tmp_path, residual):
    """The reference GAT's replica against the port's plain GAT (stack
    form, and the per-layer form that serves residual matchers) on one
    alt-3 scene of 3 cameras x 2 slots with one absent head."""
    torch.manual_seed(0)
    in_dim, hidden, heads, alpha = 16, (8, 6), (2, 3), 0.15
    topo = build_topology(3, 2)
    head_mask = np.array([1, 1, 1, 0, 1, 1], bool)
    rng = np.random.default_rng(1)
    feats_h = rng.normal(size=(topo.n_heads, in_dim)).astype(np.float32)
    feats_h[~head_mask] = 0.0
    feats_h[:, 0], feats_h[:, 1] = head_mask, 0.0
    feats_e = np.zeros((topo.n_pairs, in_dim), np.float32)
    feats_e[:, 1] = 1.0
    pair_mask = (head_mask[topo.e1] & head_mask[topo.e2]).astype(np.float32)
    real_heads, src, dst, real_pairs, H = build_real_graph(topo, head_mask,
                                                           pair_mask)
    x = np.concatenate([feats_h[real_heads], feats_e[:len(real_pairs)]])
    model = build_gat2_replica(in_dim, hidden, heads, alpha=alpha,
                               residual=residual)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), src, dst).numpy()[H:]
    torch.save(model.state_dict(), tmp_path / "m.tch")
    with open(tmp_path / "m.prms", "wb") as f:
        pickle.dump({"num_feats": in_dim, "num_hidden": list(hidden),
                     "heads": list(heads), "n_classes": 1, "alpha": alpha,
                     "residual": residual, "in_drop": 0.0, "attn_drop": 0.0,
                     "net": "gat", "graph_type": "3"}, f)
    tree, cfg = torch_import.load_reference_matcher(
        str(tmp_path / "m.tch"), str(tmp_path / "m.prms"))
    assert cfg.residual == residual
    matcher = weights.matcher_from_tree(tree, cfg, "cpu")
    x_all = torch.from_numpy(np.concatenate([feats_h, feats_e]))
    pw = torch.from_numpy(pair_mask)
    forms = ("layer",) if residual else ("stack", "layer")
    for form in forms:
        with torch.no_grad():
            got = torch.sigmoid(matcher(x_all, pw, gat_topology(
                topo, "cpu", form), form)).numpy()
        np.testing.assert_allclose(got[real_pairs], ref, atol=1e-5, rtol=0,
                                   err_msg=form)
