"""Checkpoint export to the reference's torch formats
(convert/torch_export.py) — round-trips through our importer and loads
strictly into the reference's own torch MLP class."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu.convert.torch_export import (export_reference_lifter,
                                            export_reference_matcher)
from mpe3d_tpu.convert.torch_import import (load_reference_lifter,
                                            load_reference_matcher)
from mpe3d_tpu.models.mlp import apply_lifter, init_lifter

import torch_testing  # noqa: F401

torch = pytest.importorskip("torch")


def _tree_equal(a, b):
    ja, jb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(ja) == len(jb)
    for x, y in zip(ja, jb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_lifter_export_roundtrip(tmp_path):
    cfg = LifterConfig(in_dim=32, out_dim=9, widths=(16, 8))
    params = init_lifter(jax.random.PRNGKey(3), cfg)
    path = str(tmp_path / "pose_estimator.pytorch")
    export_reference_lifter(params, path, cfg=cfg)
    back, back_cfg = load_reference_lifter(path)
    _tree_equal(params, back)
    assert (back_cfg.in_dim, back_cfg.out_dim, back_cfg.widths) == \
        (cfg.in_dim, cfg.out_dim, cfg.widths)


def test_lifter_export_loads_into_reference_mlp(tmp_path):
    """Strict state_dict load into the reference's own PoseEstimatorMLP
    (/root/reference/utils/mlp.py) + forward parity vs apply_lifter."""
    ref_mlp = "/root/reference/utils/mlp.py"
    if not os.path.exists(ref_mlp):
        pytest.skip("reference checkout not available")
    spec = importlib.util.spec_from_file_location("ref_mlp", ref_mlp)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    cfg = LifterConfig(in_dim=PANOPTIC.lifter_input_dim,
                       out_dim=PANOPTIC.n_joints * 3)   # reference widths
    params = init_lifter(jax.random.PRNGKey(4), cfg)
    path = str(tmp_path / "pose_estimator.pytorch")
    export_reference_lifter(params, path, cfg=cfg)

    model = mod.PoseEstimatorMLP(cfg.in_dim, cfg.out_dim)
    saved = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(saved["model_state_dict"], strict=True)
    model.eval()

    x = np.random.default_rng(0).normal(size=(2, cfg.in_dim)) \
        .astype(np.float32)
    with torch.no_grad():
        ref_out = model(torch.from_numpy(x)).numpy()
    ours = np.asarray(apply_lifter(params, jnp.asarray(x), cfg))
    np.testing.assert_allclose(ours, ref_out, atol=2e-4)


def test_lifter_export_refuses_residual_prior(tmp_path):
    cfg = LifterConfig(in_dim=32, out_dim=9, widths=(16,),
                       residual_prior=True)
    params = init_lifter(jax.random.PRNGKey(5), cfg)
    with pytest.raises(ValueError, match="residual-prior"):
        export_reference_lifter(params, str(tmp_path / "x.pytorch"),
                                cfg=cfg)


@pytest.mark.parametrize("residual", [False, True])
def test_matcher_export_roundtrip(tmp_path, residual):
    from mpe3d_tpu.models.gat import init_matcher

    cfg = MatcherConfig(in_dim=24, hidden=(8, 6), heads=(2, 3),
                        residual=residual, feat_drop=0.1, attn_drop=0.2,
                        hidden_slope=0.2)
    params = init_matcher(jax.random.PRNGKey(6), cfg)
    tch = str(tmp_path / "skeleton_matching.tch")
    prms = str(tmp_path / "skeleton_matching.prms")
    export_reference_matcher(params, cfg, tch, prms)
    back, back_cfg = load_reference_matcher(tch, prms)
    _tree_equal(params, back)
    for f in ("in_dim", "hidden", "heads", "n_classes", "alpha",
              "residual", "feat_drop", "attn_drop", "hidden_slope"):
        assert getattr(back_cfg, f) == getattr(cfg, f), f


def test_lifter_export_refuses_nonreference_slope(tmp_path):
    cfg = LifterConfig(in_dim=32, out_dim=9, widths=(16,),
                       negative_slope=0.2)
    params = init_lifter(jax.random.PRNGKey(9), cfg)
    with pytest.raises(ValueError, match="negative_slope"):
        export_reference_lifter(params, str(tmp_path / "x.pytorch"),
                                cfg=cfg)


def test_cli_export_torch_roundtrip(tmp_path):
    """CLI surface: save npz checkpoints, export-torch, re-import."""
    from mpe3d_tpu.cli import main
    from mpe3d_tpu.models.gat import init_matcher
    from mpe3d_tpu.train.checkpoint import save_checkpoint

    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim,
                         hidden=(8,), heads=(2,))
    mparams = init_matcher(jax.random.PRNGKey(7), mcfg)
    lcfg = LifterConfig(in_dim=PANOPTIC.lifter_input_dim,
                        out_dim=PANOPTIC.n_joints * 3, widths=(16,))
    lparams = init_lifter(jax.random.PRNGKey(8), lcfg)
    src = tmp_path / "models"
    src.mkdir()
    save_checkpoint(str(src / "skeleton_matching"), mparams,
                    meta={"matcher_config": mcfg})
    save_checkpoint(str(src / "pose_estimator"), lparams,
                    meta={"lifter_config": lcfg})
    out = tmp_path / "torch"
    main(["export-torch", "--modelsdir", str(src), "--out", str(out)])
    back_m, back_mcfg = load_reference_matcher(
        str(out / "skeleton_matching.tch"),
        str(out / "skeleton_matching.prms"))
    _tree_equal(mparams, back_m)
    assert back_mcfg.hidden == mcfg.hidden
    back_l, back_lcfg = load_reference_lifter(
        str(out / "pose_estimator.pytorch"))
    _tree_equal(lparams, back_l)
    assert back_lcfg.widths == lcfg.widths
