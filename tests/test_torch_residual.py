"""Residual and bias-free matchers on the CPU, against the JAX package.

The matchers are made with JAX's ``init_matcher`` (a residual matcher's
layers after the first carry the shortcut ``wr``/``br`` where their widths
differ, the identity where they agree; a bias-free one has no ``b1``/``b2``),
written with JAX's ``save_checkpoint`` in the npz layout and read back by
the port's ``checkpoint.py``.  Scores of the port's ``Matcher`` against
JAX's ``apply_matcher`` on the XLA path within 1e-5, and the pipelines on
the same frames: a residual matcher serves through the layer form on the
eager path (``serving_path`` reports ``"layer"``), as the reference keeps it
off its megakernel and tiled form; a bias-free one through the stack form
and the frame path, its biases packed as zeros.  Persons equal, scores
within 1e-5, poses within 1e-2 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching.features import build_topology as j_topology
from mpe3d_tpu.models.gat import TopologyArrays, apply_matcher, init_matcher
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu.train.checkpoint import save_checkpoint
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import (load_matcher_checkpoint,
                                        matcher_layer_keys)
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.models.gat import gat_topology
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

import torch_testing  # noqa: F401

SCORE_TOL = 1e-5
POSE_TOL_M = 1e-2
# (residual, bias); hidden 16 x 1 head makes layer 1 an identity shortcut
VARIANTS = [(True, True), (True, False), (False, False)]
ARCH = dict(hidden=(8, 16), heads=(2, 1))


def _configs(residual, bias, in_dim=PANOPTIC.matcher_feature_dim):
    return (JMatcherConfig(in_dim=in_dim, residual=residual, bias=bias,
                           **ARCH),
            MatcherConfig(in_dim=in_dim, residual=residual, bias=bias,
                          **ARCH))


def _round_trip(tmp_path, params, jcfg, cfg):
    stem = str(tmp_path / "skeleton_matching")
    save_checkpoint(stem, params, meta={"matcher_config": jcfg})
    tree, got_cfg = load_matcher_checkpoint(stem, MatcherConfig())
    assert (got_cfg.residual, got_cfg.bias, got_cfg.hidden, got_cfg.heads,
            got_cfg.in_dim) == (cfg.residual, cfg.bias, cfg.hidden,
                                cfg.heads, cfg.in_dim)
    return tree, got_cfg


@pytest.mark.parametrize("residual, bias", VARIANTS)
def test_checkpoint_layout_round_trip(tmp_path, residual, bias):
    jcfg, cfg = _configs(residual, bias)
    params = init_matcher(jax.random.PRNGKey(3), jcfg)
    tree, _ = _round_trip(tmp_path, params, jcfg, cfg)
    keys = matcher_layer_keys(cfg)
    for ref, got, k in zip(params["layers"], tree["layers"], keys):
        assert tuple(sorted(ref)) == k == tuple(sorted(got))
        for name in k:
            np.testing.assert_array_equal(got[name], np.asarray(ref[name]))
    # the numpy-seeded tree has the same keys and shapes
    rnd = weights.random_matcher_tree(cfg, 0)
    for ref, got in zip(params["layers"], rnd["layers"]):
        assert {k: v.shape for k, v in ref.items()} == {
            k: v.shape for k, v in got.items()}
    if residual:
        # layer 0: no shortcut; layer 1 (16 -> 16): the identity; the
        # output layer (16 -> 1): a projection
        assert ["wr" in layer for layer in tree["layers"]] == [False, False,
                                                                True]


@pytest.mark.parametrize("residual, bias", VARIANTS)
def test_matcher_scores_against_apply_matcher(tmp_path, residual, bias):
    C, S = 3, 3
    jcfg, cfg = _configs(residual, bias, in_dim=40)
    params = init_matcher(jax.random.PRNGKey(7), jcfg)
    tree, cfg = _round_trip(tmp_path, params, jcfg, cfg)
    rng = np.random.default_rng(11)
    topo = build_topology(C, S)
    H, E = topo.n_heads, topo.n_pairs
    xh = rng.normal(size=(H, 40)).astype(np.float32)
    xe = np.zeros((E, 40), np.float32)
    xe[:, 1] = 1.0
    pm = (rng.random(E) > 0.3).astype(np.float32)
    ref = np.asarray(apply_matcher(
        params, jnp.asarray(xh), jnp.asarray(xe),
        TopologyArrays.from_topology(j_topology(C, S)), jnp.asarray(pm),
        jcfg))
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    x = torch.cat([torch.from_numpy(xh), torch.from_numpy(xe)])
    forms = ["layer"] + ([] if residual else ["stack", "tiled"])
    for form in forms:
        got = torch.sigmoid(m(x, torch.from_numpy(pm),
                              gat_topology(topo, "cpu", form), form)).numpy()
        np.testing.assert_allclose(got, ref, atol=SCORE_TOL, err_msg=form)
    if residual:
        with pytest.raises(ValueError, match="layer form"):
            m(x, torch.from_numpy(pm), gat_topology(topo, "cpu"), "stack")


@pytest.mark.parametrize("residual, bias", VARIANTS)
def test_pipeline_against_reference(residual, bias):
    jcfg, cfg = _configs(residual, bias)
    params = init_matcher(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    lcfg = LifterConfig(in_dim=PANOPTIC.lifter_input_dim,
                        out_dim=PANOPTIC.n_joints * 3, widths=(64,))
    ltree = weights.random_lifter_tree(lcfg, 1)
    jl = jax.tree_util.tree_map(jnp.asarray, ltree)
    jlcfg = JLifterConfig(**dataclasses.asdict(lcfg))
    common = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05)
    ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), params, jcfg, jl, jlcfg,
                    use_frame_kernel=False, serve_dtype=jnp.bfloat16,
                    **common)
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline(
        PANOPTIC, rig, weights.matcher_from_tree(tree, cfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), device="cpu",
        use_frame_kernel=None if residual else True, **common)
    assert port.serving_path(4) == (("layer", False) if residual
                                    else ("stack", True))
    if residual:
        assert port.batch_plan(4, 3).chunks == (1, 1, 1)
        with pytest.raises(ValueError, match="does not serve"):
            PoseEstimationPipeline(
                PANOPTIC, rig, port.matcher, port.lifter, device="cpu",
                use_frame_kernel=True, **common).serving_path(4)
    wires = generate_frames(PANOPTIC, rig, 2, n_people=(2, 3), seed=4)
    n = 0
    for f in wires:
        jfa, fa = j_parse(f, J_PANOPTIC), parse_frame(f, PANOPTIC)
        a = ref.infer_fused(jfa)
        # the staged path (host decode) against the reference's
        for b, a in [(port.infer_fused(fa), a), (port(fa), ref(jfa)),
                     (port.infer_batch([fa])[0], a)]:
            np.testing.assert_array_equal(b.persons, a.persons)
            np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_TOL)
            np.testing.assert_allclose(b.poses, a.poses, atol=POSE_TOL_M)
        n += len(a.persons)
    assert n >= 2
