"""The alt-1 and alt-2 matcher graphs and the BODY_25 joint format on the
CPU, against the JAX package (the counterparts of ``tests/test_alt1.py``
and ``tests/test_alternatives.py``, training aside):

* alt-2 head features (4 numbers a (camera, joint)), one frame and a batch
  of frames, and the alt-2 pipeline (eager path, stack form);
* the alt-1 vocabularies with the left-ear quirk, its topology arrays in
  both joint formats, node features, ``apply_matcher_alt1`` with and
  without the residual shortcut (scores within 1e-5), both ear cases, and
  the alt-1 pipeline end to end (matcher form ``"alt1"``, eager path);
* BODY_25: dims, the parser at J=25, and the pipeline end to end on the
  frame path's plain versions and the eager path.

Pipelines compare ``infer_fused``, the staged path and ``infer_batch``:
persons equal, scores within 1e-5, poses within 1e-2 m.
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
from mpe3d_tpu.matching import alt1 as jalt1
from mpe3d_tpu.matching.features import build_topology as j_topology
from mpe3d_tpu.matching.features import head_features as j_head_features
from mpe3d_tpu.models.gat import init_matcher
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.matching import alt1
from mpe3d_tpu_torch.matching.features import (build_topology,
                                               edge_node_features,
                                               head_features)
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

import torch_testing  # noqa: F401

SCORE_TOL = 1e-5
POSE_TOL_M = 1e-2
FORMATS = {"COCO": 18, "BODY_25": 25}


def _b25(rig_config):
    # BODY_25 accuracy joints as tests/test_alternatives.py picks them
    return dataclasses.replace(
        rig_config, joint_format="BODY_25",
        used_joints=(0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14))


def _buffers(rng, C, S, J):
    kp = rng.uniform(50, 900, size=(C, S, J, 2)).astype(np.float32)
    prob = rng.uniform(0.5, 1.0, size=(C, S, J)).astype(np.float32)
    valid = (rng.random((C, S, J)) > 0.15).astype(np.float32)
    observed = rng.random((C, S, J)) > 0.1
    return kp, valid, prob, observed


# ---- alt-2 -----------------------------------------------------------------

def test_alt2_feature_dims():
    for alt in ("1", "2", "3"):
        assert (PANOPTIC.matcher_feature_dim_alt(alt)
                == J_PANOPTIC.matcher_feature_dim_alt(alt))
    assert PANOPTIC.matcher_feature_dim_alt("2") == 362


@pytest.mark.parametrize("batch", [False, True])
def test_alt2_head_features(batch):
    rng = np.random.default_rng(2)
    C, S, J = 5, 3, 18
    frames = []
    for _ in range(2):
        kp, valid, prob, observed = _buffers(rng, C, S, J)
        present = rng.random((C, S)) > 0.3
        frames.append((kp, valid, prob, observed, present))
    rig = synthetic_ring_rig(PANOPTIC)
    jrig = j_ring(J_PANOPTIC)
    img = (1920.0, 1080.0)
    refs = [np.asarray(j_head_features(*map(jnp.asarray, f), jrig, img,
                                       alt="2")[0]) for f in frames]
    T = [torch.as_tensor(np.stack(a)) for a in zip(*frames)]
    if batch:
        got = head_features(*T, rig, img, alt="2")[0].numpy()
        np.testing.assert_allclose(got, np.stack(refs), atol=1e-6)
    else:
        for f, ref in zip(frames, refs):
            got = head_features(*map(torch.as_tensor, f), rig, img,
                                alt="2")[0].numpy()
            assert got.shape == (C * S, 362)
            np.testing.assert_allclose(got, ref, atol=1e-6)


# ---- alt-1 -----------------------------------------------------------------

@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_alt1_vocabulary_and_topology(fmt):
    assert alt1.alt1_relations(fmt) == jalt1.alt1_relations(fmt)
    assert alt1._abbr_candidates(fmt) == jalt1._abbr_candidates(fmt)
    assert alt1._BODY_PARTS_ABBREVIATION["left_ear"] == "re"
    for C, S in ((3, 2), (5, 4)):
        ref = jalt1.build_alt1_topology(j_topology(C, S), FORMATS[fmt], fmt)
        got = alt1.build_alt1_topology(build_topology(C, S), FORMATS[fmt],
                                       fmt)
        assert got._fields == ref._fields
        for name, a, b in zip(got._fields, got, ref):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
        assert got.n_nodes == ref.n_nodes
    assert alt1.alt1_feature_dim(25, 6) == jalt1.alt1_feature_dim(25, 6)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("fmt, drop_right_ear",
                         [("COCO", False), ("COCO", True), ("BODY_25", False)])
def test_alt1_matcher_against_jax(fmt, drop_right_ear, residual):
    """Node features and scores of the alt-1 GAT; both ears live isolates
    the left ear, the right ear absent gives the left one its edges."""
    C, S, J = 3, 2, FORMATS[fmt]
    names = PANOPTIC.joint_names if fmt == "COCO" else _b25(
        PANOPTIC).joint_names
    rear, lear = names.index("right_ear"), names.index("left_ear")
    rng = np.random.default_rng(1)
    kp, valid, prob, observed = _buffers(rng, C, S, J)
    present = np.array([[1, 1], [1, 0], [1, 1]], bool)
    if drop_right_ear:
        valid[:, :, rear] = 0.0
    else:
        valid[:, :, [lear, rear]] = 1.0
        observed[:, :, [lear, rear]] = True
    img = (1920.0, 1080.0)
    F = alt1.alt1_feature_dim(J, C)
    jcfg = JMatcherConfig(in_dim=F, hidden=(6, 4), heads=(2, 2),
                          residual=residual)
    cfg = MatcherConfig(in_dim=F, hidden=(6, 4), heads=(2, 2),
                        residual=residual)
    params = init_matcher(jax.random.PRNGKey(5), jcfg)
    jt = j_topology(C, S)
    pm = (present.reshape(-1)[jt.e1]
          & present.reshape(-1)[jt.e2]).astype(np.float32)
    jf, jl = jalt1.alt1_node_features(*map(jnp.asarray, (kp, valid, prob,
                                                         observed, present)),
                                      img, fmt)
    jfeats = jnp.concatenate(
        [jf, jnp.asarray(jalt1.alt1_edge_node_features(jt.n_pairs, F))])
    ref = np.asarray(jalt1.apply_matcher_alt1(
        params, jfeats, jl, jnp.asarray(pm),
        jalt1.build_alt1_topology(jt, J, fmt), jcfg))

    f, live = alt1.alt1_node_features(*map(torch.as_tensor, (
        kp, valid, prob, observed, present)), img, fmt)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(live.numpy(), np.asarray(jl))
    topo = build_topology(C, S)
    graph = alt1.alt1_graph(alt1.build_alt1_topology(topo, J, fmt), "cpu")
    m = weights.matcher_from_tree(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, "cpu")
    got = alt1.apply_matcher_alt1(
        m, torch.cat([f, edge_node_features(topo.n_pairs, F)]), live,
        torch.as_tensor(pm), graph).numpy()
    np.testing.assert_allclose(got, ref, atol=SCORE_TOL)
    assert (pm > 0).sum() >= 4


# ---- pipelines -------------------------------------------------------------

def _pipelines(rig_config, jrig_config, mcfg_kw, use_frame_kernel,
               lifter=True, residual=False):
    """(JAX pipeline, port pipeline) on the same random matcher and lifter
    (a narrow bf16 lifter, or the triangulation backend)."""
    alt = rig_config.graph_alternative
    in_dim = rig_config.matcher_feature_dim_alt(alt)
    jcfg = JMatcherConfig(in_dim=in_dim, residual=residual, **mcfg_kw)
    cfg = MatcherConfig(in_dim=in_dim, residual=residual, **mcfg_kw)
    params = init_matcher(jax.random.PRNGKey(0), jcfg)
    common = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05)
    port_kw, j_kw = {}, {}
    if lifter:
        lcfg = LifterConfig(in_dim=rig_config.lifter_input_dim,
                            out_dim=rig_config.n_joints * 3, widths=(64,))
        ltree = weights.random_lifter_tree(lcfg, 1)
        j_kw = dict(lifter_params=jax.tree_util.tree_map(jnp.asarray, ltree),
                    lifter_cfg=JLifterConfig(**dataclasses.asdict(lcfg)),
                    serve_dtype=jnp.bfloat16)
        port_lifter = weights.lifter_from_tree(ltree, lcfg, "cpu")
    else:
        j_kw = port_kw = dict(backend="triangulation")
        port_lifter = None
    ref = JPipeline(jrig_config, j_ring(jrig_config), params, jcfg,
                    use_frame_kernel=False, **common, **j_kw)
    port = PoseEstimationPipeline(
        rig_config, synthetic_ring_rig(rig_config),
        weights.matcher_from_tree(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, "cpu"), port_lifter, device="cpu",
        use_frame_kernel=use_frame_kernel, **common, **port_kw)
    return ref, port


def _compare(ref, port, rig_config, jrig_config, seed, n_frames=2):
    wires = generate_frames(rig_config, synthetic_ring_rig(rig_config),
                            n_frames, n_people=(2, 2), seed=seed)
    n = 0
    for f in wires:
        jfa, fa = j_parse(f, jrig_config), parse_frame(f, rig_config)
        a = ref.infer_fused(jfa)
        for b, r in [(port.infer_fused(fa), a), (port(fa), ref(jfa)),
                     (port.infer_batch([fa])[0], a)]:
            np.testing.assert_array_equal(b.persons, r.persons)
            np.testing.assert_allclose(b.scores, r.scores, atol=SCORE_TOL)
            np.testing.assert_allclose(b.poses, r.poses, atol=POSE_TOL_M)
            assert b.poses.shape[1:] == (rig_config.n_joints, 3)
        n += len(a.persons)
    return n


@pytest.mark.parametrize("alt, residual, lifter", [
    ("2", False, True), ("2", True, False), ("1", False, False),
    ("1", True, True)])
def test_graph_alt_pipeline_against_reference(alt, residual, lifter):
    rc = dataclasses.replace(PANOPTIC, graph_alternative=alt)
    jrc = dataclasses.replace(J_PANOPTIC, graph_alternative=alt)
    ref, port = _pipelines(rc, jrc, dict(hidden=(8,), heads=(2,)), None,
                           lifter=lifter, residual=residual)
    form = {"1": "alt1", "2": "layer" if residual else "stack"}[alt]
    assert port.serving_path(4) == (form, False)
    assert port.batch_plan(4, 2).chunks == (1, 1)
    with pytest.raises(ValueError, match="does not serve"):
        port.use_frame_kernel = True
        port.serving_path(4)
    port.use_frame_kernel = None
    assert _compare(ref, port, rc, jrc, seed=4) >= 2


def test_body25_dims_and_parser():
    rc, jrc = _b25(PANOPTIC), _b25(J_PANOPTIC)
    assert dataclasses.asdict(rc) == dataclasses.asdict(jrc)
    assert (rc.n_joints, rc.lifter_input_dim, rc.matcher_feature_dim) == (
        jrc.n_joints, jrc.lifter_input_dim, jrc.matcher_feature_dim) == (
        25, 1750, 1252)
    frame = {"trackera": ['[{"24": [24, 5.0, 6.0, 1, 0.9], '
                          '"25": [25, 1.0, 1.0, 1, 1.0]}]', 0.0,
                          "no_image"]}
    got, ref = parse_frame(frame, rc, 2), j_parse(frame, jrc, 2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got.kp.shape == (5, 2, 25, 2) and got.in_view[0, 0, 24]


@pytest.mark.parametrize("frame_path", [True, False])
def test_body25_pipeline_against_reference(frame_path):
    rc, jrc = _b25(PANOPTIC), _b25(J_PANOPTIC)
    ref, port = _pipelines(rc, jrc, dict(hidden=(8,), heads=(2,)),
                           frame_path)
    assert port.serving_path(4) == ("stack", frame_path)
    assert _compare(ref, port, rc, jrc, seed=6) >= 2
