"""The per-layer GAT form of the port on the CPU against the JAX package:
the fused projection (plain version), the layer form of the matcher, and
``infer_fused`` with ``use_layer_matcher``.

Tolerances: the projection and the matcher scores 1e-5 (fp32 on both
sides, the reference at precision="highest"; only the order of sums
differs); the layer form equals the port's stack form exactly on the CPU
(the same per-layer math, the same projection); pipelines: persons equal
(int32), scores 1e-5, poses 1e-2 m (the bf16 lifter's rounding cascade).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.models.gat import TopologyArrays, apply_matcher
from mpe3d_tpu.ops.fused_proj import fused_linear_leaky_linear, xla_proj
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
from mpe3d_tpu_torch.config import PANOPTIC, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.models import gat as tgat
from mpe3d_tpu_torch.ops import fused_proj as tproj
from mpe3d_tpu_torch.pipeline import (PoseEstimationPipeline,
                                      resolve_serving_path)

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
ATOL = 1e-5
N_FRAMES = 6


def test_proj_against_reference():
    """37 rows x 50 -> 50 -> 24: the plain version and the CPU entry
    against the TPU kernel in interpret mode and its XLA form; the CPU
    entry launches nothing."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 50)).astype(np.float32)
    w1 = (rng.normal(size=(50, 50)) / 7).astype(np.float32)
    b1 = rng.normal(size=50).astype(np.float32)
    w2 = (rng.normal(size=(50, 24)) / 7).astype(np.float32)
    b2 = rng.normal(size=24).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    refs = [np.asarray(fused_linear_leaky_linear(*jargs, 0.15,
                                                 interpret=True)),
            np.asarray(xla_proj(*jargs, 0.15))]
    targs = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    launches = tproj.fused_linear_leaky_linear.launches
    got = tproj.proj_plain(*targs, 0.15).numpy()
    np.testing.assert_array_equal(
        tproj.fused_linear_leaky_linear(*targs, 0.15).numpy(), got)
    assert tproj.fused_linear_leaky_linear.launches == launches
    for ref in refs:
        np.testing.assert_allclose(got, ref, atol=ATOL)
    with pytest.raises(ValueError, match="unsupported device"):
        tproj.fused_linear_leaky_linear(*(t.to("meta") for t in targs), 0.15)


@pytest.fixture(scope="module")
def frame_inputs():
    """Alt-3 features of a synthetic Panoptic frame at S=4 (H=20, E=160)."""
    jr = j_ring(J_PANOPTIC)
    f = j_generate(J_PANOPTIC, jr, 1, n_people=(3, 3), seed=4)[0]
    fa = j_parse(f, J_PANOPTIC, 4)
    jtopo = jfeat.build_topology(5, 4)
    hf, _ = jfeat.head_features(fa.kp, fa.valid, fa.prob, fa.in_view,
                                fa.present, jr, (1920.0, 1080.0))
    pm = np.asarray(jfeat.pair_mask_from_present(jnp.asarray(fa.present),
                                                 jtopo))
    ef = jfeat.edge_node_features(jtopo.n_pairs, 902)
    return np.array(hf), np.array(ef), pm, jtopo


@pytest.mark.parametrize("weights_from", ["widefield", "random"])
def test_layer_form_against_xla(frame_inputs, weights_from):
    """The layer form against the reference's per-layer XLA stack
    (``apply_matcher`` with the whole-stack kernels off), and equal to the
    port's stack form."""
    hf, ef, pm, jtopo = frame_inputs
    if weights_from == "widefield":
        tree, cfg = load_matcher_checkpoint(
            os.path.join(DEMO, "widefield", "skeleton_matching"),
            MatcherConfig())
    else:
        cfg = MatcherConfig()
        tree = weights.random_matcher_tree(cfg, 0)
    jcfg = JMatcherConfig(hidden=cfg.hidden, heads=cfg.heads, alpha=cfg.alpha)
    assert not (jcfg.use_pallas_matcher or jcfg.use_tiled_matcher
                or jcfg.use_pallas_proj)
    ref = np.asarray(apply_matcher(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(hf),
        jnp.asarray(ef), TopologyArrays.from_topology(jtopo),
        jnp.asarray(pm), jcfg))
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    x = torch.cat([torch.from_numpy(hf), torch.from_numpy(ef)])
    topo = build_topology(5, 4)
    got = torch.sigmoid(m(x, torch.from_numpy(pm),
                          tgat.gat_topology(topo, "cpu", "layer"),
                          "layer")).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    stack = torch.sigmoid(m(x, torch.from_numpy(pm),
                            tgat.gat_topology(topo, "cpu", "stack"))).numpy()
    np.testing.assert_array_equal(got, stack)


def test_layer_form_resolution():
    """The layer form serves the eager path only: a bucket on the frame
    path keeps the stack or tiled form."""
    for S, form in ((4, "stack"), (10, "tiled")):
        assert resolve_serving_path(5, S, prune=False, layer=True) == (
            form, True)
        assert resolve_serving_path(5, S, prune=False, frame_ok=False,
                                    layer=True) == ("layer", False)
        assert resolve_serving_path(5, S, prune=False, frame_ok=False) == (
            form, False)


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_pipeline_layer_form(matcher):
    """``use_layer_matcher`` on the eager path against the reference
    pipeline with ``use_pallas_matcher=False`` (its XLA program runs
    ``_gat_layer``), on the trained ``pan_irls_bf16`` pair and with a
    numpy-seeded matcher."""
    d = os.path.join(DEMO, "pan_irls_bf16")
    mparams, mcfg, lparams, lcfg, prior = load_models(d, J_PANOPTIC)
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        d, rig, device="cpu", slot_buckets=(4,), person_buckets=(8,),
        use_layer_matcher=True)
    if matcher == "random":
        tree = weights.random_matcher_tree(port.matcher.cfg, 0)
        port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg,
                                                 "cpu")
        mparams = jax.tree_util.tree_map(jnp.asarray, tree)
    assert port.serving_path(4) == ("layer", False)
    ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mparams, mcfg, lparams,
                    lcfg, slot_buckets=(4,), person_buckets=(8,),
                    use_pallas_matcher=False, use_frame_kernel=False,
                    serve_dtype=jnp.bfloat16, lifter_prior=prior)
    n_persons = 0
    for f in generate_frames(PANOPTIC, rig, N_FRAMES, n_people=(2, 3),
                             seed=1):
        a = ref.infer_fused(j_parse(f, J_PANOPTIC))
        b = port.infer_fused(parse_frame(f, PANOPTIC))
        np.testing.assert_array_equal(b.persons, a.persons)
        assert b.persons.dtype == a.persons.dtype == np.int32
        np.testing.assert_allclose(b.scores, a.scores, atol=ATOL)
        np.testing.assert_allclose(b.poses, a.poses, atol=1e-2)
        n_persons += len(b.persons)
    if matcher == "random":
        assert n_persons >= 2 * N_FRAMES
