"""``infer_stream``, ``warmup`` and ``reload_weights`` of the port on the CPU.

``infer_stream`` at depth 1 and 3 must give ``infer_fused``'s outputs in
order, bit for bit, and the JAX package's ``infer_stream`` on the same
frames, built as ``tests/test_torch_pipeline.py`` builds it on
``models_demo/pan_irls_bf16`` (tolerances and their reasons there: persons
equal, scores 1e-5, poses 1e-2 m, quality 0.5 px), with both matchers.
``reload_weights`` must give the outputs of a pipeline built fresh on the
new weights, and refuse a shape mismatch or an int8 tree for a pipeline
that does not serve int8, leaving the outputs as they were.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import load_lifter_checkpoint
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

import torch_testing  # noqa: F401

MODELS = os.path.join(os.path.dirname(__file__), "..", "models_demo")
DEMO = os.path.join(MODELS, "pan_irls_bf16")
N_FRAMES = 6


@pytest.fixture(scope="module")
def setup():
    mparams, mcfg, lparams, lcfg, prior = load_models(DEMO, J_PANOPTIC)
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        DEMO, rig, device="cpu", slot_buckets=(4,), person_buckets=(8,))
    rtree = weights.random_matcher_tree(port.matcher.cfg, 0)
    jax_pipes = {
        name: JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), m, mcfg, lparams,
                        lcfg, slot_buckets=(4,), person_buckets=(8,),
                        use_frame_kernel=False, serve_dtype=jnp.bfloat16,
                        lifter_prior=prior)
        for name, m in (("trained", mparams),
                        ("random", jax.tree_util.tree_map(jnp.asarray,
                                                          rtree)))}
    matchers = {"trained": port.matcher,
                "random": weights.matcher_from_tree(rtree, port.matcher.cfg,
                                                    "cpu")}
    wire = generate_frames(PANOPTIC, rig, N_FRAMES, n_people=(2, 3), seed=1)
    return port, matchers, jax_pipes, wire


def _assert_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a.n_heads == b.n_heads


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_infer_stream_matches_infer_fused_and_jax(setup, matcher):
    port, matchers, jax_pipes, wire = setup
    port.matcher = matchers[matcher]
    frames = [parse_frame(f, PANOPTIC) for f in wire]
    loop = [port.infer_fused(f) for f in frames]
    for depth in (1, 3):
        got = list(port.infer_stream(iter(frames), depth=depth))
        assert len(got) == len(frames)
        for a, b in zip(got, loop):
            _assert_equal(a, b)
    from mpe3d_tpu.data.frames import parse_frame as j_parse
    ref = list(jax_pipes[matcher].infer_stream(
        [j_parse(f, J_PANOPTIC) for f in wire], depth=3))
    n_persons = 0
    for b, a in zip(loop, ref):
        np.testing.assert_array_equal(b.persons, a.persons)
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        np.testing.assert_allclose(b.poses, a.poses, atol=1e-2)
        np.testing.assert_allclose(b.quality, a.quality, atol=0.5)
        n_persons += len(b.persons)
    if matcher == "random":
        assert n_persons >= 2 * N_FRAMES


def _narrow(device="cpu", serve_dtype=None, slots=(4,), seed=0):
    """A narrow pipeline with numpy-seeded weights."""
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim,
                         hidden=(8, 8), heads=(2, 2))
    lcfg = LifterConfig(widths=(64, 64))
    return PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(weights.random_matcher_tree(mcfg, seed),
                                  mcfg, device),
        weights.lifter_from_tree(weights.random_lifter_tree(lcfg, seed + 1),
                                 lcfg, device, serve_dtype),
        slot_buckets=slots, person_buckets=(8, 16), threshold=0.05,
        decode_top_k=0, device=device)


@pytest.fixture(scope="module")
def narrow_frames():
    wire = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 3,
                           n_people=(2, 3), seed=7)
    return [parse_frame(f, PANOPTIC, max_skeletons=4) for f in wire]


def _outputs(pipe, frames):
    return [pipe.infer_fused(f) for f in frames]


def test_warmup_runs_every_slot_bucket():
    pipe = _narrow(slots=(2, 4, 10))
    pipe.warmup()
    assert sorted(pipe._topos) == [2, 4, 10]
    one = _narrow(slots=(2, 4))
    one.warmup(slots=4)
    assert sorted(one._topos) == [4]
    # the staged path: the match of each slot bucket, the lifter on each
    # person bucket's rows (or the given count)
    staged = _narrow(slots=(2, 4))
    staged.warmup(persons=8)
    staged.warmup(fused=False)
    assert sorted(staged._topos) == [2, 4]


@pytest.mark.parametrize("serve_dtype", [None, "int8", "fp32"])
def test_reload_weights_equals_a_fresh_pipeline(narrow_frames, serve_dtype):
    pipe = _narrow(serve_dtype=serve_dtype)
    before = _outputs(pipe, narrow_frames)
    fresh = _narrow(serve_dtype=serve_dtype, seed=10)
    m, l = pipe.matcher, pipe.lifter
    pipe.reload_weights(
        matcher_tree=weights.random_matcher_tree(m.cfg, 10),
        lifter_tree=weights.random_lifter_tree(l.cfg, 11))
    assert pipe.matcher is not m and pipe.lifter is not l
    assert pipe.lifter.serve_dtype == pipe.serve_dtype == l.serve_dtype
    got, ref = _outputs(pipe, narrow_frames), _outputs(fresh, narrow_frames)
    for a, b in zip(got, ref):
        _assert_equal(a, b)
    assert sum(len(o.persons) for o in got) >= 2
    assert any(not np.array_equal(a.poses, b.poses)
               for a, b in zip(got, before) if len(a.poses) == len(b.poses))
    # the lifter alone
    pipe.reload_weights(lifter_tree=weights.random_lifter_tree(l.cfg, 1))
    assert pipe.matcher.cfg == m.cfg


def test_reload_weights_refuses_a_mismatch(narrow_frames):
    pipe = _narrow()
    before = _outputs(pipe, narrow_frames)
    m, l = pipe.matcher, pipe.lifter
    bad = [dict(lifter_tree=weights.random_lifter_tree(
               LifterConfig(widths=(32,)), 2)),
           dict(lifter_tree=weights.random_lifter_tree(
               LifterConfig(widths=(64, 32)), 2)),
           dict(matcher_tree=weights.random_matcher_tree(
               MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim,
                             hidden=(8, 8), heads=(4, 2)), 2)),
           # a good matcher with a bad lifter: nothing is swapped
           dict(matcher_tree=weights.random_matcher_tree(m.cfg, 3),
                lifter_tree=weights.random_lifter_tree(
                    LifterConfig(widths=(64,)), 3))]
    for kw in bad:
        with pytest.raises(ValueError):
            pipe.reload_weights(**kw)
        assert pipe.matcher is m and pipe.lifter is l
    for a, b in zip(_outputs(pipe, narrow_frames), before):
        _assert_equal(a, b)


def test_reload_weights_refuses_int8_into_bf16():
    """The int8 export models_demo/pan_res into a pipeline serving bf16."""
    tree, cfg, _ = load_lifter_checkpoint(
        os.path.join(MODELS, "pan_res", "pose_estimator"),
        LifterConfig(in_dim=PANOPTIC.lifter_input_dim))
    pipe = _narrow()
    lifter = pipe.lifter
    with pytest.raises(ValueError, match="int8"):
        pipe.reload_weights(lifter_tree=tree)
    assert pipe.lifter is lifter and pipe.serve_dtype == "bf16"


def test_submit_is_serialised_across_threads(narrow_frames):
    """Submits from several threads give each ticket its own outputs (the
    CPU path, whose ticket holds the outputs themselves)."""
    import threading

    pipe = _narrow()
    ref = _outputs(pipe, narrow_frames)
    got, errors = {}, []

    def worker(k):
        try:
            tickets = [pipe.submit_fused(f) for f in narrow_frames]
            got[k] = [pipe.collect_fused(t) for t in tickets]
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for outs in got.values():
        for a, b in zip(outs, ref):
            _assert_equal(a, b)
