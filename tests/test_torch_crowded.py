"""Crowded buckets of the port on the CPU: the default slot buckets up to
S=10, the split frame path with pair pruning, and the per-bucket serving
path resolution.

* ``infer_fused`` on the reference's default buckets ``(2, 4, 10)`` /
  ``(4, 8, 16)`` against the JAX ``PoseEstimationPipeline.infer_fused``
  (two-stage program, bf16 lifter serving), on frames of 6-9 people that
  reach S=10 (E=1000 pairs: the tiled matcher form): persons equal (int32),
  scores within 1e-5, poses within 1e-2 m (the bf16 lifter's rounding
  cascade, as ``tests/test_torch_pipeline.py`` states).  Both packages pack
  the lifter input with the "mean" prior here: on these crowded frames the
  decode groups skeletons of different people, and the IRLS prior of such
  groups is ill-conditioned, so no fp32 tolerance holds between two
  implementations under it (``test_crowded_prior_sensitivity``).
* The split path with a gate loose enough to keep every pair (cap = E)
  gives the unpruned split path's persons; scores within 2e-5, the bound
  the reference's own test of this equivalence uses
  (``tests/test_pair_prune.py::test_split_prune_loose_matches_unpruned``):
  the pairs are reordered, so the head sums run in another order.
* Tight pruning: pruned pairs score exactly 0, and scores, persons and poses
  match the JAX split program ``build_frame_program(..., matcher="tiled")``
  in interpret mode with the same ``pair_prune_dist`` / ``pair_prune_cap``,
  at S=8 (the setup of ``tests/test_pair_prune.py``).
* ``serving_path`` for Panoptic S = 2, 4, 10, 16, 21 and an ARPLAB-shaped
  6 x 16 bucket, pruning on and off.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.models.mlp import init_lifter
from mpe3d_tpu.ops.frame_kernel import build_frame_program, pack_frame_serving
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.matching.features import pair_ray_distances
from mpe3d_tpu_torch.pipeline import (PoseEstimationPipeline,
                                      resolve_serving_path)

from torch_testing import default_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEMO = os.path.join(ROOT, "models_demo", "pan_irls_bf16")
SCORE_TOL = 1e-5
LOOSE_SCORE_TOL = 2e-5
POSE_TOL_M = 1e-2
BUCKETS = dict(slot_buckets=(2, 4, 10), person_buckets=(4, 8, 16))


def _random_matcher_tree(cfg):
    """numpy seed 0: its scores sit above the threshold, so the decode,
    pack and lifter run on persons."""
    return weights.random_matcher_tree(cfg, 0)


# ---------------------------------------------------------------------------
# default buckets up to S=10 against the JAX pipeline
# ---------------------------------------------------------------------------

def _crowded_frames(rig):
    return generate_frames(PANOPTIC, rig, 3, n_people=(6, 9), seed=3)


@pytest.fixture(scope="module")
def default_buckets():
    mparams, mcfg, lparams, lcfg, prior = load_models(DEMO, J_PANOPTIC)
    assert prior == "irls"
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(DEMO, rig, device="cpu",
                                                  **BUCKETS)
    port.lifter_prior = "mean"

    def jax_pipe(matcher_params):
        return JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), matcher_params, mcfg,
                         lparams, lcfg, use_frame_kernel=False,
                         serve_dtype=jnp.bfloat16, lifter_prior="mean",
                         **BUCKETS)
    return port, jax_pipe, mparams, _crowded_frames(rig)


@pytest.mark.usefixtures("default_threads")
@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_default_buckets_reach_s10_and_match_reference(default_buckets,
                                                       matcher):
    port, jax_pipe, mparams, frames = default_buckets
    if matcher == "random":
        tree = _random_matcher_tree(port.matcher.cfg)
        port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg,
                                                 "cpu")
        mparams = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = jax_pipe(mparams)
    assert port.serving_path(10) == ("tiled", False)   # eager on the CPU
    n_persons = 0
    for f in frames:
        pf = parse_frame(f, PANOPTIC)
        assert port._bucket(int(pf.present.sum(axis=1).max())) == 10
        a = ref.infer_fused(j_parse(f, J_PANOPTIC))
        b = port.infer_fused(pf)
        assert b.scores.shape == a.scores.shape == (1000,)
        np.testing.assert_array_equal(b.persons, a.persons)
        assert b.persons.dtype == a.persons.dtype == np.int32
        np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_TOL)
        np.testing.assert_allclose(b.poses, a.poses, atol=POSE_TOL_M)
        n_persons += len(b.persons)
    if matcher == "random":
        assert n_persons >= 2 * len(frames)


def test_crowded_prior_sensitivity():
    """Why the S=10 comparison packs with the "mean" prior: a 1e-7 relative
    change of the pixels leaves the persons as they are and moves the poses
    by less than a millimetre under "mean"; the IRLS poses of the same
    frames move by decimetres (printed; run with -s)."""
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(DEMO, rig, device="cpu",
                                                  **BUCKETS)
    moved = {}
    for prior in ("mean", "irls"):
        port.lifter_prior = prior
        worst = 0.0
        for f in _crowded_frames(rig)[:2]:
            fa = parse_frame(f, PANOPTIC)
            a = port.infer_fused(fa)
            b = port.infer_fused(fa._replace(
                kp=(fa.kp * np.float32(1 + 1e-7)).astype(np.float32)))
            np.testing.assert_array_equal(b.persons, a.persons)
            worst = max(worst, float(np.abs(a.poses - b.poses).max()))
        moved[prior] = worst
    print(f"max |d pose| under a 1e-7 relative pixel change, trained "
          f"pan_irls_bf16 pair, S=10: {moved}")
    assert moved["mean"] < 1e-3


# ---------------------------------------------------------------------------
# the split path with pair pruning
# ---------------------------------------------------------------------------

S = 8          # 5 cameras x 8 slots: E = 640 pairs
P = 8
E = 640


def _prune_frames(n=3, seed=33):
    noise = SceneNoise(pixel_sigma=1.5, joint_dropout=0.05,
                       spurious_rate=0.08, camera_dropout=0.05)
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), n,
                           n_people=(5, 7), seed=seed, noise=noise,
                           with_gt=False)


@pytest.fixture(scope="module")
def split_pair():
    """The JAX pipeline of tests/test_pair_prune.py (models_demo matcher,
    a (64, 64) lifter, no decode cap, bf16 serving) as a factory, and the
    port's with the same weights."""
    mparams, mcfg, _, _, _ = load_models(os.path.join(ROOT, "models_demo"),
                                         J_PANOPTIC)
    jl = JLifterConfig(widths=(64, 64))
    lparams = init_lifter(jax.random.PRNGKey(1), jl)
    pmcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim,
                          hidden=mcfg.hidden, heads=mcfg.heads,
                          alpha=mcfg.alpha, hidden_slope=mcfg.hidden_slope)
    kw = dict(slot_buckets=(S,), person_buckets=(P,), decode_top_k=0)

    def pipes(matcher, **prune):
        mp = mparams
        if matcher == "random":
            mp = jax.tree_util.tree_map(jnp.asarray,
                                        _random_matcher_tree(pmcfg))
        jp = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mp, mcfg, lparams, jl,
                       serve_dtype=jnp.bfloat16, **kw, **prune)
        tp = PoseEstimationPipeline(
            PANOPTIC, synthetic_ring_rig(PANOPTIC),
            weights.matcher_from_tree(jp.matcher_params, pmcfg, "cpu"),
            weights.lifter_from_tree(jp.lifter_params,
                                     LifterConfig(widths=(64, 64)), "cpu"),
            use_frame_kernel=True, device="cpu", **kw, **prune)
        return jp, tp
    return pipes


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_loose_prune_matches_unpruned_split(split_pair, matcher):
    _, base = split_pair(matcher)
    _, loose = split_pair(matcher, pair_prune_dist=100.0, pair_prune_cap=E)
    assert base.serving_path(S) == ("stack", True)
    assert loose.serving_path(S) == ("tiled", True)
    n = 0
    for f in _prune_frames():
        fa = parse_frame(f, PANOPTIC, max_skeletons=S)
        a, b = base.infer_fused(fa), loose.infer_fused(fa)
        np.testing.assert_array_equal(b.persons, a.persons)
        np.testing.assert_allclose(b.scores, a.scores, atol=LOOSE_SCORE_TOL)
        np.testing.assert_allclose(b.poses, a.poses, atol=POSE_TOL_M)
        n += len(b.persons)
    if matcher == "random":
        assert n > 0


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_tight_prune_matches_reference_split_program(split_pair, matcher):
    dist, cap = 0.15, E // 2
    jp, tp = split_pair(matcher, pair_prune_dist=dist, pair_prune_cap=cap)
    lflat = pack_frame_serving(jp.lifter_params, len(jp.used_idx),
                               J_PANOPTIC.n_joints)
    prog = build_frame_program(jp, S, P, interpret=True, matcher="tiled")
    topo = tp.topology(S)
    rig = tp.match_rig
    pruned, n_persons = 0, 0
    for f in _prune_frames():
        jf = j_parse(f, J_PANOPTIC, max_skeletons=S)
        poses, persons, pmask, scores, _ = jax.device_get(prog(
            jp.matcher_params, lflat,
            *(jnp.asarray(a[:, :S]) for a in (jf.kp, jf.valid, jf.prob,
                                              jf.in_view, jf.present))))
        got = tp.infer_fused(parse_frame(f, PANOPTIC, max_skeletons=S))
        n = int(pmask.sum())
        np.testing.assert_array_equal(got.persons, persons[:n])
        assert got.persons.dtype == np.int32
        np.testing.assert_allclose(got.scores, scores, atol=SCORE_TOL)
        np.testing.assert_allclose(got.poses, poses[:n], atol=POSE_TOL_M)

        # gate-pruned pairs score exactly 0
        fa = parse_frame(f, PANOPTIC, max_skeletons=S)
        kp = torch.tensor(fa.kp[:, :S], dtype=torch.float32)
        shared = torch.tensor(fa.valid[:, :S] * fa.in_view[:, :S],
                              dtype=torch.float32)
        present = fa.present[:, :S].reshape(-1)
        pm = present[topo.e1] & present[topo.e2]
        d = pair_ray_distances(kp, shared, rig, topo).numpy()
        far = pm & (d > dist) & (d < 999.0)
        assert np.all(got.scores[far] == 0.0)
        pruned += int(far.sum())
        n_persons += n
    assert pruned > 0
    if matcher == "random":
        assert n_persons > 0


# ---------------------------------------------------------------------------
# serving path resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,S_,prune,want", [
    (5, 2, False, ("stack", True)),
    (5, 4, False, ("stack", True)),
    (5, 10, False, ("tiled", True)),      # E = 1000
    (5, 16, False, ("tiled", True)),      # E = 2560, D = 64
    (5, 21, False, ("tiled", False)),     # E = 4410 > 4096: eager path
    (6, 16, False, ("tiled", True)),      # D = 80 > 64
    (5, 2, True, ("tiled", True)),
    (5, 4, True, ("tiled", True)),
    (5, 10, True, ("tiled", True)),
    (5, 16, True, ("tiled", True)),
    (5, 21, True, ("tiled", True)),       # decodes max(256, E//2) = 2205
    (6, 16, True, ("tiled", True)),
])
def test_resolve_serving_path(C, S_, prune, want):
    assert resolve_serving_path(C, S_, prune=prune) == want
    form, _ = want
    assert resolve_serving_path(C, S_, prune=prune, frame_ok=False) == (
        form, False)


def test_serving_path_per_bucket_and_oversize_raises():
    rig = synthetic_ring_rig(PANOPTIC)
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8,),
                         heads=(2,))
    lcfg = LifterConfig(widths=(16,))

    def pipe(**kw):
        return PoseEstimationPipeline(
            PANOPTIC, rig,
            weights.matcher_from_tree(weights.random_matcher_tree(mcfg, 0),
                                      mcfg, "cpu"),
            weights.lifter_from_tree(weights.random_lifter_tree(lcfg, 0),
                                     lcfg, "cpu"), device="cpu", **kw)
    auto = pipe()
    assert [auto.serving_path(s) for s in (2, 4, 10, 16, 21)] == [
        ("stack", False), ("stack", False), ("tiled", False),
        ("tiled", False), ("tiled", False)]
    forced = pipe(use_frame_kernel=True, slot_buckets=(21,))
    assert forced.serving_path(16) == ("tiled", True)
    with pytest.raises(ValueError, match="does not serve the S=21 bucket"):
        forced.serving_path(21)
    frame = parse_frame(generate_frames(PANOPTIC, rig, 1, n_people=(2, 3),
                                        seed=1)[0], PANOPTIC)
    with pytest.raises(ValueError, match="does not serve the S=21 bucket"):
        forced.submit_fused(frame)
    pruned = pipe(use_frame_kernel=True, pair_prune_dist=0.2)
    assert pruned.serving_path(21) == ("tiled", True)
    assert pipe(use_frame_kernel=False).serving_path(4) == ("stack", False)
    with pytest.raises(ValueError, match="pair_prune_dist"):
        pipe(pair_prune_dist=-1.0)
