"""The port's staged path (``__call__``: match, host or device decode, lift),
its triangulation backend and the geometric rerank / rescue, on the CPU,
against the JAX package.

Mirrors ``tests/test_fused_pipeline.py`` (``test_fused_matches_staged``,
``test_staged_device_decode_matches_host``, ``test_geo_paths_agree``,
``test_geo_paths_agree_undersized_slot_parse``, ``test_fused_empty_frame``)
with the JAX pipeline beside the port on the same numpy-seeded weights
(``weights.py``): the JAX side without the whole-frame kernel, bf16 lifter
weights and operands.  Persons must be equal; scores within 1e-5 (fp32
GAT); MLP poses within 1e-2 m (the lifter's bf16 rounding cascade,
``tests/test_torch_pipeline.py``); triangulated poses within 1e-4 m with
their per-joint ok flags equal (plain fp32 geometry in both).  The trained
``pan_irls_bf16`` matcher is held too: at S=4 on the ring rig it decodes few
persons (ROADMAP.md section 3), so the random matcher stays beside it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.frames import FrameArrays as JFrameArrays
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import FrameArrays, parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

from torch_testing import jax_models

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")
HIDDEN, HEADS, WIDTHS = (8, 8), (2, 2), (64, 64)
SCORE_TOL, POSE_TOL_M, TRI_TOL_M, QUALITY_TOL_PX = 1e-5, 1e-2, 1e-4, 0.5
# the tiled form sums a head's edges in its incidence order, the JAX staged
# program (XLA) in another: on the 6-8-person frames of
# test_staged_demo_pair_matches_jax the JAX package's own tiled form
# (apply_matcher_tiled, interpret mode) differs from its staged scores by up
# to 3.0e-5 with the trained matcher, the port's by up to 2.5e-5
TILED_SCORE_TOL = 4e-5
# threshold under the random matcher's score range, exact decode
KW = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05,
          decode_top_k=0)
GEO = dict(geo_rerank=0.3, geo_rescue=0.001, geo_rescue_dist=0.05)
NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.1,
                   camera_dropout=0.05)


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                         heads=HEADS)
    lcfg = LifterConfig(widths=WIDTHS)
    return (mcfg, weights.random_matcher_tree(mcfg, 0), lcfg,
            weights.random_lifter_tree(lcfg, 1))


def _port(trees, lifter=True, rig_config=PANOPTIC, **kw):
    mcfg, mtree, lcfg, ltree = trees
    if rig_config is not PANOPTIC:
        mcfg = dataclasses.replace(mcfg,
                                   in_dim=rig_config.matcher_feature_dim)
        mtree = weights.random_matcher_tree(mcfg, 0)
    return PoseEstimationPipeline(
        rig_config, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu") if lifter else None,
        device="cpu", **{**KW, **kw})


def _ref(trees, lifter=True, rig_config=J_PANOPTIC, **kw):
    mcfg, mtree, lcfg, ltree = trees
    jm = JMatcherConfig(in_dim=rig_config.matcher_feature_dim, hidden=HIDDEN,
                        heads=HEADS)
    if rig_config is not J_PANOPTIC:
        mtree = weights.random_matcher_tree(
            dataclasses.replace(mcfg, in_dim=rig_config.matcher_feature_dim),
            0)
    args = ((_as_jax(ltree), JLifterConfig(widths=WIDTHS)) if lifter
            else ())
    return JPipeline(rig_config, j_ring(J_PANOPTIC), _as_jax(mtree), jm,
                     *args, use_frame_kernel=False,
                     serve_dtype=jnp.bfloat16, **{**KW, **kw})


def _wire(n=6, seed=11, people=(1, 3)):
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), n,
                           n_people=people, seed=seed, noise=NOISE,
                           with_gt=False)


def _person_sets(persons):
    return {frozenset((c, int(s)) for c, s in enumerate(p) if s >= 0)
            for p in persons}


def _match(a, b, tol, note="", score_tol=SCORE_TOL, quality_rtol=0.0):
    """Port output ``b`` against JAX output ``a``: persons equal, scores and
    poses within tolerance, quality within 0.5 px (and ``quality_rtol``)."""
    np.testing.assert_array_equal(b.persons, a.persons, err_msg=note)
    if a.scores.size:
        np.testing.assert_allclose(b.scores, a.scores, atol=score_tol,
                                   err_msg=note)
    np.testing.assert_allclose(b.poses, a.poses, atol=tol)
    np.testing.assert_allclose(b.quality, a.quality, atol=QUALITY_TOL_PX,
                               rtol=quality_rtol, err_msg=note)
    assert b.n_heads == a.n_heads


@pytest.mark.parametrize("decode_on_device", [False, True])
def test_staged_matches_jax(trees, decode_on_device):
    port = _port(trees, decode_on_device=decode_on_device)
    ref = _ref(trees, decode_on_device=decode_on_device)
    n = 0
    for w in _wire():
        a, b = ref(j_parse(w, J_PANOPTIC, 4)), port(parse_frame(w, PANOPTIC,
                                                                  4))
        _match(a, b, POSE_TOL_M)
        n += len(b.persons)
    assert n >= 6


def test_fused_matches_staged(trees):
    """The port's staged and fused paths: equal person sets, poses within
    1e-2 m person by person."""
    port = _port(trees)
    checked = 0
    for w in _wire(8, seed=7):
        fa = parse_frame(w, PANOPTIC, 4)
        staged, fused = port(fa), port.infer_fused(fa)
        assert _person_sets(staged.persons) == _person_sets(fused.persons)
        rows = {frozenset((c, int(s)) for c, s in enumerate(p) if s >= 0): i
                for i, p in enumerate(staged.persons)}
        for i, p in enumerate(fused.persons):
            j = rows[frozenset((c, int(s)) for c, s in enumerate(p)
                               if s >= 0)]
            np.testing.assert_allclose(fused.poses[i], staged.poses[j],
                                       atol=POSE_TOL_M)
        checked += int(len(staged.persons) > 0)
    assert checked > 0


def test_staged_device_decode_matches_host(trees):
    host, dev = _port(trees), _port(trees, decode_on_device=True)
    checked = 0
    for w in _wire(6, seed=11):
        fa = parse_frame(w, PANOPTIC, 4)
        h, d = host(fa), dev(fa)
        assert _person_sets(h.persons) == _person_sets(d.persons)
        assert d.persons.dtype == np.int32 and h.persons.dtype == np.int64
        checked += len(h.persons)
    assert checked > 0


@pytest.mark.parametrize("crowd", ["sparse", "crowded"])
@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_staged_demo_pair_matches_jax(matcher, crowd):
    """``models_demo/pan_irls_bf16`` (IRLS prior, bf16 lifter) through
    ``from_checkpoint``, host and device decode, with its trained matcher
    and a random one, against the JAX staged path: 2-3-person frames in
    the S=4 bucket (the stack form), and 6-8-person frames in the default
    buckets, up to S=10 (E=1000: the tiled form, scores within
    ``TILED_SCORE_TOL``).  The crowded frames pack the lifter input with
    the "mean" prior on both sides: the decode groups skeletons of
    different people there, and the IRLS prior of such groups is
    ill-conditioned (``tests/test_torch_crowded.py``).  Their quality is
    also held within 1%: the random matcher groups skeletons of different
    people into persons whose reprojection error reaches thousands of
    pixels, where a pose within 1e-2 m moves it by more than 0.5 px."""
    mparams, mcfg, lparams, lcfg, prior = jax_models("pan_irls_bf16")
    rig = synthetic_ring_rig(PANOPTIC)
    people, buckets = (((2, 3), dict(slot_buckets=(4,), person_buckets=(8,)))
                       if crowd == "sparse" else ((6, 8), {}))
    if crowd == "crowded":
        prior = "mean"
    frames = generate_frames(PANOPTIC, rig, 6, n_people=people, seed=1)
    forms = set()
    for on_device in (False, True):
        port = PoseEstimationPipeline.from_checkpoint(
            DEMO, rig, device="cpu", decode_on_device=on_device, **buckets)
        port.lifter_prior = prior
        if matcher == "random":
            tree = weights.random_matcher_tree(port.matcher.cfg, 0)
            port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg,
                                                     "cpu")
            mparams = _as_jax(tree)
        ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mparams, mcfg,
                        lparams, lcfg, use_frame_kernel=False,
                        serve_dtype=jnp.bfloat16, lifter_prior=prior,
                        decode_on_device=on_device, **buckets)
        for w in frames:
            fa = parse_frame(w, PANOPTIC)
            form = port.serving_path(port._match_slots(fa))[0]
            forms.add(form)
            _match(ref(j_parse(w, J_PANOPTIC)), port(fa), POSE_TOL_M,
                   f"{matcher} matcher, {form} form",
                   TILED_SCORE_TOL if form == "tiled" else SCORE_TOL,
                   0.0 if crowd == "sparse" else 1e-2)
    assert forms == ({"stack"} if crowd == "sparse" else {"tiled"})


@pytest.mark.parametrize("tri_variant", ["median", "irls"])
def test_triangulation_backend_matches_jax(trees, tri_variant):
    """backend="triangulation" without a lifter: the staged path, the
    fused (eager) path and the 3D stage alone, whose per-joint ok flags
    must equal the JAX ``_lift_fn``'s."""
    kw = dict(backend="triangulation", tri_variant=tri_variant)
    port, ref = _port(trees, lifter=False, **kw), _ref(trees, lifter=False,
                                                         **kw)
    assert port.serving_path(4) == ("stack", False)
    n = 0
    for w in _wire():
        fa, ja = parse_frame(w, PANOPTIC, 4), j_parse(w, J_PANOPTIC, 4)
        _match(ref(ja), port(fa), TRI_TOL_M)
        _match(ref.infer_fused(ja), port.infer_fused(fa), TRI_TOL_M)
        persons = port(fa).persons
        if not len(persons):
            continue
        obs = port.gather_person_obs(fa, persons)
        want = ref._lift_fn(len(persons), ref.prior_gate_px,
                            ref.tri_variant)(
            None, *(jnp.asarray(a) for a in obs),
            jnp.ones(len(persons), jnp.float32))
        got = port._lift_rows(*(torch.as_tensor(a) for a in obs))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=TRI_TOL_M)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=QUALITY_TOL_PX)
        n += len(persons)
    assert n >= 6


def test_geo_paths_agree(trees):
    """Geo rerank and rescue on: the port's staged host, staged device,
    fused and batch paths give the JAX staged host path's person sets, and
    the rescue fires (persons decoded from pairs under the threshold)."""
    kw = dict(backend="triangulation", **GEO)
    host, ref = _port(trees, lifter=False, **kw), _ref(trees, lifter=False,
                                                        **kw)
    dev = _port(trees, lifter=False, decode_on_device=True, **kw)
    assert not dev.batch_plan(4, 6).union
    wire = _wire(6, seed=11)
    fas = [parse_frame(w, PANOPTIC, 4) for w in wire]
    batched = dev.infer_batch(fas, slots=4)
    rescued = 0
    for w, fa, out_b in zip(wire, fas, batched):
        want = ref(j_parse(w, J_PANOPTIC, 4))
        ph = host(fa)
        _match(want, ph, TRI_TOL_M)
        sets = [_person_sets(p.persons) for p in
                (ph, dev(fa), dev.infer_fused(fa), out_b)]
        assert all(s == sets[0] for s in sets)
        if len(ph.persons) and (ph.scores <= 0.05).any():
            rescued += 1
    assert rescued > 0


@pytest.mark.parametrize("mode", ["rerank", "rescue"])
def test_geo_decode_scores_match_jax(trees, mode):
    """``host_decode_scores`` (eligibility and order keys) against the JAX
    pipeline's on the same matcher scores, MLP backend."""
    kw = {"rerank": dict(geo_rerank=0.3), "rescue": dict(geo_rescue=0.001,
                                                         geo_rescue_dist=0.05)
          }[mode]
    port, ref = _port(trees, **kw), _ref(trees, **kw)
    for w in _wire(4, seed=13):
        fa, ja = parse_frame(w, PANOPTIC, 4), j_parse(w, J_PANOPTIC, 4)
        scores, _, topo, S = ref.match(ja)
        want = ref.host_decode_scores(ja, scores, topo, S)
        got = port.host_decode_scores(fa, scores, port.topology(S), S)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_allclose(got[1], want[1], atol=1e-6)
        _match(ref(ja), port(fa), POSE_TOL_M)
        _match(ref.infer_fused(ja), port.infer_fused(fa), POSE_TOL_M)


def test_geo_paths_agree_undersized_slot_parse(trees):
    """Frames parsed with fewer slots than the bucket (3 < S=4): the host
    geo path pads up to the bucket and agrees with the fused path and the
    JAX host path."""
    kw = dict(backend="triangulation", **GEO)
    host, ref = _port(trees, lifter=False, **kw), _ref(trees, lifter=False,
                                                        **kw)
    dev = _port(trees, lifter=False, decode_on_device=True, **kw)
    for w in _wire(4, seed=13, people=(2, 3)):
        fa, ja = parse_frame(w, PANOPTIC, 3), j_parse(w, J_PANOPTIC, 3)
        assert fa.kp.shape[1] == 3
        ph = host(fa)
        assert _person_sets(ph.persons) == _person_sets(
            dev.infer_fused(fa).persons)
        _match(ref(ja), ph, TRI_TOL_M)


def _empty(C=5, S=4, J=18, cls=FrameArrays):
    return cls(np.zeros((C, S, J, 2), np.float32),
               np.zeros((C, S, J), np.float32),
               np.zeros((C, S, J), np.float32), np.zeros((C, S, J), bool),
               np.zeros((C, S), bool), np.zeros(C))


@pytest.mark.parametrize("backend", ["mlp", "triangulation"])
def test_fused_empty_frame(trees, backend):
    port = _port(trees, backend=backend)
    ref = _ref(trees, backend=backend)
    for out in (port.infer_fused(_empty()), port(_empty()),
                port.infer_batch([_empty()])[0]):
        assert len(out.persons) == 0 and len(out.poses) == 0
        assert out.poses.shape == (0, 18, 3)
    a, b = ref(_empty(cls=JFrameArrays)), port(_empty())
    assert b.persons.shape == a.persons.shape


def test_lift_truncates_past_the_largest_person_bucket(trees, capfd):
    """The host decode has no person cap: lift takes the first persons of
    the largest bucket and reports the rest on stderr, as the reference."""
    port, ref = _port(trees), _ref(trees)
    fa = parse_frame(_wire(1, seed=5, people=(3, 3))[0], PANOPTIC, 4)
    ja = JFrameArrays(*fa)
    persons = np.array([[s % 4, (s + 1) % 4, -1, -1, -1]
                        for s in range(11)], np.int64)
    poses, quality = port.lift(fa, persons, with_quality=True)
    assert poses.shape == (8, 18, 3) and quality.shape == (8,)
    assert "exceed the largest person bucket (8)" in capfd.readouterr().err
    want = ref.lift(ja, persons, with_quality=True)
    np.testing.assert_allclose(poses, want[0], atol=POSE_TOL_M)
    np.testing.assert_allclose(quality, want[1], atol=QUALITY_TOL_PX)


def test_one_matching_camera_bypass_matches_jax(trees):
    """A rig with one matching camera: every present skeleton is a person
    (``single_camera_bypass``), lifted as the JAX staged path does."""
    one = dataclasses.replace(
        PANOPTIC, used_cameras_skeleton_matching=PANOPTIC.camera_names[:1])
    jone = dataclasses.replace(
        J_PANOPTIC,
        used_cameras_skeleton_matching=J_PANOPTIC.camera_names[:1])
    port, ref = _port(trees, rig_config=one), _ref(trees, rig_config=jone)
    for w in _wire(3, seed=2):
        b = port(parse_frame(w, one, 4))
        a = ref(j_parse(w, jone, 4))
        assert len(b.persons) > 0 and b.scores.size == 0
        _match(a, b, POSE_TOL_M)


def test_staged_options_are_checked(trees):
    with pytest.raises(ValueError, match="backend"):
        _port(trees, backend="dlt")
    with pytest.raises(ValueError, match="tri_variant"):
        _port(trees, tri_variant="mean")
    with pytest.raises(ValueError, match="needs a lifter"):
        _port(trees, lifter=False)
    with pytest.raises(ValueError, match="lifter_prior"):
        _port(trees, lifter_prior="max")
    with pytest.raises(ValueError, match="prior_gate_px"):
        _port(trees, prior_gate_px=0.0)
    tri = _port(trees, lifter=False, backend="triangulation")
    assert tri.serve_dtype is None and not tri.frame_path_on()
    with pytest.raises(ValueError, match="without a lifter"):
        tri.reload_weights(lifter_tree=trees[3])
