"""The port's batch path (``infer_batch`` / ``submit_batch`` /
``collect_batch``, ``batch_plan``) on the CPU, against the JAX package and
against the port's own per-frame path.

Mirrors ``tests/test_infer_batch.py`` without its mesh part (the port
serves one card, and ``infer_batch(mesh=...)`` raises).  The batch body
(``use_frame_kernel=True`` on the CPU: the union GAT and the decode +
gather + pack over a batch, plain versions) and the eager body frame by
frame (the CPU's default) must give the JAX ``infer_batch``'s persons and
the port's ``infer_fused`` persons on each frame, scores within 1e-5 of
JAX's, poses within 1e-2 m (the bf16 lifter's rounding cascade,
``tests/test_torch_pipeline.py``); the union GAT's scores equal the
per-frame scores within 1e-6 (the same arithmetic on rows of a larger
matrix: summation order only) in the stack and the tiled form; the
batched decode's plain version equals it frame by frame exactly; and the
lifter run kernel's plan at 17 to 64 rows fits its shared memory and
partial limits, with the plan's emulation held to the plain layers.
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
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import FrameArrays, parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.ops import fused_mlp as fm
from mpe3d_tpu_torch.ops.frame_kernel import frame_decode_pack_plain
from mpe3d_tpu_torch.pipeline import BatchPlan, PoseEstimationPipeline

from test_torch_kernel_plans import (NARROW, NARROW_KINDS, NARROW_MIXED,
                                     SERVING, _check_layers, _mixed_layers,
                                     _packed, emulate_run)

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")
HIDDEN, HEADS, WIDTHS = (8,), (2,), (64,)
SCORE_TOL, POSE_TOL_M, UNION_TOL = 1e-5, 1e-2, 1e-6
KW = dict(person_buckets=(8,), threshold=0.05, decode_top_k=0)
NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.05,
                   camera_dropout=0.05)


@pytest.fixture(scope="module")
def trees():
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                         heads=HEADS)
    lcfg = LifterConfig(widths=WIDTHS)
    return (mcfg, weights.random_matcher_tree(mcfg, 0), lcfg,
            weights.random_lifter_tree(lcfg, 1))


def _port(trees, slots=(4,), **kw):
    mcfg, mtree, lcfg, ltree = trees
    return PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), slot_buckets=slots,
        device="cpu", **{**KW, **kw})


def _ref(trees, slots=(4,)):
    _, mtree, _, ltree = trees
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return JPipeline(
        J_PANOPTIC, j_ring(J_PANOPTIC), as_jax(mtree),
        JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                       heads=HEADS),
        as_jax(ltree), JLifterConfig(widths=WIDTHS), slot_buckets=slots,
        use_frame_kernel=False, serve_dtype=jnp.bfloat16, **KW)


@pytest.fixture(scope="module")
def wire():
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 6,
                           n_people=(1, 3), seed=9, noise=NOISE,
                           with_gt=False)


def _same(a, b, tol=POSE_TOL_M, score_tol=SCORE_TOL):
    np.testing.assert_array_equal(b.persons, a.persons)
    assert b.persons.dtype == np.int32
    np.testing.assert_allclose(b.scores, a.scores, atol=score_tol)
    np.testing.assert_allclose(b.poses, a.poses, atol=tol)
    np.testing.assert_allclose(b.quality, a.quality, atol=0.5)
    assert b.n_heads == a.n_heads


@pytest.mark.parametrize("union", [True, False])
def test_infer_batch_matches_jax_and_single(trees, wire, union):
    port = _port(trees, use_frame_kernel=True if union else None)
    assert port.batch_plan(4, 6) == (BatchPlan(True, (6,)) if union else
                                     BatchPlan(False, (1,) * 6))
    fas = [parse_frame(w, PANOPTIC, 4) for w in wire]
    got = port.infer_batch(fas, slots=4)
    want = _ref(trees).infer_batch([j_parse(w, J_PANOPTIC, 4) for w in wire],
                                   slots=4)
    assert len(got) == len(fas)
    n = 0
    for g, w, f in zip(got, want, fas):
        _same(w, g)
        _same(port.infer_fused(f), g, tol=POSE_TOL_M)
        n += len(g.persons)
    assert n >= 6


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_infer_batch_demo_pair_matches_jax(matcher):
    """``models_demo/pan_irls_bf16`` through ``from_checkpoint``, the batch
    body on the CPU, with its trained matcher and a random one."""
    mparams, mcfg, lparams, lcfg, prior = load_models(DEMO, J_PANOPTIC)
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        DEMO, rig, device="cpu", slot_buckets=(4,), person_buckets=(8,),
        use_frame_kernel=True)
    if matcher == "random":
        tree = weights.random_matcher_tree(port.matcher.cfg, 0)
        port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg,
                                                 "cpu")
        mparams = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mparams, mcfg, lparams,
                    lcfg, slot_buckets=(4,), person_buckets=(8,),
                    use_frame_kernel=False, serve_dtype=jnp.bfloat16,
                    lifter_prior=prior)
    wire = generate_frames(PANOPTIC, rig, 5, n_people=(2, 3), seed=1)
    got = port.infer_batch([parse_frame(w, PANOPTIC) for w in wire])
    want = ref.infer_batch([j_parse(w, J_PANOPTIC) for w in wire])
    for g, w in zip(got, want):
        _same(w, g)


def test_submit_batch_pad_to_crops_pad_frames(trees, wire):
    port = _port(trees, use_frame_kernel=True)
    fas = [parse_frame(w, PANOPTIC, 4) for w in wire[:3]]
    got = port.collect_batch(port.submit_batch(fas, pad_to=5))
    assert len(got) == 3
    for g, f in zip(got, fas):
        _same(port.infer_fused(f), g)
    # the pad frames ran (5 frames, one chunk) and decoded nobody
    assert port.batch_plan(4, 5) == BatchPlan(True, (5,))


@pytest.mark.parametrize("slots, form", [(4, "stack"), (10, "tiled")])
def test_union_gat_scores_equal_per_frame(trees, slots, form):
    """One GAT call on the disjoint union of the frames' graphs gives each
    frame's own scores, in the bucket's form."""
    port = _port(trees, slots=(slots,), use_frame_kernel=True)
    wire = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 4,
                           n_people=(6, 9) if slots == 10 else (2, 3),
                           seed=3, noise=NOISE, with_gt=False)
    fas = [parse_frame(w, PANOPTIC, slots) for w in wire]
    (x, pw, gtopo, got_form), _ = port.union_stage_inputs(fas, slots)
    assert got_form == form
    H, E = port.topology(slots).n_heads, port.topology(slots).n_pairs
    assert gtopo.n_heads == 4 * H and gtopo.n_pairs == 4 * E
    union = port.matcher(x, pw, gtopo, form, edge_const=True).view(4, E)
    for i, f in enumerate(fas):
        xf, pwf, tf, _ = port.gat_stage_inputs(f)
        one = port.matcher(xf, pwf, tf, form, edge_const=True)
        np.testing.assert_allclose(union[i].numpy(), one.numpy(),
                                   atol=UNION_TOL,
                                   rtol=UNION_TOL)
        np.testing.assert_array_equal(pw.view(4, E)[i].numpy(), pwf.numpy())


@pytest.mark.parametrize("slots", [4, 10])
def test_batched_decode_plain_equals_frame_by_frame(trees, slots):
    port = _port(trees, slots=(slots,), use_frame_kernel=True)
    wire = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 3,
                           n_people=(2, 8), seed=4, noise=NOISE,
                           with_gt=False)
    fas = [parse_frame(w, PANOPTIC, slots) for w in wire]
    _, (args, kw) = port.union_stage_inputs(fas, slots)
    batch = frame_decode_pack_plain(*args, **kw)
    P = kw["P"]
    assert batch.net.shape[0] == batch.persons.shape[0] == 3 * P
    for b in range(3):
        one = frame_decode_pack_plain(
            args[0][b], args[1][b], args[2], args[3], args[4][b],
            args[5][b], args[6][b], args[7][b], args[8], args[9], **kw)
        for got, want in zip(batch, one):
            assert torch.equal(got[b * P:(b + 1) * P], want)
    assert int(batch.person_mask.sum()) > 0


def test_batch_past_the_union_limits_is_chunked(trees, monkeypatch):
    """S=4 takes 25 frames a union (H <= 512 heads); 27 frames are one
    ticket of chunks (25, 2), each a body, and equal the per-frame path."""
    port = _port(trees, use_frame_kernel=True)
    assert port.batch_plan(4, 27) == BatchPlan(True, (25, 2))
    assert port.batch_plan(10, 23) == BatchPlan(True, (10, 10, 3))
    assert port.batch_plan(16, 7) == BatchPlan(True, (6, 1))
    wire = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 27,
                           n_people=(1, 3), seed=6, noise=NOISE,
                           with_gt=False)
    fas = [parse_frame(w, PANOPTIC, 4) for w in wire]
    seen, run = [], port._run_frames

    def spy(S, *bufs, **kw):
        seen.append(bufs[0].shape[0])
        return run(S, *bufs, **kw)

    monkeypatch.setattr(port, "_run_frames", spy)
    got = port.infer_batch(fas)
    assert seen == [25, 2] and len(got) == 27
    for g, f in zip(got[::5], fas[::5]):
        _same(port.infer_fused(f), g)


def test_batch_plan_follows_the_configuration(trees):
    """The eager body frame by frame where the frame path is off: the CPU's
    default, geo rerank, the triangulation backend; never from an error."""
    assert _port(trees).batch_plan(4, 3) == BatchPlan(False, (1, 1, 1))
    geo = _port(trees, geo_rerank=0.3)
    assert geo.batch_plan(4, 2) == BatchPlan(False, (1, 1))
    tri = _port(trees, backend="triangulation")
    assert tri.batch_plan(4, 2) == BatchPlan(False, (1, 1))
    assert _port(trees, use_frame_kernel=True).batch_plan(
        10, 1) == BatchPlan(True, (1,))
    with pytest.raises(ValueError, match="n_frames"):
        _port(trees).batch_plan(4, 0)


def test_infer_batch_mesh_raises(trees, wire):
    """``mesh`` (refused before) splits the batch: over a one-device mesh
    the unsplit call's results (``tests/test_torch_multidevice.py`` holds
    two devices to JAX); a mesh that is no ``Mesh`` raises."""
    from mpe3d_tpu_torch.parallel.mesh import make_mesh

    port = _port(trees)
    frames = [parse_frame(w, PANOPTIC, 4) for w in wire[:3]]
    with pytest.raises(TypeError, match="make_mesh"):
        port.infer_batch(frames[:1], mesh=object())
    split = port.infer_batch(frames, mesh=make_mesh(devices=["cpu"]))
    for a, b in zip(split, port.infer_batch(frames)):
        np.testing.assert_array_equal(a.persons, b.persons)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert port.infer_batch([]) == []
    with pytest.raises(ValueError, match="no frames"):
        port.submit_batch([])


def test_infer_batch_mixed_buckets_takes_the_fullest(trees):
    """Frames of one and of several people in one batch: the batch's bucket
    is the fullest frame's, and every frame gives its per-frame persons in
    that bucket."""
    port = _port(trees, slots=(2, 4), use_frame_kernel=True)
    rig = synthetic_ring_rig(PANOPTIC)
    wire = (generate_frames(PANOPTIC, rig, 2, n_people=(1, 1), seed=8,
                            with_gt=False)
            + generate_frames(PANOPTIC, rig, 2, n_people=(3, 4), seed=8,
                              with_gt=False))
    fas = [parse_frame(w, PANOPTIC, 4) for w in wire]
    got = port.infer_batch(fas)
    for g, f in zip(got, fas):
        one = port.collect_batch(port.submit_batch([f], slots=4))[0]
        _same(one, g)


def _empty(S=4):
    C, J = 5, 18
    return FrameArrays(np.zeros((C, S, J, 2), np.float32),
                       np.zeros((C, S, J), np.float32),
                       np.zeros((C, S, J), np.float32),
                       np.zeros((C, S, J), bool), np.zeros((C, S), bool),
                       np.zeros(C))


def test_empty_frames_batch(trees):
    for port in (_port(trees), _port(trees, use_frame_kernel=True)):
        got = port.infer_batch([_empty(), _empty()])
        assert [len(g.persons) for g in got] == [0, 0]
        assert got[0].poses.shape == (0, 18, 3)


@pytest.mark.parametrize("M", [17, 32, 50, 64])
@pytest.mark.parametrize("net", ["serving", "pan_irls"])
def test_run_plan_fits_the_kernel_past_16_rows(M, net):
    """The lifter run's plan for 17 to 64 rows: its row class's shared
    memory within what a block may have, chunks of at most ``kc_max``
    rows, at most ``max_splits`` chunks a slab; each tile owned once, its
    slab's chunks covering the rows once."""
    int8 = [net == "pan_irls"] * 8 + [False]
    plan = fm.plan_run(SERVING, M, 132, int8)
    assert fm.run_smem_bytes(M) + fm.STATIC_SMEM <= fm.SMEM_OPTIN
    assert fm.kc_max(M) == (1024 if M <= 32 else 512)
    seen = set()
    for tiles in plan.blocks:
        assert len(tiles) <= fm.MAX_BLOCK_TILES
        for t in tiles:
            assert 0 < t.r1 - t.r0 <= fm.kc_max(M)
            assert (t.layer, t.slab, t.chunk) not in seen
            seen.add((t.layer, t.slab, t.chunk))
    for (K, N), lay in zip(SERVING, plan.layers):
        assert 1 <= lay.splits <= fm.max_splits(M, K)
        # one pass of the reduction holds at least a row of every chunk
        assert fm.partial_cap(M) // lay.splits >= fm.SLAB
    assert len(seen) == sum(lay.n_slabs * lay.splits for lay in plan.layers)


@pytest.mark.parametrize("M", [17, 32, 64])
def test_emulated_plan_matches_plain_past_16_rows(M):
    """The plan's emulation at 17 to 64 rows, on the narrow bf16 net and
    the narrow mixed int8 net: each layer within 1e-5 x max|out| of its
    plain version on the same input, the net within 1e-5 of
    ``fused_mlp_plain``."""
    x = torch.tensor(np.random.default_rng(M).normal(size=(M, 70)),
                     dtype=torch.float32)
    for layers, kinds, acts in (
            (_packed(NARROW, 11), None, [True, True, True, False]),
            (_mixed_layers(NARROW_MIXED, NARROW_KINDS, 21)[0],
             NARROW_KINDS, [True] * 4 + [False])):
        plan = fm.plan_run([fm.layer_shape(layer) for layer in layers], M,
                           132, kinds)
        outs = emulate_run(x, layers, 0.1, acts, plan)
        _check_layers(x, layers, acts, outs)
        net = fm.fused_mlp_plain(x, layers, 0.1, 16)
        np.testing.assert_allclose(outs[-1].numpy(), net.numpy(),
                                   atol=1e-5)
