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
lifter run kernel's plan at 17 to 256 rows fits its shared memory and
partial limits (past 64 rows the wide classes' whole-stage chunks), with
the plan's emulation held to the plain layers; up to 64 rows its plans
and tables are pinned, and a run's rows go in launches of 256.
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


@pytest.mark.parametrize("M", [17, 32, 50, 64, 65, 96, 250, 252, 256])
@pytest.mark.parametrize("net", ["serving", "pan_irls"])
def test_run_plan_fits_the_kernel_past_16_rows(M, net):
    """The lifter run's plan for 17 to 256 rows: its row class's shared
    memory within what a block may have, at most ``max_splits`` chunks a
    slab; each tile owned once, its slab's chunks covering the rows once.
    Up to 64 rows chunks of at most ``kc_max`` rows, and one pass of the
    reduction holds a row of every chunk; on the wide classes (65 to 256
    rows) chunks of whole ring stages (128 bf16 rows, 256 int8 rows),
    staged in windows of ``kc_max`` rows of 128 or 256 activation rows
    that fill the window's 128 KB."""
    int8 = [net == "pan_irls"] * 8 + [False]
    plan = fm.plan_run(SERVING, M, 132, int8)
    assert fm.run_smem_bytes(M) + fm.STATIC_SMEM <= fm.SMEM_OPTIN
    if M <= fm.MAX_ROWS:
        assert fm.kc_max(M) == (1024 if M <= 32 else 512)
    else:
        rows = 128 if M <= 128 else 256
        assert fm.row_tiles(M) * 8 == rows
        assert fm.kc_max(M) == (512 if M <= 128 else 256)
        assert rows * fm.kc_max(M) * 2 == fm.WIDE_XS_BYTES
    seen = set()
    for tiles in plan.blocks:
        assert len(tiles) <= fm.MAX_BLOCK_TILES
        for t in tiles:
            if M <= fm.MAX_ROWS:
                assert 0 < t.r1 - t.r0 <= fm.kc_max(M)
            else:
                unit = fm.stage_rows(M, int8[t.layer])
                assert unit == (256 if int8[t.layer] else 128)
                assert t.r0 % unit == 0 and (t.r1 - t.r0) % unit == 0
                assert t.r1 > t.r0 and fm.kc_max(M) >= unit
            assert (t.layer, t.slab, t.chunk) not in seen
            seen.add((t.layer, t.slab, t.chunk))
    for l, ((K, N), lay) in enumerate(zip(SERVING, plan.layers)):
        assert 1 <= lay.splits <= fm.max_splits(M, K, int8[l])
        if M <= fm.MAX_ROWS:
            # one pass of the reduction holds at least a row of every chunk
            assert fm.partial_cap(M) // lay.splits >= fm.SLAB
        # the slab's chunks cover its rows once, the last past K
        unit = fm.stage_rows(M, int8[l])
        spans = sorted(fm.chunk_rows(K, lay.splits, c, unit)
                       for c in range(lay.splits))
        assert spans[0][0] == 0 and spans[-1][1] >= K
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert len(seen) == sum(lay.n_slabs * lay.splits for lay in plan.layers)


# digests of the plans and device tables of the run kernel up to 64 rows,
# as they were before the wide classes (a hash of the plan and of every
# table, on 132 blocks and made-up addresses)
NARROW_TABLES = {
    ("serving", 1): "d75d8392da629d85", ("serving", 8): "02c959535693bc28",
    ("serving", 10): "722611994d30055c", ("serving", 16): "c649716f56adb2b4",
    ("serving", 17): "0f41f602e606f6e7", ("serving", 32): "67eb341adc726c8f",
    ("serving", 50): "1ab088b1a2026522", ("serving", 64): "f716e8bb6eed960c",
    ("arplab", 1): "019c816e07027894", ("arplab", 8): "7c916e93ddf798df",
    ("arplab", 10): "48d52fa1d3841f74", ("arplab", 16): "0e9361af9e9d52fd",
    ("arplab", 17): "5d48914fce186582", ("arplab", 32): "aaba2ace8ddff8ad",
    ("arplab", 50): "484c14522d1d05e9", ("arplab", 64): "af926fb05e45d2f7",
    ("pan_irls", 1): "3c5aacb1eca86ec2", ("pan_irls", 8): "a450810dc8f3d408",
    ("pan_irls", 10): "f5172eee8e2fe9b8",
    ("pan_irls", 16): "39642a3ebd172eda",
    ("pan_irls", 17): "fd228420a79ac5af",
    ("pan_irls", 32): "a4c47ef906be7ab7",
    ("pan_irls", 50): "9581b187017db91e",
    ("pan_irls", 64): "58952a6f60570bd2",
    ("narrow", 1): "7292e758149107c3", ("narrow", 8): "cc19d32756cb3d21",
    ("narrow", 10): "cc12d0a3c74697b4", ("narrow", 16): "b510f6247294d3f6",
    ("narrow", 17): "58ba8fa4b2370f98", ("narrow", 32): "d5596faf3c1c337d",
    ("narrow", 50): "a15c378af6f54b69", ("narrow", 64): "87d360abb93af98b",
}


@pytest.mark.parametrize("net, M", list(NARROW_TABLES))
def test_run_tables_up_to_64_rows_unchanged(net, M):
    """Up to 64 rows the run kernel's plan and device tables are the ones
    it had before the wide classes joined (the frame path's lifter, M =
    P = 10-16, serving and the eager path launch as before): the serving,
    ARPLAB, ``pan_irls`` and the narrow ragged net, bit for bit."""
    import hashlib
    shapes, int8 = {"serving": (SERVING, None),
                    "arplab": (((1512, 3072),) + SERVING[1:], None),
                    "pan_irls": (SERVING, [True] * 8 + [False]),
                    "narrow": (NARROW, None)}[net]
    kinds = int8 or [False] * len(shapes)
    plan = fm.plan_run(shapes, M, 132, int8)
    ptrs = [(1000 * (i + 1), 2000 * (i + 1), 3000 * (i + 1) if q else 0,
             4000 * (i + 1) if q else 0) for i, q in enumerate(kinds)]
    acts = [i < len(shapes) - 1 for i in range(len(shapes))]
    tables = fm.run_tables(plan, ptrs, acts, "cpu")
    h = hashlib.sha256(repr(plan).encode())
    for t in (tables.layers, tables.tiles, tables.block_tiles):
        h.update(t.numpy().tobytes())
    h.update(repr(tables[3:]).encode())
    assert h.hexdigest()[:16] == NARROW_TABLES[net, M]


@pytest.mark.parametrize("M, groups", [
    (1, [(0, 1)]), (64, [(0, 64)]), (65, [(0, 65)]), (250, [(0, 250)]),
    (256, [(0, 256)]), (300, [(0, 256), (256, 300)]),
    (600, [(0, 256), (256, 512), (512, 600)])])
def test_run_row_groups(M, groups):
    """A run on M rows is one launch up to 256 rows (the wide classes past
    64) and a launch a group of 256 past that, whatever its layer kinds:
    an int8 run groups its rows as a bf16 one, and its plan takes the wide
    class; ``int8_layer_matmul`` keeps its 64-row groups."""
    assert fm.row_groups(M) == groups
    for m0, m1 in groups:
        for int8 in (None, [True] * 8 + [False]):
            plan = fm.plan_run(SERVING, m1 - m0, 132, int8)
            assert plan.M == m1 - m0
            assert fm.row_tiles(plan.M) == (32 if plan.M > 128 else 16
                                            if plan.M > 64 else
                                            fm.row_tiles(plan.M))
    assert fm.MAX_ROWS == 64 and fm.GROUP_ROWS == 256


@pytest.mark.parametrize("M", [17, 32, 64, 96, 250])
def test_emulated_plan_matches_plain_past_16_rows(M):
    """The plan's emulation at 17 to 250 rows (past 64 the wide classes'
    chunks of whole stages), on the narrow bf16 net and the narrow mixed
    int8 net: each layer within 1e-5 x max|out| of its plain version on
    the same input, the net within 1e-5 of ``fused_mlp_plain``."""
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
