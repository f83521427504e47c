"""The port's evaluation slice against the JAX package on the CPU.

Ground truth on the wire (``data/frames.py``: native and python parse,
dedup, ``load_eval_frames``, ``merge_frame_files``) must equal JAX's
exactly; ``full_distort`` / ``project_points(tangential=True)`` agree
within 1e-5 px; the numpy metrics (clustering, pose metrics,
``best_permutation``) within 1e-9; the reprojection errors within 1e-4 px;
the matcher scenes exactly.  The four runners run every mode against
JAX's on the same numpy-seeded weights with an fp32 lifter on both sides
(``serve_dtype="fp32"`` against JAX's fp32 ``apply_lifter``): the count
fields must be equal, MPJPE and reprojection pixels within 1e-4 relative,
AP and recall within 1e-6 (they only move if a pose error crosses a
threshold), clustering scores within 1e-9.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data import frames as jframes
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.eval import clustering as jclust
from mpe3d_tpu.eval import pose_metrics as jpm
from mpe3d_tpu.eval import reprojection as jrep
from mpe3d_tpu.eval import runners as jrun
from mpe3d_tpu.geometry import camera as jcam
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu.train import matcher_data as jmd
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data import frames
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            generate_single_person_frames,
                                            synthetic_ring_rig, write_frames)
from mpe3d_tpu_torch.eval import clustering, pose_metrics, reprojection
from mpe3d_tpu_torch.eval import runners
from mpe3d_tpu_torch.eval.timing import TimingAccumulator
from mpe3d_tpu_torch.geometry import camera
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
from mpe3d_tpu_torch.train import matcher_data

import torch_testing  # noqa: F401

HIDDEN, HEADS, WIDTHS = (8, 8), (2, 2), (64, 64)
KW = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05,
          decode_top_k=0)
NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.05, spurious_rate=0.2,
                   camera_dropout=0.05)
PX_TOL, METRIC_TOL, REL_TOL, AP_TOL = 1e-4, 1e-9, 1e-4, 1e-6
COUNTS = ("n_gt", "n_poses", "n_matched", "n_frames", "n_scenes",
          "stream_depth")


@pytest.fixture(scope="module")
def wire():
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 10,
                           n_people=(2, 3), seed=5, noise=NOISE)


def test_ground_truth_matches_jax(wire, tmp_path):
    """parse_frame_gt, both parsers of parse_frames_batch(with_gt=True),
    dedup_ground_truth, load_eval_frames and merge_frame_files: equal to
    the JAX package's."""
    for f in wire:
        a, b = frames.parse_frame_gt(f, PANOPTIC), jframes.parse_frame_gt(
            f, J_PANOPTIC)
        assert a.camera == b.camera
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        da, db = frames.dedup_ground_truth(a), jframes.dedup_ground_truth(b)
        assert len(da.gt3d) == len(db.gt3d) <= len(a.gt3d)
        for x, y in zip(da[:3], db[:3]):
            np.testing.assert_array_equal(x, y)
    assert any(len(frames.dedup_ground_truth(frames.parse_frame_gt(
        f, PANOPTIC)).gt3d) < len(frames.parse_frame_gt(f, PANOPTIC).gt3d)
        for f in wire), "no ghost GT row to deduplicate"
    paths = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    write_frames(wire[:4], paths[0])
    write_frames(wire[4:], paths[1])
    for native in (True, False):
        fas, gts = frames.load_eval_frames(paths, PANOPTIC,
                                           use_native=native)
        jfas, jgts = jframes.load_eval_frames(paths, J_PANOPTIC,
                                              use_native=native)
        assert len(fas) == len(jfas) == len(wire)
        for fa, jfa, gt, jgt in zip(fas, jfas, gts, jgts):
            for x, y in zip(fa, jfa):
                np.testing.assert_array_equal(x, y)
            assert gt.camera == jgt.camera
            for x, y in zip(gt[:3], jgt[:3]):
                np.testing.assert_array_equal(x, y)
    out, jout = str(tmp_path / "m.json"), str(tmp_path / "jm.json")
    assert frames.merge_frame_files(paths, out) == jframes.merge_frame_files(
        paths, jout) == len(wire)
    assert json.load(open(out)) == json.load(open(jout)) == json.loads(
        json.dumps(wire))


def test_full_distort_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.8, 0.8, (64, 2)).astype(np.float32)
    dist = rng.normal(0, 0.05, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(
        camera.full_distort(torch.from_numpy(xy), torch.from_numpy(dist)),
        jcam.full_distort(jnp.asarray(xy), jnp.asarray(dist)), atol=1e-6)
    rig = synthetic_ring_rig(PANOPTIC)
    pts = rng.normal(0, 0.6, (32, 3)).astype(np.float32) + [0, -1.0, 0]
    pts = pts.astype(np.float32)
    dist = rig.dist + rng.normal(0, 0.01, rig.dist.shape).astype(np.float32)
    t = rig.to("cpu")
    for tangential in (False, True):
        got = camera.project_points(torch.from_numpy(pts)[:, None],
                                    t.T_wc[None], t.K[None],
                                    torch.from_numpy(dist)[None],
                                    tangential=tangential)
        ref = jcam.project_points(jnp.asarray(pts)[:, None], rig.T_wc[None],
                                  rig.K[None], jnp.asarray(dist)[None],
                                  tangential=tangential)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_matches_jax(seed):
    rng = np.random.default_rng(seed)
    true, pred = rng.integers(0, 5, 40), rng.integers(0, 6, 40)
    for a, b in ((true, pred), (true, true), (true[:1], pred[:1])):
        got = clustering.clustering_report(a, b)
        ref = jclust.clustering_report(a, b)
        for k in ref:
            assert abs(got[k] - ref[k]) <= METRIC_TOL
    persons = np.array([[0, -1, 2], [1, 1, -1]])
    np.testing.assert_array_equal(
        clustering.persons_to_head_labels(persons, 12, 4),
        jclust.persons_to_head_labels(persons, 12, 4))


def test_best_permutation_and_pose_metrics_match_jax():
    """The cases of tests/test_eval.py (exhaustive up to 6, Hungarian past
    it, more GT than results) and a stream of frames with invalid GT and
    empty frames through PoseEvalAccumulator."""
    rng = np.random.default_rng(0)
    tables = [np.array([[0.1, 5.0], [5.0, 0.2]]),
              np.array([[5.0, 0.1], [0.2, 5.0]]),
              np.array([[3.0], [0.5], [2.0]])]
    tables += [rng.random(s) for s in [(3, 5), (5, 3), (6, 6), (7, 5),
                                       (5, 8), (9, 9), (12, 12)]]
    for t in tables:
        assert pose_metrics.best_permutation(t) == jpm.best_permutation(t)
    assert pose_metrics.best_permutation(np.zeros((0, 3))) == []
    acc = pose_metrics.PoseEvalAccumulator(PANOPTIC.used_joints)
    jacc = jpm.PoseEvalAccumulator(J_PANOPTIC.used_joints)
    for f in range(12):
        G, R = int(rng.integers(0, 8)), int(rng.integers(0, 8))
        gt = rng.normal(size=(G, 18, 3)).astype(np.float32)
        gv = rng.random((G, 18)) > 0.1
        pv = rng.random(G) > 0.15
        res = np.concatenate([gt[:R] + rng.normal(0, 0.05, gt[:R].shape),
                              rng.normal(size=(max(R - G, 0), 18, 3))])
        res = res.astype(np.float32)
        np.testing.assert_allclose(
            pose_metrics.pose_error_table(gt, gv, res, PANOPTIC.used_joints),
            jpm.pose_error_table(gt, gv, res, J_PANOPTIC.used_joints),
            atol=METRIC_TOL)
        acc.update(gt, gv, pv, res)
        jacc.update(gt, gv, pv, res)
    _assert_report(acc.summary(), jacc.summary(), METRIC_TOL, METRIC_TOL)


def test_reprojection_errors_match_jax():
    rng = np.random.default_rng(1)
    rig = synthetic_ring_rig(PANOPTIC)
    poses = (rng.normal(0, 0.4, (3, 18, 3)) + [0, -1.0, 0]).astype(
        np.float32)
    kp = rng.uniform(0, 1900, (3, 5, 18, 2)).astype(np.float32)
    obs = rng.random((3, 5, 18)) > 0.2
    sub = rig.select(range(5))
    got = reprojection.reprojection_pixel_errors(poses, kp, obs,
                                                 sub.to("cpu"))
    ref = jrep.reprojection_pixel_errors(poses, kp, obs,
                                         j_ring(J_PANOPTIC).select(range(5)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=PX_TOL, rtol=1e-6)
    assert reprojection.per_camera_stats(got)["mean_px"] == pytest.approx(
        jrep.per_camera_stats(ref)["mean_px"], rel=1e-6)
    empty = reprojection.reprojection_pixel_errors(
        np.zeros((0, 18, 3)), kp[:0], obs[:0], sub.to("cpu"))
    assert empty == [[] for _ in range(5)]
    timing = TimingAccumulator()
    with timing.span("t", 2):
        pass
    assert set(timing.summary()) == {"t_ms", "t_per_person_ms"}


def test_matcher_scenes_match_jax():
    rig = synthetic_ring_rig(PANOPTIC)
    inputs = [generate_single_person_frames(PANOPTIC, rig, 6, seed=s,
                                            noise=NOISE) for s in (1, 2, 3)]
    topo = build_topology(len(PANOPTIC.matching_camera_indices()), 4)
    from mpe3d_tpu.matching.features import build_topology as j_topo
    jt = j_topo(len(J_PANOPTIC.matching_camera_indices()), 4)
    for augment in (False, True):
        got = matcher_data.build_matcher_scenes(inputs, PANOPTIC, topo,
                                                limit=12, seed=4,
                                                augment=augment)
        ref = jmd.build_matcher_scenes(inputs, J_PANOPTIC, jt, limit=12,
                                       seed=4, augment=augment)
        assert len(got) == len(ref) > 0
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(ref, f.name))
    assert (matcher_data.camera_subset_augment(inputs[0], PANOPTIC)
            == jmd.camera_subset_augment(inputs[0], J_PANOPTIC))


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------


def _assert_report(got, ref, rel=REL_TOL, ap=AP_TOL):
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k]
        if k.startswith("t_"):
            assert np.isfinite(g) or np.isnan(r)
        elif k in COUNTS or k == "cameras":
            assert g == r, (k, g, r)
        elif k == "ap_per_threshold":
            for th in r:
                for m in r[th]:
                    assert abs(g[th][m] - r[th][m]) <= ap, (k, th, m)
        elif k in ("mAP", "mR"):
            assert abs(g - r) <= ap * 100, (k, g, r)
        elif isinstance(r, dict):
            _assert_report(g, r, rel, ap)
        elif isinstance(r, list):
            np.testing.assert_allclose(g, r, rtol=rel, atol=1e-9)
        else:
            np.testing.assert_allclose(g, r, rtol=rel, atol=METRIC_TOL,
                                       err_msg=k)


@pytest.fixture(scope="module")
def pipes():
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                         heads=HEADS)
    lcfg = LifterConfig(widths=WIDTHS)
    mtree = weights.random_matcher_tree(mcfg, 0)
    ltree = weights.random_lifter_tree(lcfg, 1)
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    port = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu", "fp32"), device="cpu",
        **KW)
    ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), as_jax(mtree),
                    JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim,
                                   hidden=HIDDEN, heads=HEADS),
                    as_jax(ltree), JLifterConfig(widths=WIDTHS),
                    use_frame_kernel=False, serve_dtype=False, **KW)
    return port, ref, (mcfg, mtree)


@pytest.mark.parametrize("mode", [
    dict(), dict(decode_on_device=True), dict(fused=True),
    dict(stream=2, dedup_gt=True), dict(tuple_input=True, dataset=True)])
def test_run_pose_metrics_matches_jax(pipes, wire, mode):
    port, ref, _ = pipes
    mode = dict(mode)
    on_device = mode.pop("decode_on_device", False)
    tupled = mode.pop("tuple_input", False)
    if mode.pop("dataset", False):
        T = np.eye(4)
        T[:3, 3] = [0.05, -0.02, 0.1]
        mode["dataset_T_wc1"] = T @ np.asarray(port.rig.T_wc[1], np.float64)
    text = json.dumps(wire).encode()
    p_in = (frames.parse_frames_batch(text, PANOPTIC, with_gt=True)
            if tupled else wire)
    j_in = (jframes.parse_frames_batch(text, J_PANOPTIC, with_gt=True)
            if tupled else wire)
    port.decode_on_device = ref.decode_on_device = on_device
    try:
        got = runners.run_pose_metrics(p_in, PANOPTIC, port, datastep=1,
                                       **mode)
        exp = jrun.run_pose_metrics(j_in, J_PANOPTIC, ref, datastep=1,
                                    **mode)
    finally:
        port.decode_on_device = ref.decode_on_device = False
    assert got["n_poses"] > 0 and got["n_matched"] > 0
    _assert_report(got, exp)


def test_run_pose_metrics_one_camera_bypass(pipes, wire):
    """A rig with one matching camera takes the staged bypass, fused or
    not."""
    port, _, (mcfg, mtree) = pipes
    rc = dataclasses.replace(
        PANOPTIC, used_cameras_skeleton_matching=PANOPTIC.camera_names[:1])
    jrc = dataclasses.replace(
        J_PANOPTIC,
        used_cameras_skeleton_matching=J_PANOPTIC.camera_names[:1])
    lcfg = LifterConfig(widths=WIDTHS)
    ltree = weights.random_lifter_tree(lcfg, 1)
    one = PoseEstimationPipeline(
        rc, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu", "fp32"), device="cpu",
        **KW)
    jone = JPipeline(jrc, j_ring(J_PANOPTIC),
                     jax.tree_util.tree_map(jnp.asarray, mtree),
                     JMatcherConfig(in_dim=jrc.matcher_feature_dim,
                                    hidden=HIDDEN, heads=HEADS),
                     jax.tree_util.tree_map(jnp.asarray, ltree),
                     JLifterConfig(widths=WIDTHS), use_frame_kernel=False,
                     serve_dtype=False, **KW)
    got = runners.run_pose_metrics(wire[:4], rc, one, datastep=1, fused=True)
    exp = jrun.run_pose_metrics(wire[:4], jrc, jone, datastep=1, fused=True)
    assert got["n_poses"] > 0
    _assert_report(got, exp)


@pytest.mark.parametrize("unassigned", ["lump", "singleton"])
def test_run_sm_metrics_matches_jax(pipes, wire, unassigned):
    port, ref, _ = pipes
    got = runners.run_sm_metrics(wire, PANOPTIC, port, datastep=1,
                                 unassigned=unassigned)
    exp = jrun.run_sm_metrics(wire, J_PANOPTIC, ref, datastep=1,
                              unassigned=unassigned)
    assert got["n_frames"] > 0
    _assert_report(got, exp, rel=METRIC_TOL)
    with pytest.raises(ValueError, match="unassigned"):
        runners.run_sm_metrics(wire, PANOPTIC, port, unassigned="x")


def test_run_sm_metrics_without_gt_matches_jax(pipes):
    port, ref, _ = pipes
    rig = synthetic_ring_rig(PANOPTIC)
    inputs = [generate_single_person_frames(PANOPTIC, rig, 5, seed=s)
              for s in (7, 8)]
    got = runners.run_sm_metrics_without_gt(inputs, PANOPTIC, port, limit=6)
    exp = jrun.run_sm_metrics_without_gt(inputs, J_PANOPTIC, ref, limit=6)
    assert got["n_scenes"] > 0
    _assert_report(got, exp, rel=METRIC_TOL)


def test_run_reprojection_error_matches_jax(pipes, wire):
    port, ref, (mcfg, mtree) = pipes
    tri = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"), None, device="cpu",
        backend="triangulation", **KW)
    jtri = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), ref.matcher_params,
                     ref.matcher_cfg, backend="triangulation",
                     use_frame_kernel=False, **KW)
    got = runners.run_reprojection_error(wire, PANOPTIC, port, tri,
                                         datastep=2, show_gt=True)
    exp = jrun.run_reprojection_error(wire, J_PANOPTIC, ref, jtri,
                                      datastep=2, show_gt=True)
    assert got["n_frames"] > 0
    _assert_report(got, exp)
    tup = runners.run_reprojection_error(
        frames.parse_frames_batch(json.dumps(wire).encode(), PANOPTIC,
                                  with_gt=True), PANOPTIC, port,
        datastep=2, show_gt=True)
    _assert_report(tup, {k: v for k, v in exp.items()
                         if k != "triangulation"})


def test_transform_gt_to_world_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(2, 18, 3)).astype(np.float32)
    a, b = (np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(2))
    Ta, Tb = np.eye(4), np.eye(4)
    Ta[:3, :3], Tb[:3, :3] = a, b
    Ta[:3, 3], Tb[:3, 3] = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_allclose(runners.transform_gt_to_world(gt, Ta, Tb),
                               jrun.transform_gt_to_world(gt, Ta, Tb),
                               atol=1e-9)
