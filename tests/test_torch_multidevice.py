"""The port's multi-device serving against the JAX package's on the CPU.

Mirrors ``tests/test_multidevice_serve.py``: the port's pipeline with
``enable_multi_device_serving(devices=["cpu", "cpu"])`` (two replicas of
the weights, submits in turn) against itself on one device (persons equal,
scores within 1e-5, poses and quality within 1e-5) and against the JAX
pipeline serving over two virtual CPU devices (persons equal, scores
within 1e-5, poses within 1e-2 m and quality within 0.5 px,
``tests/test_torch_serve.py``).  ``infer_batch(mesh=...)`` over a mesh of
two local devices must give the unsplit call's results, and JAX's
``infer_batch(mesh=...)`` over two virtual devices.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu import serve as jserve
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import serve, weights
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.parallel.mesh import make_mesh
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

from test_torch_serve import (HEADS, HIDDEN, WIDTHS, _trees,
                              assert_records_match, run_lines)
import torch_testing  # noqa: F401

KW = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05,
          decode_top_k=0)
CPUS = ["cpu", "cpu"]
POSE_TOL_M, QUALITY_TOL_PX, SCORE_TOL = 1e-2, 0.5, 1e-5


def _port(backend="mlp", serve_dtype=None):
    mcfg, mtree, lcfg, ltree = _trees()
    return PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu", serve_dtype),
        device="cpu", backend=backend, **KW)


def _ref(backend="mlp", serve_dtype=jnp.bfloat16):
    _, mtree, _, ltree = _trees()
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return JPipeline(
        J_PANOPTIC, j_ring(J_PANOPTIC), as_jax(mtree),
        JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                       heads=HEADS),
        as_jax(ltree), JLifterConfig(widths=WIDTHS), use_frame_kernel=False,
        serve_dtype=serve_dtype, backend=backend, **KW)


@pytest.fixture(scope="module")
def wire():
    noise = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03)
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 8,
                           n_people=(1, 2), seed=41, noise=noise,
                           with_gt=False, spread=1.2)


@pytest.fixture(scope="module")
def frames(wire):
    return [parse_frame(f, PANOPTIC, max_skeletons=4) for f in wire]


@pytest.fixture(scope="module")
def jframes(wire):
    return [j_parse(f, J_PANOPTIC, max_skeletons=4) for f in wire]


def _same(got, ref, exact=True):
    """Persons equal and scores within 1e-5; poses and quality within 1e-5
    (``exact``: the port against itself) or the serving tolerances (the
    port against JAX)."""
    assert len(got) == len(ref)
    pose_tol, q_tol = (1e-5, 1e-5) if exact else (POSE_TOL_M, QUALITY_TOL_PX)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g.persons),
                                      np.asarray(r.persons))
        np.testing.assert_allclose(np.asarray(g.scores),
                                   np.asarray(r.scores), atol=SCORE_TOL)
        np.testing.assert_allclose(np.asarray(g.poses), np.asarray(r.poses),
                                   atol=pose_tol)
        np.testing.assert_allclose(np.asarray(g.quality),
                                   np.asarray(r.quality), atol=q_tol)


def test_round_robin_uses_every_replica(frames):
    pipe = _port()
    assert pipe.enable_multi_device_serving(devices=CPUS) == 2
    tickets = [pipe.submit_fused(f) for f in frames]
    assert pipe.replica_uses == [4, 4]
    assert len({id(r) for r in pipe._replicas}) == 2
    assert pipe._replicas[0].matcher is not pipe._replicas[1].matcher
    assert all(r.device.type == "cpu" for r in pipe._replicas)
    assert len([pipe.collect_fused(t) for t in tickets]) == len(frames)
    # None: every visible device of the pipeline's kind (here the CPU)
    assert _port().enable_multi_device_serving() == 1


def test_multi_device_matches_single_device_and_jax(frames, jframes):
    pipe = _port()
    single = [pipe.infer_fused(f) for f in frames]
    pipe.enable_multi_device_serving(devices=CPUS)
    multi = list(pipe.infer_stream(frames, depth=6))
    _same(multi, single)
    ref = _ref()
    ref.enable_multi_device_serving(devices=jax.devices()[:2])
    _same(multi, list(ref.infer_stream(jframes, depth=6)), exact=False)


def test_explicit_device_subset_triangulation(frames, jframes):
    pipe = _port(backend="triangulation")
    single = [pipe.infer_fused(f) for f in frames[:4]]
    assert pipe.enable_multi_device_serving(devices=CPUS) == 2
    outs = list(pipe.infer_stream(frames[:4], depth=4))
    assert all(len(o.poses) == len(o.quality) for o in outs)
    _same(outs, single)
    ref = _ref(backend="triangulation")
    ref.enable_multi_device_serving(devices=jax.devices()[:2])
    _same(outs, list(ref.infer_stream(jframes[:4], depth=4)), exact=False)


def test_server_over_multi_device_matches_jax(wire):
    port, ref = _port(), _ref()
    n = port.enable_multi_device_serving(devices=CPUS)
    ref.enable_multi_device_serving(devices=jax.devices()[:2])
    lines = [json.dumps(f) for f in wire[:6]] + ['{"cmd": "stats"}']
    got = run_lines(serve.PoseServer(port, PANOPTIC, max_skeletons=4,
                                     depth=2 * n), lines)
    exp = run_lines(jserve.PoseServer(ref, J_PANOPTIC, max_skeletons=4,
                                      depth=2 * n), lines)
    assert [r["seq"] for r in got[:-1]] == list(range(6))
    assert got[-1]["frames"] == 6 and got[-1]["errors"] == 0
    assert_records_match(got, exp)


def test_batch_round_robin_uses_every_replica(frames):
    pipe = _port()
    single = pipe.infer_batch(frames)
    pipe.enable_multi_device_serving(devices=CPUS)
    tickets = [pipe.submit_batch(frames[i:i + 2], pad_to=3)
               for i in range(0, len(frames), 2)]
    assert pipe.replica_uses == [2, 2]
    _same([o for t in tickets for o in pipe.collect_batch(t)], single)


def test_multi_device_int8_serving_matches_jax(frames, jframes):
    pipe = _port(serve_dtype="int8")
    single = [pipe.infer_fused(f) for f in frames[:4]]
    pipe.enable_multi_device_serving(devices=CPUS)
    multi = list(pipe.infer_stream(frames[:4], depth=4))
    _same(multi, single)
    ref = _ref(serve_dtype="int8")
    ref.enable_multi_device_serving(devices=jax.devices()[:2])
    _same(multi, list(ref.infer_stream(jframes[:4], depth=4)), exact=False)


def test_infer_batch_over_a_mesh_matches_unsplit_and_jax(frames, jframes):
    pipe = _port()
    whole = pipe.infer_batch(frames[:7])
    mesh = make_mesh(devices=CPUS)
    assert (mesh.n_data, mesh.n_model, mesh.distributed) == (2, 1, False)
    split = pipe.infer_batch(frames[:7], mesh=mesh)
    _same(split, whole)
    ref = _ref().infer_batch(jframes[:7],
                             mesh=j_make_mesh(devices=jax.devices()[:2]))
    _same(split, ref, exact=False)
    # weights reloaded into the pipeline reach its mesh replicas too
    mcfg, _, lcfg, ltree = _trees()
    pipe.reload_weights(lifter_tree=weights.random_lifter_tree(lcfg, 5))
    reps = pipe._mesh_replicas[("cpu", "cpu")]
    assert all(r.lifter is not pipe.lifter for r in reps)
    _same(pipe.infer_batch(frames[:7], mesh=mesh), pipe.infer_batch(
        frames[:7]))
