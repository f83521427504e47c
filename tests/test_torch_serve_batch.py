"""The port's PoseServer with micro-batching (``batch_window`` > 1) and the
one-camera bypass, against the JAX package's server on the same lines.

Mirrors the five micro-batching tests of ``tests/test_serve.py`` (batched
matches unbatched, the linger flush, control ordering, one response per
seq on a partial failure, FIFO order on a submit failure) on the port's
server, and holds its records to the JAX server's (batched on both sides):
equal apart from ``latency_ms``, poses within 1e-2 m, quality within
0.5 px (``tests/test_torch_serve.py``).  The port's pipelines serve the
batch through its batch body (``use_frame_kernel=True`` on the CPU) and
through the eager body frame by frame (the CPU's default).
"""

import dataclasses
import json
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu import serve as jserve
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import serve, weights
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

from test_torch_serve import (HEADS, HIDDEN, WIDTHS, _trees,
                              assert_records_match, run_lines)

KW = dict(slot_buckets=(4,), person_buckets=(8,), threshold=0.05,
          decode_top_k=0)


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(rig_config=PANOPTIC, **kw):
    mcfg, mtree, lcfg, ltree = _trees()
    if rig_config is not PANOPTIC:
        mcfg = dataclasses.replace(mcfg,
                                   in_dim=rig_config.matcher_feature_dim)
        mtree = weights.random_matcher_tree(mcfg, 0)
    return PoseEstimationPipeline(
        rig_config, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), device="cpu",
        **{**KW, **kw})


def _ref(rig_config=J_PANOPTIC):
    mcfg, mtree, lcfg, ltree = _trees()
    if rig_config is not J_PANOPTIC:
        mtree = weights.random_matcher_tree(
            dataclasses.replace(mcfg, in_dim=rig_config.matcher_feature_dim),
            0)
    return JPipeline(
        rig_config, j_ring(J_PANOPTIC), _as_jax(mtree),
        JMatcherConfig(in_dim=rig_config.matcher_feature_dim, hidden=HIDDEN,
                       heads=HEADS),
        _as_jax(ltree), JLifterConfig(widths=WIDTHS),
        use_frame_kernel=False, serve_dtype=jnp.bfloat16, **KW)


@pytest.fixture(scope="module", params=["batch body", "eager body"])
def pipes(request):
    return (_port(use_frame_kernel=True if request.param == "batch body"
                  else None), _ref())


@pytest.fixture(scope="module")
def wire_frames():
    noise = SceneNoise(pixel_sigma=1.0, joint_dropout=0.02)
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 4,
                           n_people=(1, 2), seed=31, noise=noise,
                           with_gt=False, spread=1.2)


def _servers(pipes, **kw):
    port, ref = pipes
    return (serve.PoseServer(port, PANOPTIC, max_skeletons=4, **kw),
            jserve.PoseServer(ref, J_PANOPTIC, max_skeletons=4, **kw))


def test_serve_batched_matches_unbatched(pipes, wire_frames):
    lines = [json.dumps(f) for f in wire_frames]
    p_base, _ = _servers(pipes, depth=2)
    base = run_lines(p_base, lines)
    p, j = _servers(pipes, depth=2, batch_window=3, batch_linger_ms=50.0)
    batched = run_lines(p, lines)
    assert_records_match(batched, run_lines(j, lines))
    assert [r["seq"] for r in batched] == [r["seq"] for r in base]
    for a, b in zip(base, batched):
        assert a["n_persons"] == b["n_persons"]
        np.testing.assert_allclose(a["poses_m"], b["poses_m"], atol=1e-3)
    assert sum(r["n_persons"] for r in batched) >= len(lines)


def test_serve_batched_linger_flush(pipes, wire_frames):
    """A partial window flushes after ``batch_linger_ms``: the second line
    is only sent once the first one's response has arrived."""
    server, _ = _servers(pipes, depth=2, batch_window=4,
                         batch_linger_ms=20.0)
    got = queue.Queue()
    responses = []

    def write(line):
        responses.append(json.loads(line))
        got.put(1)

    def lines():
        yield json.dumps(wire_frames[0])
        got.get(timeout=30)
        yield json.dumps(wire_frames[1])

    server.handle_stream(lines(), write)
    assert [r["seq"] for r in responses] == [0, 1]
    assert all("poses_m" in r for r in responses)


def test_serve_batched_control_ordering(pipes, wire_frames):
    lines = [json.dumps(wire_frames[0]), json.dumps(wire_frames[1]),
             '{"cmd": "stats"}', json.dumps(wire_frames[2])]
    p, j = _servers(pipes, depth=2, batch_window=4,
                    batch_linger_ms=10_000.0)
    recs = run_lines(p, lines)
    assert_records_match(recs, run_lines(j, lines))
    # stats flushes the partial window first (strict ordering)
    assert recs[0]["seq"] == 0 and recs[1]["seq"] == 1
    assert recs[2]["frames"] == 2 and recs[2]["batch_window"] == 4
    assert recs[3]["seq"] == 2 and "poses_m" in recs[3]


def test_serve_batched_partial_finish_failure_one_response_per_seq(
        pipes, wire_frames):
    """A host failure on one frame of a batch (here the tracker) answers
    that frame alone, once."""

    class ExplodingTracker:
        calls = 0

        def update(self, poses):
            ExplodingTracker.calls += 1
            if ExplodingTracker.calls == 2:
                raise RuntimeError("tracker blew up on frame 1")
            return np.arange(len(poses)), poses

    server = serve.PoseServer(pipes[0], PANOPTIC, max_skeletons=4, depth=2,
                              batch_window=3, batch_linger_ms=50.0,
                              tracker=ExplodingTracker())
    recs = run_lines(server, [json.dumps(f) for f in wire_frames[:3]])
    assert [r["seq"] for r in recs] == [0, 1, 2]
    assert "poses_m" in recs[0] and "poses_m" in recs[2]
    assert "error" in recs[1] and "tracker blew up" in recs[1]["error"]
    assert server.errors == 1 and server.frames_served == 2


def test_serve_batched_submit_failure_keeps_fifo_order(pipes, wire_frames,
                                                       monkeypatch):
    """When batch B fails to submit while batch A is still being collected,
    B's error lines come out after A's records."""
    pipe = pipes[0]
    orig_submit, orig_collect = pipe.submit_batch, pipe.collect_batch
    n_sub = {"n": 0}

    def submit(frames, pad_to=None):
        n_sub["n"] += 1
        if n_sub["n"] == 2:
            raise RuntimeError("device rejected batch")
        return orig_submit(frames, pad_to=pad_to)

    def collect(ticket):
        time.sleep(0.4)      # hold batch A while B's submit fails
        return orig_collect(ticket)

    monkeypatch.setattr(pipe, "submit_batch", submit)
    monkeypatch.setattr(pipe, "collect_batch", collect)
    server = serve.PoseServer(pipe, PANOPTIC, max_skeletons=4, depth=4,
                              batch_window=2, batch_linger_ms=10_000.0)
    recs = run_lines(server, [json.dumps(wire_frames[i % len(wire_frames)])
                              for i in range(4)])
    assert [r["seq"] for r in recs] == [0, 1, 2, 3]
    assert "poses_m" in recs[0] and "poses_m" in recs[1]
    assert "error" in recs[2] and "error" in recs[3]
    assert "device rejected batch" in recs[2]["error"]


def test_serve_batched_errors_and_close_match_jax(pipes, wire_frames):
    """Malformed lines, a control command and close inside a batched
    stream: the JAX server's records."""
    lines = [json.dumps(wire_frames[0]), "not json",
             json.dumps(wire_frames[1]), json.dumps(wire_frames[2]),
             '{"cmd": "ping"}', '[1, 2]', json.dumps(wire_frames[3]),
             '{"cmd": "close"}', json.dumps(wire_frames[0])]
    p, j = _servers(pipes, depth=3, batch_window=2, batch_linger_ms=50.0)
    recs = run_lines(p, lines)
    assert_records_match(recs, run_lines(j, lines))
    assert recs[-1]["closed"] is True
    assert p.frames_served == 4 and p.errors == 2


@pytest.mark.parametrize("batch_window", [1, 3])
def test_one_matching_camera_bypass_matches_jax(wire_frames, batch_window):
    """A rig with one matching camera: the server takes every frame through
    the staged path's bypass (``pipe(frame)``), whatever the window, as the
    JAX server does."""
    one = dataclasses.replace(
        PANOPTIC, used_cameras_skeleton_matching=PANOPTIC.camera_names[:1])
    jone = dataclasses.replace(
        J_PANOPTIC,
        used_cameras_skeleton_matching=J_PANOPTIC.camera_names[:1])
    p = serve.PoseServer(_port(rig_config=one), one, max_skeletons=4,
                         depth=2, batch_window=batch_window)
    j = jserve.PoseServer(_ref(rig_config=jone), jone, max_skeletons=4,
                          depth=2, batch_window=batch_window)
    lines = [json.dumps(f) for f in wire_frames] + ['{"cmd": "stats"}']
    recs = run_lines(p, lines)
    assert_records_match(recs, run_lines(j, lines))
    assert all(r["n_persons"] >= 1 for r in recs[:-1])


def test_serve_batched_stress_keeps_order(pipes, wire_frames):
    """The reader and the linger flusher share the pending window: with a
    1 ms linger, a short switch interval and frame lines interleaved with
    control lines, every seq is answered exactly once, in order."""
    import sys
    lines = []
    for i in range(30):
        lines.append(json.dumps(wire_frames[i % len(wire_frames)]))
        if i % 7 == 6:
            lines.append('{"cmd": "ping"}')
    server, _ = _servers(pipes, depth=3, batch_window=3, batch_linger_ms=1.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        recs = run_lines(server, lines)
    finally:
        sys.setswitchinterval(old)
    assert [r["seq"] for r in recs if "seq" in r] == list(range(30))
    assert sum(1 for r in recs if r.get("pong")) == 4
    assert all("poses_m" in r for r in recs if "seq" in r)
    assert server.frames_served == 30 and server.errors == 0
