"""The port's PoseServer (``mpe3d_tpu_torch/serve.py``) against the JAX
package's (``mpe3d_tpu/serve.py``) on the same lines.

Both serve narrow numpy-seeded weights carried across by ``weights.py``:
the JAX side an MLP-backend pipeline without the whole-frame kernel and with
bf16 lifter weights and operands, the port its CPU path.  Records must be
equal apart from ``latency_ms`` (and ``mean_latency_ms``), with poses held
to 1e-2 m and quality to 0.5 px (``tests/test_torch_pipeline.py`` gives the
reasons).  The TCP cases compare what the port's socket servers answer with
the JAX server's records of the same lines.
"""

import json
import queue
import socket
import threading
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
from mpe3d_tpu.tracking import PoseTracker as JTracker
from mpe3d_tpu_torch import serve, weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
from mpe3d_tpu_torch.tracking import PoseTracker

POSE_TOL_M, QUALITY_TOL_PX = 1e-2, 0.5
HIDDEN, HEADS, WIDTHS = (8, 8), (2, 2), (64, 64)
TIMING = ("latency_ms", "mean_latency_ms")


def _trees():
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                         heads=HEADS)
    lcfg = LifterConfig(widths=WIDTHS)
    return (mcfg, weights.random_matcher_tree(mcfg, 0), lcfg,
            weights.random_lifter_tree(lcfg, 1))


@pytest.fixture(scope="module")
def pipes():
    mcfg, mtree, lcfg, ltree = _trees()
    port = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), slot_buckets=(4,),
        person_buckets=(8,), threshold=0.05, decode_top_k=0, device="cpu")
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    ref = JPipeline(
        J_PANOPTIC, j_ring(J_PANOPTIC), as_jax(mtree),
        JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                       heads=HEADS),
        as_jax(ltree), JLifterConfig(widths=WIDTHS), slot_buckets=(4,),
        person_buckets=(8,), threshold=0.05, decode_top_k=0,
        use_frame_kernel=False, serve_dtype=jnp.bfloat16)
    return port, ref


@pytest.fixture(scope="module")
def wire_frames():
    noise = SceneNoise(pixel_sigma=1.0, joint_dropout=0.02)
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 4,
                           n_people=(1, 2), seed=31, noise=noise,
                           with_gt=False, spread=1.2)


def _servers(pipes, tracker=False, **kw):
    port, ref = pipes
    if tracker:
        kw_p = dict(kw, tracker_factory=lambda: PoseTracker(max_dist=0.5))
        kw_j = dict(kw, tracker_factory=lambda: JTracker(max_dist=0.5))
    else:
        kw_p = kw_j = kw
    return (serve.PoseServer(port, PANOPTIC, max_skeletons=4, **kw_p),
            jserve.PoseServer(ref, J_PANOPTIC, max_skeletons=4, **kw_j))


def run_lines(server, lines):
    out = []
    server.handle_stream(list(lines), out.append)
    return [json.loads(line) for line in out]


def assert_records_match(got, ref):
    """Records equal apart from timing; poses and quality to tolerance."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r), (g, r)
        for k in g:
            if k in TIMING:
                continue
            if k == "poses_m":
                np.testing.assert_allclose(np.asarray(g[k]).reshape(-1),
                                           np.asarray(r[k]).reshape(-1),
                                           atol=POSE_TOL_M)
            elif k == "quality_px":
                np.testing.assert_allclose(g[k], r[k], atol=QUALITY_TOL_PX)
            else:
                assert g[k] == r[k], (k, g, r)


def _both(pipes, lines, tracker=False, **kw):
    p, j = _servers(pipes, tracker, **kw)
    got, ref = run_lines(p, lines), run_lines(j, lines)
    assert_records_match(got, ref)
    assert (p.frames_served, p.errors) == (j.frames_served, j.errors)
    return got, p


@pytest.mark.parametrize("depth", [1, 3])
def test_ordering_matches_jax(pipes, wire_frames, depth):
    lines = [json.dumps(f) for f in wire_frames] * 2
    got, p = _both(pipes, lines, depth=depth)
    assert [r["seq"] for r in got] == list(range(len(lines)))
    assert sum(r["n_persons"] for r in got) >= len(lines)
    assert p.parsed == {"native": len(lines), "python": 0}


def test_control_commands_and_errors_match_jax(pipes, wire_frames):
    lines = [json.dumps(wire_frames[0]), '{"cmd": "ping"}', "not json at all",
             json.dumps(wire_frames[1]), '{"cmd": "stats"}', "[1, 2, 3]",
             '{"id": 7, "cmd": "stats"}', '{"cmd": "nope"}', "",
             '{"cmd": "close"}', json.dumps(wire_frames[2])]
    got, _ = _both(pipes, lines, depth=3)
    assert got[1] == {"pong": True} and got[-1]["closed"] is True
    assert len(got) == 9


def test_malformed_joint_payloads_match_jax(pipes, wire_frames):
    good = json.dumps(wire_frames[0])
    cam = next(k for k in wire_frames[0] if isinstance(wire_frames[0][k],
                                                       list))
    bad_key, bad_len = json.loads(good), json.loads(good)
    skels = json.loads(bad_key[cam][0])
    skels[0]["x5"] = [5, 100.0, 200.0, 1, 0.9]
    bad_key[cam][0] = json.dumps(skels)
    skels = json.loads(bad_len[cam][0])
    first = next(k for k in skels[0] if k != "ID")
    skels[0][first] = skels[0][first][:4]
    bad_len[cam][0] = json.dumps(skels)
    got, _ = _both(pipes, [json.dumps(bad_key), json.dumps(bad_len), good])
    assert "error" in got[0] and "error" in got[1] and "poses_m" in got[2]


def test_list_encoded_skeletons_match_jax(pipes, wire_frames):
    """Skeletons sent as JSON lists: the C++ parser cannot read them, the
    python path serves them, and the stream's native backoff engages."""
    listed = []
    for frame in wire_frames:
        f = json.loads(json.dumps(frame))
        for cam in f:
            f[cam][0] = json.loads(f[cam][0])
        listed.append(json.dumps(f))
    got, p = _both(pipes, listed + [json.dumps(wire_frames[0])], depth=2)
    assert all("poses_m" in r for r in got)
    # three misses in a row: the python path reads the rest of the stream
    assert p.parsed == {"native": 0, "python": len(listed) + 1}


def test_frame_containing_cmd_substring_matches_jax(pipes, wire_frames):
    frame = dict(wire_frames[0])
    frame["note"] = 'client metadata mentioning "cmd" in a string'
    got, _ = _both(pipes, [json.dumps(frame)])
    assert "poses_m" in got[0]


def test_hostile_nesting_matches_jax(pipes, wire_frames):
    deep = "[" * 200_000 + "]" * 200_000
    lines = [f'{{"x": {deep}}}', json.dumps(wire_frames[0]),
             f'{{"cmd": "ping", "x": {deep}}}', json.dumps(wire_frames[1])]
    got, _ = _both(pipes, lines, depth=2)
    assert "error" in got[0] and "error" in got[2]


def test_quality_gate_matches_jax(pipes, wire_frames):
    lines = [json.dumps(f) for f in wire_frames]
    base = run_lines(_servers(pipes)[1], lines)
    q = np.sort(np.concatenate([r["quality_px"] for r in base]))
    # a gate in the widest gap between the qualities, so no pose sits
    # within the quality tolerance of it
    i = int(np.argmax(np.diff(q)))
    gate = float(q[i] + q[i + 1]) / 2
    assert np.abs(q - gate).min() > QUALITY_TOL_PX
    got, p = _both(pipes, lines + ['{"cmd": "stats"}'], tracker=True,
                   quality_gate=gate)
    dropped = sum(r.get("dropped_low_quality", 0) for r in got[:-1])
    assert 0 < dropped < len(q)
    assert got[-1]["dropped_low_quality"] == p.dropped_low_quality == dropped


def test_tracker_ids_match_jax(pipes, wire_frames):
    lines = [json.dumps(wire_frames[i % 2]) for i in range(6)]
    got, _ = _both(pipes, lines, tracker=True, depth=3)
    assert all(len(r["track_ids"]) == r["n_persons"] for r in got)


def test_disconnect_mid_stream_does_not_wedge(pipes, wire_frames):
    p, j = _servers(pipes, depth=2)
    wrote = []

    def write(s):
        if wrote:
            raise BrokenPipeError("client went away")
        wrote.append(s)

    lines = [json.dumps(f) for f in wire_frames] * 3
    t = threading.Thread(target=p.handle_stream, args=(iter(lines), write),
                         daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "handle_stream wedged after a disconnect"
    assert len(wrote) == 1
    assert_records_match([json.loads(wrote[0])], run_lines(j, lines[:1]))


# ---------------------------------------------------------------------------
# TCP


def _start_tcp(server, **kw):
    ready = []
    t = threading.Thread(target=serve.serve_tcp,
                         args=(server, "127.0.0.1", 0, ready), kwargs=kw,
                         daemon=True)
    t.start()
    for _ in range(200):
        if ready:
            return ready[0], t
        time.sleep(0.05)
    raise AssertionError("TCP server did not start")


def _session(port, lines, n_out, barrier=None):
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        f = s.makefile("rwb")
        if barrier is not None:
            barrier.wait()
        for line in lines:
            f.write(line if isinstance(line, bytes) else line.encode())
            f.write(b"\n")
            f.flush()
        return [json.loads(f.readline()) for _ in range(n_out)]


def test_tcp_roundtrip_and_reconnect_match_jax(pipes, wire_frames):
    p, j = _servers(pipes, tracker=True, depth=2)
    lines = [json.dumps(w) for w in wire_frames[:2]] + ['{"cmd": "close"}']
    ref = run_lines(j, lines)
    srv, t = _start_tcp(p)
    try:
        for _ in range(2):     # serial sessions: fresh track ids each time
            got = _session(srv.port, lines, 3)
            assert_records_match(got[:2], ref[:2])
            assert got[2]["closed"] is True
        assert p.frames_served == 4
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_tcp_concurrent_clients_isolated_trackers_match_jax(pipes,
                                                            wire_frames):
    p, j = _servers(pipes, tracker=True, depth=2)
    streams = [[json.dumps(wire_frames[i])] * 4 + ['{"cmd": "close"}']
               for i in range(2)]
    srv, t = _start_tcp(p, max_clients=2)
    results: "queue.Queue" = queue.Queue()
    barrier = threading.Barrier(2, timeout=60)
    clients = [threading.Thread(
        target=lambda k: results.put((k, _session(srv.port, streams[k], 5,
                                                  barrier))),
        args=(k,), daemon=True) for k in range(2)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
            assert not c.is_alive(), "client wedged"
        got = dict(results.get(timeout=10) for _ in range(2))
        for k in range(2):
            _, jk = _servers(pipes, tracker=True, depth=2)
            ref = run_lines(jk, streams[k])
            assert_records_match(got[k][:4], ref[:4])
            assert got[k][0]["track_ids"][0] == 0
        assert p.frames_served == 8 and p.errors == 0
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_tcp_non_utf8_line_matches_jax(pipes, wire_frames):
    p, j = _servers(pipes, depth=2)
    frame = json.dumps(wire_frames[0])
    ref = run_lines(j, [b"\xff\xfe{garbage".decode(errors="replace"), frame,
                        '{"cmd": "close"}'])
    srv, t = _start_tcp(p)
    try:
        got = _session(srv.port, [b"\xff\xfe{garbage", frame,
                                  '{"cmd": "close"}'], 3)
        assert_records_match(got[:2], ref[:2])
        assert "error" in got[0] and got[2]["closed"] is True
    finally:
        srv.shutdown()
        t.join(timeout=10)


# ---------------------------------------------------------------------------
# hot reload


def _save_lifter(path, seed, prior="mean", residual=False):
    from mpe3d_tpu.train.checkpoint import save_checkpoint
    path.mkdir()
    tree = weights.random_lifter_tree(
        LifterConfig(widths=WIDTHS, residual_prior=residual), seed)
    save_checkpoint(str(path / "pose_estimator"), tree,
                    meta={"prior": prior, "lifter_config": {
                        "widths": list(WIDTHS), "residual_prior": residual}})
    return str(path)


@pytest.fixture()
def fresh_pipes():
    """Pipelines of their own: reloads change their weights."""
    mcfg, mtree, lcfg, ltree = _trees()
    port = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), slot_buckets=(4,),
        person_buckets=(8,), threshold=0.05, decode_top_k=0, device="cpu")
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    ref = JPipeline(
        J_PANOPTIC, j_ring(J_PANOPTIC), as_jax(mtree),
        JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim, hidden=HIDDEN,
                       heads=HEADS),
        as_jax(ltree), JLifterConfig(widths=WIDTHS), slot_buckets=(4,),
        person_buckets=(8,), threshold=0.05, decode_top_k=0,
        use_frame_kernel=False, serve_dtype=jnp.bfloat16)
    return port, ref


def test_reload_roundtrip_matches_jax(fresh_pipes, wire_frames, tmp_path):
    good = _save_lifter(tmp_path / "good", 42)
    badprior = _save_lifter(tmp_path / "badprior", 43, prior="median")
    frame = json.dumps(wire_frames[0])
    lines = [frame, json.dumps({"cmd": "reload", "modelsdir": good}), frame,
             json.dumps({"cmd": "reload",
                         "modelsdir": str(tmp_path / "nope")}),
             json.dumps({"cmd": "reload", "modelsdir": badprior}),
             json.dumps({"cmd": "reload"}), frame]
    got, _ = _both(fresh_pipes, lines, depth=2)
    assert got[1] == {"reloaded": True, "modelsdir": good, "matcher": False,
                      "lifter": True}
    assert not np.allclose(got[0]["poses_m"], got[2]["poses_m"])
    assert "prior" in got[4]["error"]
    np.testing.assert_array_equal(got[6]["poses_m"], got[2]["poses_m"])


def test_reload_rejects_architecture_mismatch(fresh_pipes, wire_frames,
                                              tmp_path):
    """residual_prior=True at the same widths: equal shapes, another
    function; both servers refuse it and keep serving the old weights."""
    badarch = _save_lifter(tmp_path / "badarch", 44, residual=True)
    frame = json.dumps(wire_frames[0])
    lines = [frame, json.dumps({"cmd": "reload", "modelsdir": badarch}),
             frame]
    p, j = _servers(fresh_pipes, depth=2)
    got, ref = run_lines(p, lines), run_lines(j, lines)
    # the configs' reprs differ between the packages: the message up to them
    for r in (got, ref):
        assert r[1]["error"].startswith(
            "reload failed: ValueError: lifter checkpoint architecture")
    assert_records_match([got[0], got[2]], [ref[0], ref[2]])
    np.testing.assert_array_equal(got[2]["poses_m"], got[0]["poses_m"])
