"""The port's C++ wire parser and result formatter against the JAX
package's (``mpe3d_tpu/native``) on the same bytes: arrays, frame counts and
response lines must be equal, and the port must load its own build."""

import json
import os

import numpy as np
import pytest

from mpe3d_tpu import native as jnative
from mpe3d_tpu_torch import native
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.frames import parse_frame, parse_frames_batch
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)

CAMS = PANOPTIC.camera_names


@pytest.fixture(scope="module")
def wire_text():
    noise = SceneNoise(pixel_sigma=1.5, joint_dropout=0.1,
                       spurious_rate=0.2, camera_dropout=0.1)
    frames = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 24,
                             n_people=(1, 4), seed=3, noise=noise,
                             with_gt=True)
    return json.dumps(frames).encode(), frames


def _assert_same(text, S=10, with_gt=False):
    got = native.parse_frames_native(text, CAMS, S, 18, with_gt=with_gt)
    ref = jnative.parse_frames_native(text, CAMS, S, 18, with_gt=with_gt)
    assert (got is None) == (ref is None), text[:200]
    if ref is None:
        return None
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return got


def test_library_is_the_ports_own_build():
    lib = native.load_library()
    assert lib is not None, "g++ build of the port's parser failed"
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert native.LIB_PATH == type(native.LIB_PATH)(pkg) / "_build" / \
        "libmpe3d_torch_frame.so"
    assert native.LIB_PATH.exists()
    assert os.path.realpath(lib._name) == os.path.realpath(native.LIB_PATH)
    jlib = jnative.load_library()
    assert jlib is None or os.path.realpath(jlib._name) != \
        os.path.realpath(lib._name)


@pytest.mark.parametrize("with_gt", [False, True])
def test_parse_matches_jax_on_seeded_frames(wire_text, with_gt):
    text, frames = wire_text
    got = _assert_same(text, with_gt=with_gt)
    assert got is not None and len(got[0]) == len(frames)
    for f, frame in enumerate(frames):
        ref = parse_frame(frame, PANOPTIC, 10)
        np.testing.assert_array_equal(got[4][f], ref.present)
        np.testing.assert_allclose(got[0][f], ref.kp, atol=1e-4)


@pytest.mark.parametrize("text", [
    b"[]",
    b"[{}]",
    b'[{"trackera": ["[]", 1.5, "no_image"]}]',
    b'[{"nosuchcam": ["[{\\"0\\": [0, 1, 2, 1, 0.5]}]", 1.0]}]',
    b'[{"trackera": ["[{\\"ID\\": 7, \\"3\\": [3, 10.0, 20.0, 1, 0.9]}]",'
    b' 2.5, "no_image", [{"0": [1,2,3], "-1": [0,0,0]}]]}]',
    b'[{"trackera": ["[{\\"x5\\": [5, 1.0, 2.0, 1, 0.9]}]", 0.0]}]',
    b'[{"trackera": ["[{\\"5\\": [5, 1.0, 2.0, 1]}]", 0.0]}]',
    b'[{"trackera": [[{"5": [5, 1.0, 2.0, 1, 0.9]}], 0.0]}]',
    b'[{"trackera": ["[]", 0.0], "junk": ' + b"[" * 5000 + b"]" * 5000
    + b"}]",
    b"not json",
    b'{"trackera": ["[]", 0.0]}',
])
def test_parse_matches_jax_on_edge_cases(text):
    """Empty payloads, unknown cameras, the ID key, GT, malformed joints,
    list-encoded skeletons, hostile nesting, non-lists: the same arrays,
    or None from both."""
    _assert_same(text, S=4)


def test_parse_matches_jax_differential_fuzz():
    """Seeded frames with hostile content (unicode escapes, non-rig
    cameras, odd joint ids, missing and extra entry elements, GT lists)."""
    rng = np.random.default_rng(2026)
    cams = list(CAMS)

    def rand_skeletons():
        out = []
        for _ in range(int(rng.integers(0, 4))):
            joints = {}
            if rng.random() < 0.3:
                joints["ID"] = int(rng.integers(0, 99))
            for j in rng.choice(25, size=rng.integers(0, 8), replace=False):
                joints[str(int(j))] = [int(j), float(rng.normal(500, 300)),
                                       float(rng.normal(300, 200)),
                                       int(rng.integers(0, 2)),
                                       float(rng.random())]
            out.append(joints)
        return json.dumps(out)

    frames = []
    for _ in range(40):
        frame = {}
        for cam in rng.permutation(cams + ["ghost_cam", "weirdé"]):
            if rng.random() < 0.3:
                continue
            entry = [rand_skeletons()]
            if rng.random() < 0.8:
                entry.append(float(rng.random() * 1e6))
            if rng.random() < 0.7:
                entry.append("no_image")
            if len(entry) == 3 and rng.random() < 0.6:
                entry.append([{str(int(j)): [float(x) for x in
                                             rng.normal(0, 100, 3)]
                               for j in rng.choice(20, 3, replace=False)}
                              for _ in range(int(rng.integers(0, 20)))])
            frame[str(cam)] = entry
        frames.append(frame)
    text = json.dumps(frames).encode()
    for with_gt in (False, True):
        got = _assert_same(text, S=6, with_gt=with_gt)
        assert got is not None and len(got[0]) == len(frames)
    # the port's python path agrees with its native one on these frames
    fast = parse_frames_batch(text, PANOPTIC, 6)
    slow = parse_frames_batch(text, PANOPTIC, 6, use_native=False)
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a.present, b.present)
        np.testing.assert_allclose(a.kp, b.kp, atol=1e-4)


@pytest.mark.parametrize("text", [
    b"[]", b"[{}, {}]", b'[{"a": ["{\\"0\\": [1]}", 1.0]}]', b"{}", b"x"])
def test_count_frames_matches_jax(wire_text, text):
    assert native.count_frames_native(text) == \
        jnative.count_frames_native(text)
    assert native.count_frames_native(wire_text[0]) == len(wire_text[1])


def test_format_result_matches_jax():
    rng = np.random.default_rng(3)
    poses = (rng.standard_normal((3, 18, 3)) * 2).astype(np.float32)
    quality = (rng.random(3) * 40).astype(np.float32)
    ids = np.array([5, 2, 9], np.int32)
    cases = [dict(seq=7, poses=poses, quality=quality, track_ids=ids,
                  dropped=2, latency_ms=1.23456),
             dict(seq=0, poses=np.zeros((0, 18, 3), np.float32)),
             dict(seq=3, poses=poses[:1], quality=quality[:1],
                  latency_ms=1e4)]
    for kw in cases:
        line = native.format_result_native(**kw)
        assert line is not None and line.endswith("\n")
        assert line == jnative.format_result_native(**kw)
    bad = poses.copy()
    bad[0, 0, 0] = np.nan
    assert native.format_result_native(1, bad) is None
    with pytest.raises(ValueError):
        native.format_result_native(1, poses, quality=quality[:2])


def test_parse_frames_batch_refuses_ground_truth(wire_text):
    """``with_gt=True`` was refused until the evaluation slice; it now
    gives the JAX package's ground truth, native and python parse alike
    (exact: the same float32 cm -> m division)."""
    from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
    from mpe3d_tpu.data.frames import parse_frames_batch as j_batch

    ref = j_batch(wire_text[0], J_PANOPTIC, with_gt=True)[1]
    for use_native in (True, False):
        got = parse_frames_batch(wire_text[0], PANOPTIC, with_gt=True,
                                 use_native=use_native)[1]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if r is not None:
                assert g.camera == r.camera
                for a, b in zip(g[:3], r[:3]):
                    np.testing.assert_array_equal(a, b)
