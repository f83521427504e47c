"""The port's viewers and ``show-results`` against the JAX package.

``viz/html_viewer.py`` writes the JAX package's file byte for byte on the
same numpy inputs (overlays, hostile title, a short GT list, empty frames),
and ``viz/live_viewer.py`` serves the same page and the same SSE bytes for
the same pushed frames.  ``viz/viewer.py`` writes a GIF and PNG frames as
the JAX package's test checks them.  ``show-results --cpu`` writes an HTML
viewer whose payload holds the JAX command's persons, poses within 1e-2 m
(narrow fp32 models, both backends); ``show-results --live 0`` in a
subprocess streams the frames to an HTTP client and exits within 60 s of
SIGINT.
"""

import dataclasses
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from mpe3d_tpu import cli as jcli
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.viz.html_viewer import write_html_viewer as j_write_html
from mpe3d_tpu.viz.live_viewer import LiveViewerServer as JLiveViewer
from mpe3d_tpu_torch import cli
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.viz.html_viewer import write_html_viewer
from mpe3d_tpu_torch.viz.live_viewer import LiveViewerServer
from mpe3d_tpu_torch.viz.viewer import render_sequence

from torch_testing import subprocess_env

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
POSE_TOL_M = 1e-2
NARROW = dict(hidden=(8, 8), heads=(2, 2))
NARROW_MATCHER_SEED = 4     # decodes persons on these files at 0.5
LIVE_EVENTS = 4


def _frames(seed, n=3, people=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(people, 18, 3)).astype(np.float32)
            for _ in range(n)]


def _viewer_cases():
    f = _frames(1)
    return {
        "overlays": dict(frames_poses=f, frames_gt=_frames(2),
                         frames_track_ids=[np.array([4, 7])] * 3,
                         frames_quality=[np.array([1.25, -1.0])] * 3,
                         camera_centers=np.random.default_rng(3).normal(
                             size=(5, 3)), fps=4),
        "hostile title, short GT": dict(frames_poses=f[:2],
                                        frames_gt=[f[0]],
                                        title="a</script><b>&.json"),
        "empty frames": dict(frames_poses=[np.zeros((0, 18, 3)), f[0]]),
    }


@pytest.mark.parametrize("case", list(_viewer_cases()))
def test_html_viewer_is_jax_byte_for_byte(case, tmp_path):
    kw = _viewer_cases()[case]
    poses = kw.pop("frames_poses")
    got = write_html_viewer(poses, PANOPTIC, str(tmp_path / "p.html"), **kw)
    ref = j_write_html(poses, J_PANOPTIC, str(tmp_path / "j.html"), **kw)
    assert open(got, "rb").read() == open(ref, "rb").read()


def _sse_lines(url, n, timeout=20.0):
    """The raw bytes of the first ``n`` SSE events (keepalives skipped)."""
    out = []
    with urllib.request.urlopen(url + "events", timeout=timeout) as r:
        event = b""
        while len(out) < n:
            line = r.readline()
            event += line
            if line == b"\n":
                if not event.startswith(b":"):
                    out.append(event)
                event = b""
    return out


def test_live_viewer_serves_jax_bytes():
    cams = np.eye(3) * 2.0
    servers = [LiveViewerServer(PANOPTIC, camera_centers=cams, port=0),
               JLiveViewer(J_PANOPTIC, camera_centers=cams, port=0)]
    try:
        rng = np.random.default_rng(0)
        pushes = [dict(poses=rng.normal(size=(2, 18, 3)),
                       quality=np.array([1.5, 2.5])),
                  dict(poses=rng.normal(size=(1, 18, 3)),
                       track_ids=np.array([7]),
                       gt=rng.normal(size=(1, 18, 3))),
                  dict(poses=np.zeros((0, 18, 3)))]
        for s in servers:
            for p in pushes:
                s.push(**p)
        pages = [urllib.request.urlopen(s.url, timeout=10).read()
                 for s in servers]
        assert pages[0] == pages[1]
        assert b"EventSource('/events')" in pages[0]
        events = [_sse_lines(s.url, len(pushes)) for s in servers]
        assert events[0] == events[1]
        assert events[0][0].startswith(b"id: 0\ndata: {")
    finally:
        for s in servers:
            s.close()


@pytest.mark.parametrize("out", ["seq.gif", "pngs"])
def test_render_sequence_writes_gif_and_pngs(out, tmp_path):
    pytest.importorskip("matplotlib")
    frames = _frames(0, n=2)
    path = render_sequence(frames, PANOPTIC, str(tmp_path / out),
                           frames_gt=_frames(5, n=2),
                           frames_track_ids=[np.array([4, 7])] * 2,
                           frames_quality=[np.array([1.2, -1.0]),
                                           np.array([0.9, 33.0])], fps=2)
    if out.endswith(".gif"):
        assert os.path.getsize(path) > 1000
    else:
        names = sorted(os.listdir(path))
        assert names == ["frame_00000.png", "frame_00001.png"]
        assert all(os.path.getsize(os.path.join(path, n)) > 1000
                   for n in names)


@pytest.fixture(scope="module")
def viz_dir(tmp_path_factory):
    """A wire file with GT and a narrow numpy-seeded fp32 pair, saved in
    the npz layout both command lines read."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig

    d = tmp_path_factory.mktemp("viz")
    cli.main(["generate-synthetic", "--output", str(d / "test.json"),
              "--frames", "6", "--seed", "3", "--max-people", "3"])
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    lcfg = LifterConfig(widths=(64, 64))
    save_checkpoint(str(d / "models" / "skeleton_matching"),
                    weights.random_matcher_tree(mcfg, NARROW_MATCHER_SEED),
                    meta={"matcher_config": dataclasses.asdict(mcfg)})
    save_checkpoint(str(d / "models" / "pose_estimator"),
                    weights.random_lifter_tree(lcfg, 1),
                    meta={"lifter_config": lcfg, "prior": "mean",
                          "epoch": 0})
    return d


def _payload(path):
    text = open(path).read()
    return json.loads(re.search(r"const D=(\{.*?\});\n", text, re.S).group(1))


@pytest.mark.parametrize("backend", ["mlp", "triangulation"])
def test_show_results_html_matches_jax_cli(viz_dir, tmp_path, capsys,
                                           backend):
    argv = ["show-results", "--cpu", "--modelsdir", str(viz_dir / "models"),
            "--testfiles", str(viz_dir / "test.json"), "--serve-dtype",
            "fp32", "--backend", backend, "--showgt", "--show-quality",
            "--track"]
    assert cli.main([*argv, "--out", str(tmp_path / "p.html")]) == 0
    jcli.main([*argv, "--out", str(tmp_path / "j.html")])
    assert capsys.readouterr().out.count("wrote ") == 2
    got, ref = _payload(tmp_path / "p.html"), _payload(tmp_path / "j.html")
    assert {k: v for k, v in got.items() if k not in ("frames", "title")} \
        == {k: v for k, v in ref.items() if k not in ("frames", "title")}
    assert len(got["frames"]) == len(ref["frames"]) == 6
    n_poses = 0
    for g, r in zip(got["frames"], ref["frames"]):
        assert len(g["p"]) == len(r["p"])
        assert g.get("id") == r.get("id") and g.get("g") == r.get("g")
        if r["p"]:
            n_poses += len(r["p"])
            assert np.abs(np.array(g["p"]) - np.array(r["p"])).max() \
                <= POSE_TOL_M
    assert n_poses > 0


def test_show_results_live_streams_and_stops_on_sigint(viz_dir):
    """``--live 0`` in a subprocess: the URL on stderr, every frame as an
    SSE event to an HTTP client, then SIGINT ends it within 60 s."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpe3d_tpu_torch", "show-results", "--cpu",
         "--modelsdir", str(viz_dir / "models"), "--testfiles",
         str(viz_dir / "test.json"), "--serve-dtype", "fp32", "--live", "0",
         "--live-fps", "50", "--max-frames", str(LIVE_EVENTS)],
        cwd=ROOT, env=subprocess_env(), stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln)
                                              for ln in proc.stderr],
                              daemon=True)
    reader.start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            m = re.search(r"live viewer at (http://\S+/)", line)
            url = m and m.group(1)
        events = _sse_lines(url, LIVE_EVENTS, timeout=60)
        frames = [json.loads(e.split(b"data: ", 1)[1]) for e in events]
        assert [e.split(b"\n", 1)[0] for e in events] == [
            f"id: {i}".encode() for i in range(LIVE_EVENTS)]
        assert all(np.array(f["p"]).shape[1:] in ((18, 3), (0,))
                   for f in frames)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
