"""``python -m mpe3d_tpu_torch`` against the JAX package's command line.

``serve --cpu`` over stdio (a subprocess) must answer what the JAX
package's PoseServer answers in-process on the same pair
(``models_demo/pan_irls_bf16``, the CLI's default buckets, bf16 lifter, the
synthetic ring rig both command lines fall back to), and ``infer --cpu``
must give the JAX ``cmd_infer``'s records; the tolerances are those of
``tests/test_torch_serve.py``.  So must ``infer --batch``, ``infer`` with
the triangulation backend (median, IRLS) and with geo rerank / rescue, and
``serve --batch-window 3``, and ``serve`` / ``infer`` with ``--rig
ARPLAB`` on ``models_demo/arp_irls`` (int8 lifter, IRLS prior).  Every
option without meaning in the port is refused, ``serve --multi-device``
serves as ``serve`` does, and without a card and without ``--cpu``
the command fails instead of serving on the CPU.  The evaluation and
training commands print the JAX CLI's numbers; ``train-matcher`` tracks
the JAX CLI's epoch lines; ``convert-torch`` / ``export-torch`` and
``export-servable`` write the files the JAX CLI writes (int8 leaves and
bf16 bits equal), each command line serves the other's export and the
reference's torch files alike, and ``infer --profile-trace`` writes a
trace without changing the output.  ``show-results`` and
``convert-panoptic`` run with ``--cpu``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu import cli as jcli
from mpe3d_tpu.config import ARPLAB as J_ARPLAB
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu.serve import PoseServer as JPoseServer
from mpe3d_tpu.tracking import PoseTracker as JTracker
from mpe3d_tpu_torch import cli
from mpe3d_tpu_torch.config import ARPLAB, PANOPTIC
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig

from test_convert import fake_sequence  # noqa: F401
from test_torch_serve import assert_records_match, run_lines
from torch_testing import jax_models, jax_pipeline, subprocess_env

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEMO = os.path.join(ROOT, "models_demo", "pan_irls_bf16")
ARP_DEMO = os.path.join(ROOT, "models_demo", "arp_irls")
# the random ARPLAB matcher's seed under which every present pair decodes
ARP_RANDOM_SEED = 2
GATE_PX = 40.0


@pytest.fixture(scope="module")
def wire_lines():
    # seed 3: two of these frames decode a person with the trained matcher
    frames = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 4,
                             n_people=(6, 8), seed=3)
    return [json.dumps(f) for f in frames]


def _run_port(args, stdin=""):
    return subprocess.run([sys.executable, "-m", "mpe3d_tpu_torch", *args],
                          input=stdin, capture_output=True, text=True,
                          cwd=ROOT, env=subprocess_env(), timeout=600)


def _demo_pipeline():
    """The JAX pipeline ``serve`` builds on ``DEMO``: the CLI's default
    buckets, bf16 lifter, the pair's prior, the synthetic ring rig."""
    return jax_pipeline("pan_irls_bf16", use_frame_kernel=False,
                        serve_dtype=jnp.bfloat16,
                        lifter_prior=jax_models("pan_irls_bf16")[4])


def test_serve_stdio_matches_jax(wire_lines):
    lines = wire_lines + ['{"cmd": "stats"}', "not json", '{"cmd": "close"}']
    r = _run_port(["serve", "--cpu", "--modelsdir", DEMO, "--track",
                   "--quality-gate", str(GATE_PX), "--depth", "2"],
                  "\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]
    ref = run_lines(JPoseServer(_demo_pipeline(), J_PANOPTIC, depth=2,
                                tracker_factory=lambda: JTracker(),
                                quality_gate=GATE_PX), lines)
    assert_records_match(got, ref)
    assert sum(rec.get("n_persons", 0) for rec in got) >= 2
    assert f"native {len(wire_lines)}, python 0" in r.stderr


def test_infer_matches_jax_cmd_infer(wire_lines, tmp_path):
    path = tmp_path / "frames.json"
    path.write_text("[" + ",".join(wire_lines) + "]")
    common = ["--modelsdir", DEMO, "--testfiles", str(path), "--track"]
    cli.main(["infer", "--cpu", "--stream", "3", *common,
              "--out", str(tmp_path / "port.json")])
    jcli.main(["infer", "--serve-dtype", "bf16", *common,
               "--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert_records_match(got, ref)
    assert [g["frame"] for g in got] == list(range(len(wire_lines)))
    assert sum(g["n_persons"] for g in got) >= 2


@pytest.mark.parametrize("args, message", [
    (["serve", "--no-pallas-matcher"], "no meaning"),
    (["serve", "--fused-mlp"], "no meaning"),
    (["infer", "--fused-mlp", "--testfiles", "f.json"], "no meaning"),
])
def test_unported_options_are_refused(args, message):
    with pytest.raises(SystemExit) as e:
        cli.main([*args, "--cpu", "--modelsdir", DEMO])
    assert "not in the PyTorch port" in str(e.value.code)
    assert message in str(e.value.code)


def test_serve_multi_device_matches_single_device(wire_lines):
    """``serve --multi-device`` (refused before): on the CPU one replica,
    the depth raised to twice the replica count, and the records of
    ``serve`` without it, timing apart."""
    lines = "\n".join(wire_lines[:4]) + "\n"
    one = _run_port(["serve", "--cpu", "--modelsdir", DEMO], lines)
    multi = _run_port(["serve", "--cpu", "--modelsdir", DEMO,
                       "--multi-device", "--depth", "1"], lines)
    assert multi.returncode == 0, multi.stderr
    assert "round-robin serving over 1 devices (depth 2)" in multi.stderr
    got = [json.loads(l) for l in multi.stdout.splitlines()]
    want = [json.loads(l) for l in one.stdout.splitlines()]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g.pop("latency_ms"), w.pop("latency_ms")
        assert g == w


@pytest.fixture(scope="module")
def arp_lines():
    frames = generate_frames(ARPLAB, synthetic_ring_rig(ARPLAB), 3,
                             n_people=(2, 3), seed=1)
    return [json.dumps(f) for f in frames]


@pytest.fixture(scope="module")
def arp_random(tmp_path_factory):
    """``models_demo/arp_irls`` with its matcher replaced by a numpy-seeded
    one under which every present pair decodes (the trained matcher
    decodes no person on the ring rig's frames)."""
    from mpe3d_tpu.train.checkpoint import save_checkpoint
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
    from mpe3d_tpu_torch.config import MatcherConfig

    d = tmp_path_factory.mktemp("arp_random")
    for name in ("pose_estimator.npz", "pose_estimator.json"):
        if os.path.exists(os.path.join(ARP_DEMO, name)):
            os.symlink(os.path.join(ARP_DEMO, name), d / name)
    _, mcfg = load_matcher_checkpoint(
        os.path.join(ARP_DEMO, "skeleton_matching"),
        MatcherConfig(in_dim=ARPLAB.matcher_feature_dim))
    save_checkpoint(str(d / "skeleton_matching"),
                    weights.random_matcher_tree(mcfg, ARP_RANDOM_SEED),
                    meta={"matcher_config": dataclasses.asdict(mcfg)})
    return str(d)


def test_serve_rig_arplab_matches_jax(arp_lines, arp_random):
    """``serve --rig ARPLAB`` on ``models_demo/arp_irls``'s lifter over
    stdio against the JAX PoseServer on the same pair and frames."""
    lines = arp_lines + ['{"cmd": "stats"}', '{"cmd": "close"}']
    r = _run_port(["serve", "--cpu", "--rig", "ARPLAB", "--modelsdir",
                   arp_random, "--track", "--depth", "2"],
                  "\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]
    mparams, mcfg, lparams, lcfg, prior = jcli.load_models(arp_random,
                                                           J_ARPLAB)
    assert prior == "irls"
    ref_pipe = JPipeline(J_ARPLAB, j_ring(J_ARPLAB), mparams, mcfg, lparams,
                         lcfg, use_frame_kernel=False, lifter_prior=prior)
    ref = run_lines(JPoseServer(ref_pipe, J_ARPLAB, depth=2,
                                tracker_factory=lambda: JTracker()), lines)
    assert_records_match(got, ref)
    assert sum(rec.get("n_persons", 0) for rec in got) >= 3 * 2
    assert f"native {len(arp_lines)}, python 0" in r.stderr


def test_infer_rig_arplab_matches_jax_cmd_infer(arp_lines, arp_random,
                                                tmp_path):
    """``infer --rig arplab`` (any case, as ``get_rig``) against the JAX
    ``cmd_infer``, on the trained pair and with the random matcher."""
    path = tmp_path / "frames.json"
    path.write_text("[" + ",".join(arp_lines) + "]")
    n_persons = 0
    for models in (ARP_DEMO, arp_random):
        common = ["--modelsdir", models, "--testfiles", str(path)]
        cli.main(["infer", "--cpu", "--rig", "arplab", *common,
                  "--out", str(tmp_path / "p.json")])
        jcli.main(["infer", "--rig", "arplab", *common,
                   "--out", str(tmp_path / "j.json")])
        got = json.loads((tmp_path / "p.json").read_text())
        assert_records_match(got,
                             json.loads((tmp_path / "j.json").read_text()))
        n_persons += sum(g["n_persons"] for g in got)
    assert n_persons >= 3 * 2


def test_missing_calibration_file_fails(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--cpu", "--modelsdir", DEMO,
                  "--tm", str(tmp_path / "nope.pickle")])
    assert "file not found" in str(e.value.code)


def test_without_cpu_and_without_a_card_serve_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: serve would run on it")
    r = _run_port(["serve", "--modelsdir", DEMO], '{"cmd": "close"}\n')
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr
    assert r.stdout == ""


def test_infer_batch_matches_jax_cmd_infer(wire_lines, tmp_path):
    """``infer --batch``: one ``infer_batch`` over the files' frames."""
    path = tmp_path / "frames.json"
    path.write_text("[" + ",".join(wire_lines) + "]")
    common = ["--modelsdir", DEMO, "--testfiles", str(path), "--batch"]
    cli.main(["infer", "--cpu", *common, "--out", str(tmp_path / "p.json")])
    jcli.main(["infer", "--serve-dtype", "bf16", *common,
               "--out", str(tmp_path / "j.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert_records_match(got, json.loads((tmp_path / "j.json").read_text()))
    assert sum(g["n_persons"] for g in got) >= 2


@pytest.mark.parametrize("extra", [
    ["--backend", "triangulation", "--tri-variant", "median"],
    ["--backend", "triangulation", "--tri-variant", "irls"],
    ["--geo-rerank", "0.3", "--geo-rescue", "0.001",
     "--geo-rescue-dist", "0.05"],
])
def test_infer_eager_options_match_jax_cmd_infer(wire_lines, tmp_path,
                                                 extra):
    """The triangulation backend and the geometric rerank / rescue through
    ``infer`` (the eager path): the JAX ``cmd_infer``'s records."""
    path = tmp_path / "frames.json"
    path.write_text("[" + ",".join(wire_lines) + "]")
    common = ["--modelsdir", DEMO, "--testfiles", str(path), *extra]
    cli.main(["infer", "--cpu", *common, "--out", str(tmp_path / "p.json")])
    jcli.main(["infer", "--serve-dtype", "bf16", *common,
               "--out", str(tmp_path / "j.json")])
    got = json.loads((tmp_path / "p.json").read_text())
    assert_records_match(got, json.loads((tmp_path / "j.json").read_text()))


def test_serve_batch_window_stdio_matches_jax(wire_lines):
    """``serve --batch-window 3 --warmup`` over stdio: the JAX server's
    records with the same window (control lines flush the window)."""
    lines = (wire_lines + ['{"cmd": "stats"}'] + wire_lines[:2]
             + ['{"cmd": "close"}'])
    r = _run_port(["serve", "--cpu", "--modelsdir", DEMO, "--depth", "2",
                   "--batch-window", "3", "--batch-linger-ms", "20",
                   "--warmup"], "\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]
    ref = run_lines(JPoseServer(_demo_pipeline(), J_PANOPTIC, depth=2,
                                batch_window=3, batch_linger_ms=20.0),
                    lines)
    assert_records_match(got, ref)
    assert got[len(wire_lines)]["batch_window"] == 3


# ---------------------------------------------------------------------------
# evaluation and lifter training (the JAX CLI's numbers, in-process)
# ---------------------------------------------------------------------------

EVAL_REL = 1e-4       # MPJPE, pixels and losses of fp32 nets; counts equal
NARROW = dict(hidden=(8, 8), heads=(2, 2))
# the narrow random matcher's seed under which the CLI's threshold (0.5)
# decodes persons on the test files
NARROW_MATCHER_SEED = 4


def _report(capsys, fn, argv):
    capsys.readouterr()
    fn(argv)
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def _assert_numbers(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            if not k.startswith("t_"):        # wall-clock timings
                _assert_numbers(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_numbers(g, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert g_close(got, ref), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def g_close(a, b):
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= EVAL_REL * max(
        1.0, abs(b))


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """Wire files from ``generate-synthetic`` and a models directory with a
    narrow numpy-seeded matcher and lifter (fp32), saved by the port's
    ``save_checkpoint``; both command lines read their architecture from
    the metas."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.config import LifterConfig as LCfg
    from mpe3d_tpu_torch.config import MatcherConfig as MCfg

    d = tmp_path_factory.mktemp("eval")
    for name, extra in (("train", ["--single-person", "--frames", "40",
                                   "--seed", "1"]),
                        ("dev", ["--single-person", "--frames", "16",
                                 "--seed", "2"]),
                        ("test", ["--frames", "12", "--seed", "3",
                                  "--max-people", "3"])):
        cli.main(["generate-synthetic", "--output", str(d / f"{name}.json"),
                  *extra])
    models = d / "models"
    mcfg = MCfg(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    lcfg = LCfg(widths=(64, 64))
    save_checkpoint(str(models / "skeleton_matching"),
                    weights.random_matcher_tree(mcfg, NARROW_MATCHER_SEED),
                    meta={"matcher_config": dataclasses.asdict(mcfg)})
    save_checkpoint(str(models / "pose_estimator"),
                    weights.random_lifter_tree(lcfg, 1),
                    meta={"lifter_config": lcfg, "prior": "mean",
                          "epoch": 0})
    return d


def test_generate_synthetic_and_merge_jsons_match_jax_cli(tmp_path):
    for extra in (["--single-person"], ["--max-people", "3", "--no-gt"]):
        args = ["--frames", "5", "--seed", "4", *extra]
        cli.main(["generate-synthetic", "--output", str(tmp_path / "p.json"),
                  *args])
        jcli.main(["generate-synthetic", "--output", str(tmp_path / "j.json"),
                   *args])
        assert (tmp_path / "p.json").read_text() == \
            (tmp_path / "j.json").read_text()
    parts = [str(tmp_path / "p.json"), str(tmp_path / "j.json")]
    cli.main(["merge-jsons", *parts, str(tmp_path / "pm.json")])
    jcli.main(["merge-jsons", *parts, str(tmp_path / "jm.json")])
    assert (tmp_path / "pm.json").read_text() == \
        (tmp_path / "jm.json").read_text()


@pytest.mark.parametrize("command", [
    ["metrics-from-model", "--fused", "--datastep", "2"],
    ["metrics-from-model", "--stream", "3", "--dedup-gt", "--datastep", "2"],
    ["metrics-from-triangulation", "--device-decode", "--datastep", "3"],
    ["sm-metrics", "--unassigned", "singleton", "--datastep", "2"],
    ["sm-metrics-without-gt", "--limit", "8"],
    ["reprojection-error", "--showgt", "--datastep", "3"],
])
def test_eval_commands_match_jax_cli(eval_dir, capsys, command):
    """Each evaluation command with ``--cpu`` against the JAX CLI on the
    same files and checkpoints, fp32 lifter on both sides."""
    files = ([str(eval_dir / "train.json"), str(eval_dir / "dev.json")]
             if command[0] == "sm-metrics-without-gt"
             else [str(eval_dir / "test.json")])
    argv = [*command, "--cpu", "--modelsdir", str(eval_dir / "models"),
            "--serve-dtype", "fp32", "--testfiles", *files]
    got = _report(capsys, cli.main, argv)
    ref = _report(capsys, jcli.main, argv)
    _assert_numbers(got, ref)
    assert got.get("n_frames", got.get("n_scenes")) > 0
    assert got.get("n_poses", 1) > 0


def _epoch_lines(text):
    return [[float(line.split("|")[i].split()[-1]) for i in (1, 2)]
            for line in text.splitlines() if line.startswith("epoch")]


def test_train_lifter_matches_jax_cli(eval_dir, capsys, tmp_path):
    """``train-lifter --resume`` from the same narrow checkpoint in both
    command lines, one batch an epoch (so the shuffles agree): the epoch
    lines within 1e-3 relative; the port's checkpoint loads in JAX and
    serves ``metrics-from-model``; ``--optimise-matrices`` writes
    ``refined_rig.npz``; the resume checks; ``--ckpt-backend orbax``
    (refused before) writes a checkpoint the JAX command line reads."""
    from mpe3d_tpu.geometry.camera import load_rig_npz as j_load_rig

    runs = {}
    for name, main in (("p", cli.main), ("j", jcli.main)):
        d = tmp_path / name
        d.mkdir()
        for f in ("pose_estimator.npz", "pose_estimator.json"):
            (d / f).write_bytes((eval_dir / "models" / f).read_bytes())
        capsys.readouterr()
        main(["train-lifter", "--cpu", "--modelsdir", str(d), "--resume",
              "--trainset", str(eval_dir / "train.json"),
              "--devset", str(eval_dir / "dev.json"), "--epochs", "6",
              "--batch-size", "200", "--loss", "per_term"])
        runs[name] = capsys.readouterr().out
    assert "dataset length: 200 (dev 80)" in runs["p"]
    np.testing.assert_allclose(_epoch_lines(runs["p"]),
                               _epoch_lines(runs["j"]), rtol=1e-3)
    assert len(_epoch_lines(runs["p"])) == 2
    # the port's trained checkpoint through the JAX loader and CLI
    (tmp_path / "p" / "skeleton_matching.npz").write_bytes(
        (eval_dir / "models" / "skeleton_matching.npz").read_bytes())
    jcli.main(["metrics-from-model", "--cpu", "--modelsdir",
               str(tmp_path / "p"), "--testfiles",
               str(eval_dir / "test.json"), "--fused"])
    # --optimise-matrices, fresh, full width
    d = tmp_path / "om"
    cli.main(["train-lifter", "--cpu", "--modelsdir", str(d),
              "--trainset", str(eval_dir / "dev.json"),
              "--devset", str(eval_dir / "dev.json"), "--epochs", "1",
              "--batch-size", "40", "--optimise-matrices"])
    assert (d / "pose_estimator.npz").exists()
    assert j_load_rig(str(d / "refined_rig.npz")).T_wc.shape == (
        PANOPTIC.n_cameras, 4, 4)
    base = ["train-lifter", "--cpu", "--trainset",
            str(eval_dir / "dev.json"), "--devset", str(eval_dir / "dev.json")]
    for extra, message in (
            (["--modelsdir", str(tmp_path / "none"), "--resume"],
             "no checkpoint"),
            (["--modelsdir", str(tmp_path / "p"), "--resume", "--prior",
              "irls"], "prior=mean"),
            (["--modelsdir", DEMO, "--resume"], "serving-only")):
        with pytest.raises(SystemExit) as e:
            cli.main([*base, *extra])
        assert message in str(e.value.code)
    ox = tmp_path / "ox"
    cli.main([*base, "--modelsdir", str(ox), "--ckpt-backend", "orbax",
              "--epochs", "1", "--batch-size", "80"])
    assert (ox / "pose_estimator.orbax").is_dir()
    lparams = jcli.load_models(str(ox), J_PANOPTIC)[2]
    assert len(lparams["layers"]) == 9


@pytest.mark.parametrize("command", ["show-results", "convert-panoptic"])
def test_last_ported_commands_run_on_the_cpu(command, eval_dir,
                                             fake_sequence, tmp_path,
                                             capsys):
    """The two commands the port refused until it had the viewers and the
    conversor parse and run with ``--cpu`` (``tests/test_torch_viz.py`` and
    ``tests/test_torch_convert_panoptic.py`` hold them to JAX)."""
    if command == "show-results":
        out = tmp_path / "viewer.html"
        argv = [command, "--cpu", "--modelsdir", str(eval_dir / "models"),
                "--testfiles", str(eval_dir / "test.json"), "--max-frames",
                "3", "--out", str(out)]
    else:
        out = tmp_path / "160906_fake1_from_image_multi.json"
        argv = [command, fake_sequence, "--cpu", "--nodes", "3", "6",
                "--max-frames", "1", "--out-dir", str(tmp_path)]
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    if command == "convert-panoptic":
        frames = json.loads(out.read_text())
        assert len(frames) == 1 and set(frames[0]) == {"trackera",
                                                       "trackerb"}
        assert (tmp_path / "tm_160906_fake1.pickle").exists()
    else:
        assert "<canvas" in out.read_text()


def test_serve_batch_window_joins_its_flusher(wire_lines, monkeypatch):
    """``handle_stream`` with a batch window returns with its flusher
    thread joined (an unjoined daemon flusher could be inside
    ``submit_batch`` at interpreter exit).  The flusher is made slow to
    leave (its stop event's wait lingers once set), so a flusher that is
    not joined is still alive when the call returns."""
    import threading
    import time

    from mpe3d_tpu_torch import serve as serve_mod

    class SlowEvent(threading.Event):
        def wait(self, timeout=None):
            was_set = super().wait(timeout)
            if was_set:
                time.sleep(0.2)
            return was_set

    _, _, pipe = cli.build_pipeline(cli.make_parser().parse_args(
        ["serve", "--cpu", "--modelsdir", DEMO]))
    server = serve_mod.PoseServer(pipe, PANOPTIC, batch_window=3,
                                  batch_linger_ms=1.0)
    monkeypatch.setattr(serve_mod.threading, "Event", SlowEvent)
    out = []
    for _ in range(2):
        server.handle_stream(wire_lines[:2] + ['{"cmd": "ping"}'],
                             out.append)
        assert not [t for t in threading.enumerate()
                    if t.name == "mpe3d-batch-flusher"]
    assert sum('"pong"' in line for line in out) == 2


def test_serve_track_warmup_imports_the_solver_before_frames():
    """``serve --track --warmup`` imports scipy.optimize before the first
    frame is read."""
    code = ("import sys\n"
            "from mpe3d_tpu_torch import cli, serve\n"
            "serve.PoseServer.serve_stdio = lambda self: print("
            "'scipy.optimize' in sys.modules)\n"
            f"cli.main(['serve', '--cpu', '--modelsdir', {DEMO!r}, "
            "'--track', '--warmup'])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=subprocess_env(),
                       timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True"]


# ---------------------------------------------------------------------------
# matcher training and the model files (the JAX CLI's, in-process)
# ---------------------------------------------------------------------------


def _copy_models(src, dst, names=("skeleton_matching", "pose_estimator")):
    dst.mkdir(parents=True, exist_ok=True)
    for n in names:
        for ext in (".npz", ".json"):
            if (src / (n + ext)).exists():
                (dst / (n + ext)).write_bytes((src / (n + ext)).read_bytes())
    return dst


def test_train_matcher_matches_jax_cli(eval_dir, capsys, tmp_path):
    """``train-matcher --resume`` from the same narrow checkpoint in both
    command lines, at most one batch of 8 scenes an epoch (so the
    shuffles agree; the JAX CLI's 8 virtual devices make its batch 8): the
    epoch lines and the test-set MSE within 1e-3 relative; the port's
    checkpoint is read by the JAX CLI's ``load_models``; ``--device-synth``
    trains; a missing checkpoint fails; ``--ckpt-backend orbax`` (refused
    before) writes a checkpoint the JAX command line reads."""
    files = [str(eval_dir / "train.json"), str(eval_dir / "dev.json")]
    runs = {}
    for name, main in (("p", cli.main), ("j", jcli.main)):
        d = _copy_models(eval_dir / "models", tmp_path / name,
                         ("skeleton_matching",))
        capsys.readouterr()
        main(["train-matcher", "--cpu", "--modelsdir", str(d), "--resume",
              "--trainset", *files, "--devset", *files[::-1],
              "--testset", str(eval_dir / "test.json"), "--epochs", "6",
              "--batch-size", "8", "--limit", "8"])
        runs[name] = capsys.readouterr().out
    got, ref = _epoch_lines(runs["p"]), _epoch_lines(runs["j"])
    assert len(got) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-3)

    def mse(text):
        return float(text.split("MSE for the test set")[1].split()[0])
    assert mse(runs["p"]) == pytest.approx(mse(runs["j"]), rel=1e-3)
    assert "resuming from" in runs["p"] and "opt_state=no" in runs["p"]
    # the port's trained matcher read by the JAX command line
    mparams, mcfg = jcli.load_models(str(tmp_path / "p"), J_PANOPTIC)[:2]
    assert (mcfg.hidden, mcfg.heads) == (NARROW["hidden"], NARROW["heads"])
    assert len(mparams["layers"]) == 3
    # on-device synthesis, fresh
    d = tmp_path / "synth"
    capsys.readouterr()
    cli.main(["train-matcher", "--cpu", "--modelsdir", str(d),
              "--trainset", *files, "--devset", files[1], "--epochs", "1",
              "--limit", "30", "--device-synth"])
    out = capsys.readouterr().out
    assert "device-synth bank" in out and (d / "skeleton_matching.npz").exists()
    base = ["train-matcher", "--cpu", "--trainset", *files, "--devset",
            files[1]]
    with pytest.raises(SystemExit) as e:
        cli.main([*base, "--modelsdir", str(tmp_path / "none"), "--resume"])
    assert "no checkpoint" in str(e.value.code)
    # --ckpt-backend orbax (refused before): the JAX command line reads it
    cli.main([*base, "--modelsdir", str(d), "--ckpt-backend", "orbax",
              "--epochs", "1", "--limit", "8"])
    assert (d / "skeleton_matching.orbax").is_dir()
    assert not (d / "skeleton_matching.npz").exists()
    assert len(jcli.load_models(str(d), J_PANOPTIC)[0]["layers"]) == 5


def test_convert_and_export_torch_match_jax_cli(eval_dir, tmp_path):
    """``export-torch`` of the port and of the JAX CLI write the same
    state dicts and configs; ``convert-torch`` of either's files gives
    the npz checkpoints the models directory started with."""
    from mpe3d_tpu.convert import torch_import as jimport
    from mpe3d_tpu_torch import checkpoint as ckpt

    models = str(eval_dir / "models")
    for name, main in (("p", cli.main), ("j", jcli.main)):
        main(["export-torch", "--modelsdir", models,
              "--out", str(tmp_path / name)])
    for f in ("skeleton_matching.tch", "pose_estimator.pytorch"):
        a = torch.load(tmp_path / "p" / f, weights_only=False)
        b = torch.load(tmp_path / "j" / f, weights_only=False)
        a, b = a.get("model_state_dict", a), b.get("model_state_dict", b)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (f, k)
    _, jm_cfg = jimport.load_reference_matcher(
        str(tmp_path / "p" / "skeleton_matching.tch"),
        str(tmp_path / "p" / "skeleton_matching.prms"))
    assert (jm_cfg.hidden, jm_cfg.heads) == (NARROW["hidden"],
                                             NARROW["heads"])
    for name, main in (("p", cli.main), ("j", jcli.main)):
        src = tmp_path / ("j" if name == "p" else "p")   # the other's files
        main(["convert-torch", "--lifter", str(src / "pose_estimator.pytorch"),
              "--matcher", str(src / "skeleton_matching.tch"),
              "--prms", str(src / "skeleton_matching.prms"),
              "--modelsdir", str(tmp_path / f"{name}_npz")])
        for stem in ("skeleton_matching", "pose_estimator"):
            got, _ = ckpt.read_checkpoint(str(tmp_path / f"{name}_npz"
                                              / stem))
            want, _ = ckpt.read_checkpoint(models + "/" + stem)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
    assert cli.main(["export-torch", "--modelsdir", str(tmp_path / "empty"),
                     "--out", str(tmp_path / "none")]) == 1


def test_reference_torch_files_serve_like_jax(eval_dir, tmp_path):
    """A models directory holding only the reference's torch files
    (``.tch`` + ``.prms``, ``.pytorch``): ``infer`` in both command lines
    gives the same records, and those of the npz checkpoints."""
    d = tmp_path / "torch_models"
    jcli.main(["export-torch", "--modelsdir", str(eval_dir / "models"),
               "--out", str(d)])
    assert sorted(p.name for p in d.iterdir()) == [
        "pose_estimator.pytorch", "skeleton_matching.prms",
        "skeleton_matching.tch"]
    common = ["--testfiles", str(eval_dir / "test.json"), "--serve-dtype",
              "fp32"]
    out = {}
    for name, main, models in (("p", cli.main, d), ("j", jcli.main, d),
                               ("npz", cli.main, eval_dir / "models")):
        argv = ["infer", *common, "--modelsdir", str(models),
                "--out", str(tmp_path / f"{name}.json")]
        main(argv + (["--cpu"] if main is cli.main else []))
        out[name] = json.loads((tmp_path / f"{name}.json").read_text())
    assert_records_match(out["p"], out["j"])
    assert_records_match(out["p"], out["npz"])
    assert sum(r["n_persons"] for r in out["p"]) > 0


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_export_servable_matches_jax_cli(eval_dir, tmp_path, dtype):
    """``export-servable --dtype int8|bf16``: the port's npz leaves equal
    the JAX CLI's bit for bit (int8 weights and fp32 scales, bf16 bit
    patterns), the meta says ``stored``; each command line serves the
    other's export with the same records; an export is not exported
    again, and ``train-lifter --resume`` refuses it."""
    from mpe3d_tpu_torch import checkpoint as ckpt

    models = str(eval_dir / "models")
    for name, main in (("p", cli.main), ("j", jcli.main)):
        main(["export-servable", "--modelsdir", models, "--dtype", dtype,
              "--out", str(tmp_path / name)])
    got, gmeta = ckpt.read_checkpoint(str(tmp_path / "p" / "pose_estimator"))
    want, wmeta = ckpt.read_checkpoint(str(tmp_path / "j" / "pose_estimator"))
    assert gmeta == wmeta and gmeta["stored"] == dtype
    assert [x.dtype for x in got] == [y.dtype for y in want]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert any(x.dtype == (np.int8 if dtype == "int8" else np.uint16)
               for x in got)
    assert ((tmp_path / "p" / "skeleton_matching.npz").read_bytes()
            == (eval_dir / "models" / "skeleton_matching.npz").read_bytes())
    common = ["--testfiles", str(eval_dir / "test.json")]
    cli.main(["infer", "--cpu", *common, "--modelsdir", str(tmp_path / "j"),
              "--out", str(tmp_path / "p.json")])
    jcli.main(["infer", *common, "--modelsdir", str(tmp_path / "p"),
               "--out", str(tmp_path / "j.json")])
    recs = json.loads((tmp_path / "p.json").read_text())
    assert_records_match(recs, json.loads((tmp_path / "j.json").read_text()))
    assert sum(r["n_persons"] for r in recs) > 0
    # export-torch of the export: the bf16 values exactly, int8 not at all
    cli.main(["export-torch", "--modelsdir", str(tmp_path / "p"),
              "--out", str(tmp_path / "torch")])
    lifter_file = tmp_path / "torch" / "pose_estimator.pytorch"
    assert (tmp_path / "torch" / "skeleton_matching.tch").exists()
    assert lifter_file.exists() == (dtype == "bf16")
    if dtype == "bf16":
        from mpe3d_tpu.convert.torch_import import load_reference_lifter
        back, _ = load_reference_lifter(str(lifter_file))
        stored = ckpt.load_lifter_checkpoint(
            str(tmp_path / "p" / "pose_estimator"),
            cli.LifterConfig(in_dim=PANOPTIC.lifter_input_dim,
                             out_dim=PANOPTIC.n_joints * 3))[0]
        for a, b in zip(back["layers"], stored["layers"]):
            np.testing.assert_array_equal(a["w"], b["w"].float().numpy())
    with pytest.raises(SystemExit) as e:
        cli.main(["export-servable", "--modelsdir", str(tmp_path / "p"),
                  "--out", str(tmp_path / "again")])
    assert "already a serving export" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(["train-lifter", "--cpu", "--modelsdir",
                  str(tmp_path / "p"), "--resume", "--trainset",
                  str(eval_dir / "dev.json"), "--devset",
                  str(eval_dir / "dev.json")])
    assert "serving-only" in str(e.value.code)


def test_infer_profile_trace(eval_dir, tmp_path):
    """``infer --profile-trace DIR`` writes a Chrome trace of the
    inference, and the records are those without it."""
    common = ["infer", "--cpu", "--modelsdir", str(eval_dir / "models"),
              "--testfiles", str(eval_dir / "test.json")]
    cli.main([*common, "--out", str(tmp_path / "plain.json")])
    cli.main([*common, "--out", str(tmp_path / "traced.json"),
              "--profile-trace", str(tmp_path / "trace")])
    plain = json.loads((tmp_path / "plain.json").read_text())
    traced = json.loads((tmp_path / "traced.json").read_text())
    assert_records_match(traced, plain)
    (trace,) = list((tmp_path / "trace").iterdir())
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
