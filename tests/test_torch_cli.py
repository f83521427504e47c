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
option the port does not have is refused with its ROADMAP.md item, and without a card and without ``--cpu``
the command fails instead of serving on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
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

from test_torch_serve import assert_records_match, run_lines

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
                          cwd=ROOT, timeout=600)


def test_serve_stdio_matches_jax(wire_lines):
    lines = wire_lines + ['{"cmd": "stats"}', "not json", '{"cmd": "close"}']
    r = _run_port(["serve", "--cpu", "--modelsdir", DEMO, "--track",
                   "--quality-gate", str(GATE_PX), "--depth", "2"],
                  "\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]
    mparams, mcfg, lparams, lcfg, prior = jcli.load_models(DEMO, J_PANOPTIC)
    ref_pipe = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mparams, mcfg,
                         lparams, lcfg, use_frame_kernel=False,
                         serve_dtype=jnp.bfloat16, lifter_prior=prior)
    ref = run_lines(JPoseServer(ref_pipe, J_PANOPTIC, depth=2,
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
    (["serve", "--multi-device"], "item 6"),
    (["serve", "--no-pallas-matcher"], "no meaning"),
    (["serve", "--fused-mlp"], "no meaning"),
    (["infer", "--fused-mlp", "--testfiles", "f.json"], "no meaning"),
])
def test_unported_options_are_refused(args, message):
    with pytest.raises(SystemExit) as e:
        cli.main([*args, "--cpu", "--modelsdir", DEMO])
    assert "not in the PyTorch port" in str(e.value.code)
    assert message in str(e.value.code)


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


@pytest.mark.parametrize("torch_file", ["skeleton_matching.tch",
                                        "pose_estimator.pytorch"])
def test_reference_torch_checkpoints_are_refused(tmp_path, torch_file):
    (tmp_path / torch_file).write_bytes(b"")
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--cpu", "--modelsdir", str(tmp_path)])
    assert "conversion, ROADMAP.md section 1, item 9" in str(e.value.code)


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
    mparams, mcfg, lparams, lcfg, prior = jcli.load_models(DEMO, J_PANOPTIC)
    ref_pipe = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), mparams, mcfg,
                         lparams, lcfg, use_frame_kernel=False,
                         serve_dtype=jnp.bfloat16, lifter_prior=prior)
    ref = run_lines(JPoseServer(ref_pipe, J_PANOPTIC, depth=2,
                                batch_window=3, batch_linger_ms=20.0),
                    lines)
    assert_records_match(got, ref)
    assert got[len(wire_lines)]["batch_window"] == 3
