"""A run's last lines, the imports a run may load, a cell added as files
and manifest entries only, and a loop of a new kind run by ``run_cell``."""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.cell import HERE, ROOT, load
from portbench.run import run_cell, tiny
from portbench.tests.queued import load_any

ENV = dict(os.environ, PYTHONPATH=ROOT)


def _run(args, cwd=ROOT, env=ENV, timeout=600):
    return subprocess.run([sys.executable, "-m", "portbench", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace):
    p = _run(["--workload", "panoptic.batch_s4", "--seed", "4294967301",
              "--seconds", "1", "--trace", str(trace), "--cpu"])
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"score_gap", "decode_miss", "pose_gap",
                                  "quality_gap"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    err = p.stderr.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-4:])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "submit_ms.batch" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"frames_per_s", "batch_p95_ms",
                                       "setup_s"}


def test_stream_cell_rehearses(capsys):
    """The queued live cell (``portbench/queued/``) at rehearsal size."""
    cell = tiny(load_any("panoptic.stream_live"))
    out = run_cell(cell, 4294967303, 1.0, False, "cpu", time.time())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"live_frames_per_s", "frame_p95_ms",
                                   "setup_s"}
    assert set(out["checks"]) == {"score_gap", "decode_miss", "pose_gap",
                                  "quality_gap"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith(f"stream: {out['attempted']} frames")


NEW_KIND = """
import time
from portbench.loops import Measured

def setup(cell, seed, device, build_program=True):
    return {"seed": seed}

def measure(st, seconds, seed, tracer, trace_at, trace_s):
    return Measured({"frames_per_s": 4.0}, time.time(), 9, st["failed"],
                    0.5)

def judge(st, got):
    return {"gap": got}

def layer_context(st, m, tracer):
    return {}

def control(st, seed):
    return {"gap": 2.0}

def tiny(cfg, tr):
    pass
"""


@pytest.mark.parametrize("failed", [0, 2])
def test_a_loop_of_a_new_kind_runs_through_run_cell(tmp_path, failed):
    path = tmp_path / "counted.py"
    path.write_text(NEW_KIND)
    spec = importlib.util.spec_from_file_location("portbench_loop_counted",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cell = load("panoptic.batch_s4")
    cell.loop, cell.limits = mod, {"gap": 1.0}
    out = run_cell(cell, 3, 0.1, False, "cpu", time.time(),
                   fault=lambda st: st.update(failed=failed))
    assert out["attempted"] == 9 and out["failed"] == failed
    assert out["correct"] is (failed == 0)
    assert out["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert out["metrics"]["frames_per_s"]["value"] == 4.0
    assert "setup_s" in out["metrics"]


def test_no_card_no_result():
    p = _run(["--workload", "panoptic.batch_s4", "--seed", "1", "--seconds",
              "1", "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_manifest_and_paths_is_not_enough(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    p = _run(["--workload", "panoptic.batch_s4", "--seed", "1", "--seconds",
              "1", "--trace", "0", "--cpu"], cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_imports_by_whole_top_level_name():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(HERE)
               for f in fs if f.endswith(".py")]
    for path in sources:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "mpe3d_tpu"}, path
        rel = os.path.relpath(path, HERE)
        if "mpe3d_tpu_torch" in tops:
            assert rel in ("program.py",) or rel.startswith("tests"), rel
    refs = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "reference"))
                  if f.endswith(".py") and f != "__init__.py")
    code = ("import sys, " + ", ".join("portbench.reference." + r
                                       for r in refs) + ";"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=120)
    loaded = set(json.loads(p.stdout.replace("'", '"')))
    assert not loaded & {"mpe3d_tpu_torch", "mpe3d_tpu", "jax", "jaxlib",
                         "flax"}


def test_a_cell_added_as_files_only(tmp_path):
    """A new mix, limits, per-layer metric and cell: new files and new
    manifest entries, no existing file edited."""
    root = tmp_path
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "portbench").rglob("*") if q.is_file())}
    mix = json.load(open(os.path.join(HERE, "traffic", "batch_s4.json")))
    mix.update(people=[3, 3], why="three people a frame")
    (root / "portbench/traffic/batch_s4_three.json").write_text(
        json.dumps(mix))
    (root / "portbench/limits/panoptic.batch_s4_three.json").write_text(
        open(os.path.join(HERE, "limits", "panoptic.batch_s4.json")).read())
    (root / "portbench/metrics/persons_per_frame.batch.py").write_text(
        "def read(ctx):\n"
        "    n = len(ctx['persons'])\n"
        "    return float(ctx['persons'].sum()) / n if n else None\n")
    man["workloads"].append({"name": "panoptic.batch_s4_three",
                             "config": "panoptic", "traffic": "batch_s4_three",
                             "chips": 1, "why": "three people a frame"})
    for m in man["end_to_end"]:
        if "workloads" in m and "panoptic.batch_s4" in m["workloads"]:
            m["workloads"].append("panoptic.batch_s4_three")
    man["per_layer"].append({"name": "persons_per_frame.batch",
                             "unit": "persons", "better": "higher",
                             "source": "program_counter",
                             "layer": "decode + gather + pack",
                             "moves": "frames_per_s",
                             "workloads": ["panoptic.batch_s4_three"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert open(p, "rb").read() == data
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    p = _run(["--workload", "panoptic.batch_s4_three", "--seed", "8",
              "--seconds", "1", "--trace", "1", "--cpu"], cwd=root, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["persons_per_frame.batch"]["value"] > 0


STORED_LOOP = '''
"""Batches through a stored lifter: the reference's weights read by
``checkpoints.py``, the program built on the same stem."""
from portbench import checkpoints, program, weights
from portbench.loops import batch
from portbench.loops.batch import control, judge, layer_context, measure, tiny


def models(cfg, seed, dev):
    return (weights.matcher_layers(cfg["matcher"], seed, dev),
            checkpoints.lifter(cfg["lifter"]["checkpoint"], dev)[0])


def build(st):
    return program.served_pipeline(st.cfg, st.traffic, st.rig, st.device,
                                   st.mlayers)


FORM = batch.Form(models, build, batch.lift_mean_prior)


def setup(cell, seed, device, build_program=True):
    return batch.setup(cell, seed, device, build_program, FORM)
'''


def test_a_stored_lifter_cell_added_as_files_only(tmp_path):
    """A cell whose lifter is a stored checkpoint: a configuration that
    names its stem, a mix of a new kind and its loop (the reference's
    weights from ``checkpoints.py``, the program from
    ``program.served_pipeline``), limits and manifest entries; no
    existing file edited.  The stem is a two-layer 64-wide mean-prior
    lifter stored bf16 by the program's saver, so that
    ``batch.lift_mean_prior`` is its reference."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from portbench import weights
    root = tmp_path
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "portbench").rglob("*") if q.is_file())}
    lcfg = {"in_dim": 1260, "out_dim": 54, "widths": [64],
            "negative_slope": 0.1, "residual_prior": False}
    stored = [{"w": p["w"].view(torch.int16).numpy().view(np.uint16),
               "b": p["b"].numpy()}
              for p in weights.lifter_layers(lcfg, 5, "cpu", torch.bfloat16)]
    save_checkpoint(str(root / "stored" / "pose_estimator"),
                    {"layers": stored},
                    meta={"lifter_config": lcfg, "prior": "mean",
                          "stored": "bf16"})
    cfg = json.load(open(os.path.join(HERE, "configs", "panoptic.json")))
    cfg["lifter"] = dict(lcfg, checkpoint="stored/pose_estimator",
                         prior="mean", stored="bf16")
    (root / "portbench/configs/panoptic_stored.json").write_text(
        json.dumps(cfg))
    mix = json.load(open(os.path.join(HERE, "traffic", "batch_s4.json")))
    mix.update(kind="batch_stored", why="batch_s4 through a stored lifter")
    (root / "portbench/traffic/batch_stored.json").write_text(json.dumps(mix))
    (root / "portbench/loops/batch_stored.py").write_text(STORED_LOOP)
    (root / "portbench/limits/panoptic_stored.batch_stored.json").write_text(
        open(os.path.join(HERE, "limits", "panoptic.batch_s4.json")).read())
    name = "panoptic_stored.batch_stored"
    man["configs"].append({"name": "panoptic_stored",
                           "source": man["configs"][0]["source"],
                           "file": "portbench/configs/panoptic_stored.json",
                           "reduced": [], "why": "a stored lifter"})
    man["workloads"].append({"name": name, "config": "panoptic_stored",
                             "traffic": "batch_stored", "chips": 1,
                             "why": "batch_s4 through a stored lifter"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m and "panoptic.batch_s4" in m["workloads"]:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert open(p, "rb").read() == data
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    p = _run(["--workload", name, "--seed", "4294967309", "--seconds", "1",
              "--trace", "1", "--cpu"], cwd=root, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "submit_ms.batch" in out["metrics"]
