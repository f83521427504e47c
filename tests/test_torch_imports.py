"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX package,
nor orbax or tensorstore (the card's machine has no tensorstore: the port
reads and writes orbax checkpoints itself)."""

import os
import re
import subprocess
import sys

import pytest

from torch_testing import subprocess_env

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = os.path.join(ROOT, "mpe3d_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def test_imports_without_jax_or_reference_package():
    """Every module imports with jax, mpe3d_tpu, orbax, tensorstore, cv2
    and matplotlib blocked (the conversor reads images with OpenCV and the
    GIF viewer draws with matplotlib only when called); importing
    chip_smoke as a module does not run its main."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
for blocked in ("jax", "mpe3d_tpu", "orbax", "tensorstore", "cv2",
                "matplotlib"):
    sys.modules[blocked] = None
sys.path.insert(0, sys.argv[1])
import mpe3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpe3d_tpu_torch.__path__,
                                               "mpe3d_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("mpe3d_tpu_torch.ops.gat_tiled", "mpe3d_tpu_torch.ops.gat_kernel",
          "mpe3d_tpu_torch.ops.frame_kernel", "mpe3d_tpu_torch.pipeline",
          "mpe3d_tpu_torch.ops.quant_matmul",
          "mpe3d_tpu_torch.ops.fused_proj",
          "mpe3d_tpu_torch.eval.clustering",
          "mpe3d_tpu_torch.eval.pose_metrics",
          "mpe3d_tpu_torch.eval.reprojection",
          "mpe3d_tpu_torch.eval.timing", "mpe3d_tpu_torch.eval.runners",
          "mpe3d_tpu_torch.lifting.loss",
          "mpe3d_tpu_torch.train.matcher_data",
          "mpe3d_tpu_torch.train.lifter_data",
          "mpe3d_tpu_torch.train.lifter",
          "mpe3d_tpu_torch.train.matcher",
          "mpe3d_tpu_torch.train.matcher_synth",
          "mpe3d_tpu_torch.convert.gat2_replica",
          "mpe3d_tpu_torch.convert.torch_import",
          "mpe3d_tpu_torch.convert.torch_export",
          "mpe3d_tpu_torch.utils.logging",
          "mpe3d_tpu_torch.convert.peaks",
          "mpe3d_tpu_torch.convert.pose_resnet",
          "mpe3d_tpu_torch.convert.panoptic",
          "mpe3d_tpu_torch.viz.viewer", "mpe3d_tpu_torch.viz.html_viewer",
          "mpe3d_tpu_torch.viz.live_viewer",
          "mpe3d_tpu_torch.checkpoint_orbax",
          "mpe3d_tpu_torch.parallel.mesh"):
    assert n in names, n
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              sys.argv[1] + "/chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
bad = [m for m in sys.modules if m.split(".")[0] in (
    "jax", "mpe3d_tpu", "orbax", "tensorstore", "cv2", "matplotlib")]
assert all(sys.modules[m] is None for m in bad), bad
print("imported", len(names))
"""
    r = subprocess.run([sys.executable, "-c", code, ROOT],
                       capture_output=True, text=True,
                       env=subprocess_env(), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("imported"), r.stdout
    assert int(r.stdout.split()[1]) >= 30
    assert '"ok"' not in r.stdout


IMPORT_RE = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+mpe3d_tpu\b(?!_torch)"
    r"|from\s+mpe3d_tpu\b(?!_torch)|(?:import|from)\s+(?:orbax|tensorstore)\b)",
    re.M)


@pytest.mark.parametrize("path", _sources())
def test_source_has_no_jax_or_reference_import(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert not IMPORT_RE.findall(text), path
