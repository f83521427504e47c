"""The port's Panoptic conversor against the JAX package on the CPU.

* ``convert/pose_resnet.py::PoseResNet`` (weights carried across by
  ``weights.pose_resnet_from_jax``) against JAX ``apply_pose_resnet`` at
  64x96 with He-normal weights and random batch-norm statistics, the JAX
  convolution's padding made symmetric in this file only (the JAX package
  pads stride-2 convolutions with XLA's "SAME", one pixel off the
  checkpoint's model); and against the simple-baselines model
  (``tests/test_convert.py``'s) loaded from a ``.pth.tar``, where a
  one-pixel shift of ``conv1``'s window would show.  Both within 1e-5 of
  the largest output.
* ``convert/peaks.py`` against JAX ``find_peaks`` / ``refine_peaks`` on
  seeded heatmaps with plateaus and values at the threshold: counts and
  integer peaks equal, coordinates within 1e-6.
* ``resize_linear`` against ``cv2.resize`` bit for bit.
* ``Detector2D`` against the JAX one on an image already at 960x512 (both
  resizes are copies), the head scaled so that a few dozen cells a channel
  pass the threshold: the same joints and counts, pixels within 1e-3.
* ``convert_sequence`` with a stub detector on the fake sequence of
  ``tests/test_convert.py``: the JSON equals JAX's with the timestamps
  masked, the ``tm_`` files are JAX's bytes, and each package reads the
  other's pickle (the port with JAX and the JAX package blocked).

Two JAX backbone forwards in all (64x96 and 960x512).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.convert import panoptic as jpano
from mpe3d_tpu.convert import pose_resnet as jpr
from mpe3d_tpu.convert.peaks import find_peaks as j_find_peaks
from mpe3d_tpu.convert.peaks import refine_peaks as j_refine_peaks
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.convert import panoptic as pano
from mpe3d_tpu_torch.convert.peaks import find_peaks, refine_peaks
from mpe3d_tpu_torch.convert.pose_resnet import (PoseResNet,
                                                 load_pose_resnet_checkpoint,
                                                 pose_resnet,
                                                 pose_resnet_flops)

from test_convert import _torch_pose_resnet, fake_sequence  # noqa: F401
from torch_testing import subprocess_env

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NET_RTOL = 1e-5            # of the largest output
PEAK_XY_TOL = 1e-6         # normalised coordinates
DETECT_PX_TOL = 1e-3       # camera pixels
HOT = 40                   # cells a channel above the threshold


def _symmetric_conv2d(x, w, stride=1, padding="SAME"):
    """JAX ``conv2d`` with the checkpoint's symmetric padding (k - 1) / 2."""
    kh, kw = w.shape[:2]
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), [((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _jax_tree(seed):
    """He-normal weights in the JAX layout (``init_pose_resnet``'s shapes
    and scales, numpy draws) with random batch-norm statistics."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        return (rng.standard_normal((kh, kw, cin, cout))
                * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)

    def bn(c):
        return {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": rng.normal(0, 0.05, c).astype(np.float32),
                "mean": rng.normal(0, 0.05, c).astype(np.float32),
                "var": rng.uniform(0.7, 1.3, c).astype(np.float32)}

    p = {"conv1": conv(7, 7, 3, 64), "bn1": bn(64)}
    cin = 64
    for li, (n, width) in enumerate(zip(jpr.RESNET50_BLOCKS,
                                        jpr.STAGE_WIDTHS)):
        blocks = []
        for bi in range(n):
            out = width * jpr.EXPANSION
            b = {"conv1": conv(1, 1, cin, width), "bn1": bn(width),
                 "conv2": conv(3, 3, width, width), "bn2": bn(width),
                 "conv3": conv(1, 1, width, out), "bn3": bn(out)}
            if bi == 0:
                b["down_conv"], b["down_bn"] = conv(1, 1, cin, out), bn(out)
            blocks.append(b)
            cin = out
        p[f"layer{li + 1}"] = blocks
    p["deconv"] = []
    for _ in range(jpr.N_DECONV):
        p["deconv"].append({"w": conv(4, 4, jpr.DECONV_FILTERS, cin),
                            "bn": bn(jpr.DECONV_FILTERS)})
        cin = jpr.DECONV_FILTERS
    p["final_w"] = conv(1, 1, cin, 18)
    p["final_b"] = np.zeros(18, np.float32)
    return p


def _scale_head(tree, cmap):
    """The tree with its head scaled per channel so that the ``HOT``
    largest cells of ``cmap`` (its heatmaps [J, h, w]) pass the threshold
    0.15: the midpoint between a channel's HOT-th and next value maps to
    0.15 (no cell lies near the threshold), its least value to 0 (the
    refinement's window sums stay positive, as on trained heatmaps)."""
    top = -np.sort(-cmap.reshape(len(cmap), -1), axis=1)
    cut = (top[:, HOT - 1].astype(np.float64) + top[:, HOT]) / 2
    low = top[:, -1].astype(np.float64)
    s = 0.15 / (cut - low)
    out = dict(tree)
    out["final_w"] = (tree["final_w"] * s).astype(np.float32)
    out["final_b"] = ((tree["final_b"] - low) * s).astype(np.float32)
    return out


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tree():
    return _jax_tree(0)


def test_pose_resnet_matches_jax_with_symmetric_padding(tree):
    x = np.random.default_rng(1).normal(size=(1, 64, 96, 3)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpr, "conv2d", _symmetric_conv2d)
        ref = np.asarray(jpr.apply_pose_resnet(_jnp(tree), jnp.asarray(x)))
    net = pose_resnet(weights.pose_resnet_from_jax(tree), "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    ref = ref.transpose(0, 3, 1, 2)
    assert got.shape == ref.shape == (1, 18, 16, 24)
    scale = float(np.abs(ref).max())
    assert scale > 10.0          # He scale: the input reaches the heatmaps
    assert float(np.abs(got - ref).max()) <= NET_RTOL * scale


def test_pose_resnet_loads_simple_baselines_checkpoint(tmp_path):
    """The reference's model, He-normal (torch's own init) with random
    batch-norm statistics, saved as DataParallel's ``module.`` state in a
    ``.pth.tar``: the port loads it strictly and gives its heatmaps within
    1e-5; the same net with ``conv1``'s window shifted by one pixel (XLA
    "SAME": pad (2, 3)) does not."""
    torch.manual_seed(0)
    ref_net = _torch_pose_resnet().eval()
    with torch.no_grad():
        for m in ref_net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.7, 1.3)
    path = tmp_path / "pose_resnet50_panoptic.pth.tar"
    torch.save({"epoch": 1, "state_dict": {
        f"module.{k}": v for k, v in ref_net.state_dict().items()}}, path)
    net = pose_resnet(load_pose_resnet_checkpoint(str(path)), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        ref = ref_net(x)
        got = net(x)
        shifted = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (2, 3, 2, 3)), net.conv1.weight,
            stride=2)
        net.conv1.forward = lambda _: shifted
        off = net(x)
    scale = float(ref.abs().max())
    assert scale > 10.0
    assert float((got - ref).abs().max()) <= NET_RTOL * scale
    assert float((off - ref).abs().max()) > 100 * NET_RTOL * scale


def test_pose_resnet_operation_count():
    """The static count equals the multiply-adds of the convolutions a
    forward pass runs (counted from its tensors' shapes); 108.5 GFLOP at
    960x512."""
    net = PoseResNet()
    seen = []

    def count(m, inputs, out):
        hw = (inputs[0] if isinstance(m, torch.nn.ConvTranspose2d)
              else out).shape[2:]
        seen.append(2 * m.in_channels * m.out_channels * m.kernel_size[0]
                    * m.kernel_size[1] * hw[0] * hw[1])

    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(count)
    with torch.no_grad():
        net(torch.zeros(1, 3, 64, 96))
    assert len(seen) == 57
    assert sum(seen) == pose_resnet_flops(net, (64, 96))
    assert abs(pose_resnet_flops(net, (512, 960)) - 108.54e9) < 0.01e9


def _heatmaps(seed):
    """[4, 32, 48] seeded heatmaps: smooth noise, a 2x2 plateau and a 1x2
    plateau at equal maxima, cells exactly at the threshold, a channel with
    more local maxima than the cap, a channel below the threshold."""
    rng = np.random.default_rng(seed)
    cm = rng.uniform(0.0, 0.6, (4, 32, 48)).astype(np.float32)
    cm[0, 10:12, 20:22] = 0.9                    # plateau: four peaks
    cm[0, 3, 5:7] = 0.75                          # two equal neighbours
    cm[1] = np.where(cm[1] > 0.3, np.float32(0.15), cm[1] * 0.1)
    cm[1, 16, 24] = 0.8
    cm[2] = (cm[2] * 0.2).astype(np.float32)      # nothing above 0.15
    return cm


@pytest.mark.parametrize("window, max_peaks", [(5, 100), (5, 6), (3, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_peaks_match_jax(seed, window, max_peaks):
    cm = _heatmaps(seed)
    jc, jp = j_find_peaks(jnp.asarray(cm), 0.15, window, max_peaks)
    jn = np.asarray(j_refine_peaks(jp, jnp.asarray(cm), window))
    c, p = find_peaks(torch.from_numpy(cm), 0.15, window, max_peaks)
    n = refine_peaks(p, torch.from_numpy(cm), window).numpy()
    assert c.dtype == p.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert float(np.abs(n - jn).max()) <= PEAK_XY_TOL
    counts = c.numpy()
    assert counts[2] == 0 and counts[0] >= min(6, max_peaks)
    # at the threshold is not above it: channel 1 holds one peak
    assert counts[1] == 1
    if max_peaks >= 6:
        # the plateaus' cells are all peaks, in row-major order
        assert p.numpy()[0, :6].tolist() == [[10, 20], [10, 21], [11, 20],
                                             [11, 21], [3, 5], [3, 6]]


@pytest.mark.parametrize("shape, size", [
    ((1080, 1920), (960, 512)), ((2160, 3840), (960, 512)),
    ((720, 1280), (960, 512)), ((480, 640), (960, 512)),
    ((512, 960), (960, 512)), ((1080, 1920), (333, 500))])
def test_resize_is_cv2_bit_for_bit(shape, size):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(shape))
    for _ in range(2):
        img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        got = pano.resize_linear(torch.from_numpy(img), size).numpy()
        np.testing.assert_array_equal(got, cv2.resize(img, size))


def test_detector_matches_jax(tree):
    """Both detectors on an image at the model's input size, JAX with
    symmetric padding: the same joints, counts and order, pixels within
    1e-3 (a 1920x1080 camera)."""
    image = np.random.default_rng(4).integers(0, 256, (512, 960, 3),
                                              dtype=np.uint8)
    raw = pano.Detector2D(weights.pose_resnet_from_jax(tree), device="cpu")
    head = _scale_head(tree, raw.heatmaps(image).numpy())
    det = pano.Detector2D(weights.pose_resnet_from_jax(head), device="cpu")
    got = det(image, (1920, 1080))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpr, "conv2d", _symmetric_conv2d)
        ref = jpano.Detector2D(_jnp(head))(image, (1920, 1080))
    assert sorted(got) == sorted(ref) and len(got) == 17
    n = [len(got[j]) for j in sorted(got)]
    assert n == [len(ref[j]) for j in sorted(ref)]
    assert 2 <= min(n) and max(n) <= HOT
    err = max(float(np.abs(np.asarray(got[j]) - np.asarray(ref[j])).max())
              for j in got)
    assert err <= DETECT_PX_TOL


class _StubDetector:
    """Noisy GT projections, cameras in the order ``convert_sequence``
    visits them; the same draws for a fresh instance."""

    def __init__(self, cams, bodies, nodes):
        self.cams, self.bodies, self.nodes = cams, bodies, nodes
        self.calls = 0
        self.rng = np.random.default_rng(1)

    def __call__(self, image, resolution):
        cam = self.cams[(0, self.nodes[self.calls % len(self.nodes)])]
        self.calls += 1
        projected, _ = jpano.project_gt_people(self.bodies, cam)
        out = {}
        for kps in projected.values():
            for j, v in kps.items():
                out.setdefault(j, []).append(
                    [v[1] + self.rng.normal(0, 1), v[2] + self.rng.normal(0, 1)])
        return out


def _masked(frames):
    """Wire frames with each camera entry's timestamp (element 1) blanked."""
    return [{cam: [e[0], None, *e[2:]] for cam, e in f.items()}
            for f in frames]


@pytest.mark.parametrize("multi", [True, False])
def test_convert_sequence_matches_jax(fake_sequence, tmp_path,  # noqa: F811
                                      multi):
    cams = jpano.load_calibration(fake_sequence)
    with open(os.path.join(fake_sequence, "hdPose3d_stage1_coco19",
                           "body3DScene_00000100.json")) as f:
        bodies = json.load(f)["bodies"]
    out = {}
    for name, mod in (("port", pano), ("jax", jpano)):
        d = tmp_path / name
        d.mkdir()
        path = mod.convert_sequence(fake_sequence,
                                    _StubDetector(cams, bodies, (3, 6)),
                                    nodes=(3, 6), multi=multi,
                                    out_dir=str(d))
        with open(path) as f:
            out[name] = json.load(f)
        assert os.path.basename(path) == (
            f"160906_fake1_from_image_{'multi' if multi else 'single'}.json")
    assert _masked(out["port"]) == _masked(out["jax"])
    assert len(out["port"]) == 2
    for ext in ("json", "pickle"):
        assert (tmp_path / "port" / f"tm_160906_fake1.{ext}").read_bytes() \
            == (tmp_path / "jax" / f"tm_160906_fake1.{ext}").read_bytes()


def test_transform_pickles_load_in_both_packages(tmp_path):
    """A JAX-written ``tm_`` pickle loads in the port with JAX and the JAX
    package blocked, and the port's loads in the JAX package."""
    from mpe3d_tpu.geometry.calib_io import load_transform_manager as j_load

    cams = {"trackera": {"R": np.eye(3), "t": np.array([[10.0], [20.0],
                                                         [30.0]])},
            "trackerb": {"R": np.diag([1.0, -1.0, -1.0]),
                         "t": np.array([[-5.0], [0.0], [250.0]])}}
    jpano.write_transform_set(cams, str(tmp_path / "tm_j"))
    pano.write_transform_set(cams, str(tmp_path / "tm_p"))
    want = j_load(str(tmp_path / "tm_j.pickle"))
    got = j_load(str(tmp_path / "tm_p.pickle"))
    for cam in cams:
        np.testing.assert_array_equal(got.get_transform("root", cam),
                                      want.get_transform("root", cam))
    code = r"""
import sys
sys.modules["jax"] = None
sys.modules["mpe3d_tpu"] = None
sys.path.insert(0, sys.argv[1])
from mpe3d_tpu_torch.geometry.calib_io import load_transform_manager
ts = load_transform_manager(sys.argv[2])
print(type(ts).__module__, ts.get_transform("root", "trackerb")[:3, 3].tolist())
"""
    r = subprocess.run([sys.executable, "-c", code, ROOT,
                        str(tmp_path / "tm_j.pickle")], capture_output=True,
                       text=True, env=subprocess_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split(" ", 1) == [
        "mpe3d_tpu_torch.geometry.calib_io", "[-0.05, 0.0, 2.5]\n"]


def test_image_reader_names_opencv_when_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        pano.read_image_rgb(str(tmp_path / "x.jpg"))
