"""Calibration files in the port against the JAX package: ``rig_from_files``
on a TransformSet JSON and on a pytransform3d-style pickle (made with a
stand-in ``pytransform3d`` module), and ``save_rig_npz`` / ``load_rig_npz``
with each package reading the other's file."""

import pickle
import sys
import types

import numpy as np
import pytest

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.geometry import calib_io as jcalib
from mpe3d_tpu.geometry import camera as jcamera
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
from mpe3d_tpu_torch.geometry import calib_io, camera

import torch_testing  # noqa: F401

TOL = 1e-12


def _transforms(chain: bool):
    """world -> camera transforms of the ring rig, each camera directly
    from 'root', or (``chain``) the later cameras through the first one
    and an inverse edge, so queries compose and invert."""
    T = np.asarray(synthetic_ring_rig(PANOPTIC).T_wc, np.float64)
    names = PANOPTIC.camera_names
    out = {("root", names[0]): T[0]}
    for i, cam in enumerate(names[1:], 1):
        if not chain:
            out[("root", cam)] = T[i]
        elif i % 2:
            out[(names[0], cam)] = T[i] @ np.linalg.inv(T[0])
        else:
            out[(cam, "root")] = np.linalg.inv(T[i])
    return out


def _assert_rigs_close(got, ref):
    assert type(got).__name__ == type(ref).__name__ == "CameraRig"
    assert got._fields == ref._fields
    for f in got._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f)


@pytest.mark.parametrize("chain", [False, True])
def test_rig_from_json_matches_jax(tmp_path, chain):
    path = tmp_path / "tm.json"
    path.write_text(calib_io.TransformSet(_transforms(chain)).to_json())
    got = calib_io.rig_from_files(PANOPTIC, str(path))
    _assert_rigs_close(got, jcalib.rig_from_files(J_PANOPTIC, str(path)))
    np.testing.assert_allclose(got.T_wc, synthetic_ring_rig(PANOPTIC).T_wc,
                               atol=1e-5)
    # the JAX package's JSON reads back in the port the same way
    jpath = tmp_path / "tm_jax.json"
    jpath.write_text(jcalib.TransformSet(_transforms(chain)).to_json())
    _assert_rigs_close(calib_io.rig_from_files(PANOPTIC, str(jpath)), got)


@pytest.mark.parametrize("chain", [False, True])
def test_rig_from_pickle_matches_jax(tmp_path, monkeypatch, chain):
    """A pickle of a stand-in pytransform3d TransformManager loads in both
    packages without pytransform3d (the stub unpickler)."""
    pkg = types.ModuleType("pytransform3d")
    mod = types.ModuleType("pytransform3d.transform_manager")

    class TransformManager:
        def __init__(self, transforms):
            self.transforms = transforms
            self.strict_check = True

    TransformManager.__module__ = mod.__name__
    TransformManager.__qualname__ = "TransformManager"
    mod.TransformManager = TransformManager
    pkg.transform_manager = mod
    monkeypatch.setitem(sys.modules, "pytransform3d", pkg)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    path = tmp_path / "tm.pickle"
    with open(path, "wb") as f:
        pickle.dump(TransformManager(_transforms(chain)), f)
    monkeypatch.delitem(sys.modules, "pytransform3d")
    monkeypatch.delitem(sys.modules, mod.__name__)

    got = calib_io.rig_from_files(PANOPTIC, str(path))
    _assert_rigs_close(got, jcalib.rig_from_files(J_PANOPTIC, str(path)))
    ts = calib_io.load_transform_manager(str(path))
    jts = jcalib.load_transform_manager(str(path))
    for cam in PANOPTIC.camera_names:
        np.testing.assert_allclose(ts.get_transform(cam, "root"),
                                   jts.get_transform(cam, "root"),
                                   rtol=0, atol=TOL)
    with pytest.raises(KeyError):
        ts.get_transform("root", "nosuchcam")


def test_pickle_without_transforms_is_refused(tmp_path):
    path = tmp_path / "bad.pickle"
    with open(path, "wb") as f:
        pickle.dump({"not": "a transform manager"}, f)
    with pytest.raises(ValueError, match="TransformManager"):
        calib_io.load_transform_manager(str(path))


def test_rig_npz_read_by_each_package(tmp_path):
    rig = synthetic_ring_rig(PANOPTIC)
    mine, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    camera.save_rig_npz(str(mine), rig)
    jrig = jcamera.make_rig(rig.K, rig.dist, rig.T_wc, rig.image_size)
    jcamera.save_rig_npz(str(theirs), jrig)
    _assert_rigs_close(jcamera.load_rig_npz(str(mine)), jrig)
    _assert_rigs_close(camera.load_rig_npz(str(theirs)), rig)
    # a rig already moved to tensors saves the same file
    again = tmp_path / "tensors.npz"
    camera.save_rig_npz(str(again), rig.to("cpu"))
    _assert_rigs_close(camera.load_rig_npz(str(again)), rig)
