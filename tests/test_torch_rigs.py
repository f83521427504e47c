"""The rig presets and the synthetic rigs and frames of the port against
the JAX package: ``PANOPTIC``, ``ARPLAB`` and a BODY_25 rig field for field
(``dataclasses.asdict``) with their derived dims; ``get_rig`` and both
command lines' ``--rig`` lookup on the same spellings (any case serves, an
unknown name raises the same KeyError); ring rigs and frames from the same
seed; the C++ wire parser at J=25 against the python parser."""

import argparse
import dataclasses
import json

import numpy as np
import pytest

from mpe3d_tpu import cli as jcli
from mpe3d_tpu import config as jconfig
from mpe3d_tpu import native as jnative
from mpe3d_tpu.data import synthetic as jsynth
from mpe3d_tpu_torch import cli, config, native
from mpe3d_tpu_torch.data import synthetic
from mpe3d_tpu_torch.data.frames import parse_frame, parse_frames_batch

import torch_testing  # noqa: F401

SPELLINGS = ["PANOPTIC", "panoptic", "Panoptic", "ARPLAB", "arplab",
             "ArpLab", "ARP", "coco", ""]


def _b25(module):
    return dataclasses.replace(module.PANOPTIC, joint_format="BODY_25")


RIGS = {"PANOPTIC": lambda m: m.PANOPTIC, "ARPLAB": lambda m: m.ARPLAB,
        "BODY_25": _b25}


@pytest.mark.parametrize("name", sorted(RIGS))
def test_presets_equal_jax(name):
    got, ref = RIGS[name](config), RIGS[name](jconfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for attr in ("n_joints", "n_cameras", "n_used_cameras",
                 "n_matching_cameras", "lifter_input_dim",
                 "matcher_feature_dim", "joint_names"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for alt in ("1", "2", "3"):
        assert (got.matcher_feature_dim_alt(alt)
                == ref.matcher_feature_dim_alt(alt))
    assert got.used_camera_indices() == ref.used_camera_indices()
    assert got.matching_camera_indices() == ref.matching_camera_indices()


def test_joint_vocabularies():
    assert config.JOINT_NAMES_BY_FORMAT == jconfig.JOINT_NAMES_BY_FORMAT
    assert config.BODY25_JOINT_NAMES == jconfig.BODY25_JOINT_NAMES
    assert (config.ARPLAB.matcher_feature_dim,
            config.ARPLAB.lifter_input_dim) == (1082, 1512)


def _lookup(fn, name):
    try:
        return dataclasses.asdict(fn(name))
    except KeyError as e:
        return ("KeyError", str(e))


@pytest.mark.parametrize("name", SPELLINGS)
def test_get_rig_spellings(name):
    assert _lookup(config.get_rig, name) == _lookup(jconfig.get_rig, name)


@pytest.mark.parametrize("name", SPELLINGS)
def test_cli_rig_lookup_spellings(name, tmp_path, monkeypatch):
    """Both command lines' ``load_rig`` (no calibration file: the ring
    rig) on the same ``--rig`` spelling."""
    monkeypatch.chdir(tmp_path)
    args = argparse.Namespace(rig=name, tm=None)

    def run(load):
        try:
            rc, rig = load(args)
        except KeyError as e:
            return ("KeyError", str(e)), None
        return dataclasses.asdict(rc), np.asarray(rig.T_wc)

    (got, got_T), (ref, ref_T) = run(cli.load_rig), run(jcli.load_rig)
    assert got == ref
    if ref_T is not None:
        np.testing.assert_array_equal(got_T, ref_T)


@pytest.mark.parametrize("name", ["ARPLAB", "BODY_25"])
def test_ring_rigs_and_frames_equal_jax(name):
    rc, jrc = RIGS[name](config), RIGS[name](jconfig)
    rig, jrig = synthetic.synthetic_ring_rig(rc), jsynth.synthetic_ring_rig(jrc)
    for f in ("T_wc", "K", "dist"):
        np.testing.assert_array_equal(np.asarray(getattr(rig, f)),
                                      np.asarray(getattr(jrig, f)))
    assert synthetic.up_axis(rc) == jsynth.up_axis(jrc)
    got = synthetic.generate_frames(rc, rig, 3, n_people=(2, 3), seed=4)
    ref = jsynth.generate_frames(jrc, jrig, 3, n_people=(2, 3), seed=4)
    assert got == ref


@pytest.mark.parametrize("name", ["ARPLAB", "BODY_25"])
def test_generator_spread_and_camera_guard_against_jax(name):
    """The knobs of the reference's
    ``tests/test_e2e.py::test_generator_spread_and_camera_guard`` (a spread
    range per frame, the camera-distance guard, a fixed spread): the port's
    frames equal the JAX generator's on the same seeds."""
    rc, jrc = RIGS[name](config), RIGS[name](jconfig)
    rig, jrig = synthetic.synthetic_ring_rig(rc), jsynth.synthetic_ring_rig(jrc)
    for kw in (dict(spread=(0.8, 2.0)),
               dict(spread=(0.8, 2.0), min_cam_dist=1.2),
               dict(spread=1.0)):
        got = synthetic.generate_frames(rc, rig, 6, n_people=(2, 3), seed=5,
                                        **kw)
        ref = jsynth.generate_frames(jrc, jrig, 6, n_people=(2, 3), seed=5,
                                     **kw)
        assert got == ref, kw


def test_native_parser_body25():
    """The C++ parser at J=25 against the python parser and the JAX
    package's parser on BODY_25 frames (keys up to "24"; a key "25" is
    past the format and skipped)."""
    rc = RIGS["BODY_25"](config)
    frames = synthetic.generate_frames(rc, synthetic.synthetic_ring_rig(rc),
                                       4, n_people=(2, 4), seed=7)
    frames[0]["trackera"][0] = json.dumps(
        json.loads(frames[0]["trackera"][0])
        + [{"24": [24, 5.0, 6.0, 1, 0.9], "25": [25, 1.0, 1.0, 1, 1.0]}])
    text = json.dumps(frames).encode()
    assert native.load_library() is not None
    got = parse_frames_batch(text, rc, 10)
    raw = native.parse_frames_native(text, rc.camera_names, 10, 25)
    ref = jnative.parse_frames_native(text, rc.camera_names, 10, 25)
    if ref is not None:
        for a, b in zip(raw, ref):
            np.testing.assert_array_equal(a, b)
    assert len(got) == len(frames)
    for fa, f in zip(got, frames):
        py = parse_frame(f, rc, 10)
        assert fa.kp.shape == (5, 10, 25, 2)
        for a, b in zip(fa, py):
            np.testing.assert_array_equal(a, b)
    assert got[0].in_view[0, :, 24].any()
