"""The traffic and the datasets are made from the seed: the same seed gives
the same frames, pools and lifter dataset, another seed others; the
frozen generator gives what the port's own generator and parser give."""

import numpy as np
import pytest
import torch

from portbench import frames as F
from portbench import lifter_data
from portbench.cell import load
from portbench.loops import batch
from portbench.run import tiny


def _cfg(name):
    return load(f"{name}.batch_s4").config


@pytest.mark.parametrize("name,slots,people", [("panoptic", 4, (2, 4)),
                                               ("panoptic", 16, (10, 14)),
                                               ("arplab", 4, (2, 4))])
def test_generator_matches_the_port(name, slots, people):
    from mpe3d_tpu_torch.config import get_rig
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    cfg = _cfg(name)
    rc = get_rig(cfg["rig"])
    rig = F.ring_rig(cfg)
    port_rig = synthetic_ring_rig(rc)
    for a, b in zip(rig, port_rig):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = F.generate(cfg, rig, 5, people, slots, 1234567, 2.5)
    want = [parse_frame(f, rc, slots) for f in generate_frames(
        rc, port_rig, 5, people, seed=1234567, spread=2.5)]
    for i, w in enumerate(want):
        for field in ("kp", "valid", "prob", "in_view", "present"):
            np.testing.assert_array_equal(getattr(got, field)[i],
                                          getattr(w, field), err_msg=field)


@pytest.mark.parametrize("workload", ["panoptic.batch_s4",
                                      "panoptic.batch_s16",
                                      "arplab.batch_s4"])
def test_batch_pool_is_the_seeds(workload):
    cell = tiny(load(workload))
    a = batch.setup(cell, 2 ** 31 + 5, "cpu", build_program=False)
    b = batch.setup(cell, 2 ** 31 + 5, "cpu", build_program=False)
    c = batch.setup(cell, 2 ** 31 + 6, "cpu", build_program=False)
    for x, y in zip(a.pool, b.pool):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.mlayers + a.llayers, b.mlayers + b.llayers):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not np.array_equal(a.pool.kp, c.pool.kp)
    assert a.pool.present.sum(axis=2).max() <= cell.traffic["slots"]
    assert len(a.pool) == cell.traffic["pool_batches"] * a.B


def test_batch_sizes_fill_four_union_chunks():
    sizes = {w: batch.batch_size(load(w).config, load(w).traffic)
             for w in ("panoptic.batch_s4", "panoptic.batch_s16",
                       "arplab.batch_s4")}
    assert sizes == {"panoptic.batch_s4": 100, "panoptic.batch_s16": 24,
                     "arplab.batch_s4": 84}


def test_lifter_dataset_is_the_seeds():
    cell = load("panoptic.train_lifter")
    cfg, tr = cell.config, dict(cell.traffic, train_batches=2, dev_batches=1)
    rig = F.ring_rig(cfg)
    a = lifter_data.dataset(cfg, rig, tr, 64, 77, "cpu")
    b = lifter_data.dataset(cfg, rig, tr, 64, 77, "cpu")
    c = lifter_data.dataset(cfg, rig, tr, 64, 78, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["net_train"].shape == (128, cfg["lifter"]["in_dim"])
    assert a["err_train"].shape == (128, 5 * 18 * 4)
    assert a["net_dev"].shape == (64, cfg["lifter"]["in_dim"])
    assert not np.array_equal(a["net_train"], c["net_train"])
    # the first copy of a sample keeps every camera, later ones drop some
    blocks = a["net_train"].reshape(128, 5, 18, 14)
    assert (np.abs(blocks[..., :10]).sum(axis=(2, 3)) == 0).any()


def test_lifter_dataset_matches_the_ports_packing():
    from mpe3d_tpu_torch.config import get_rig
    from mpe3d_tpu_torch.data.frames import FrameArrays
    from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
    from mpe3d_tpu_torch.train.lifter_data import build_lifter_dataset
    cfg = load("panoptic.train_lifter").config
    rc = get_rig(cfg["rig"])
    rig = F.ring_rig(cfg)
    fr = F.generate(cfg, rig, 12, (1, 1), 1, 5, 2.5)
    net, err = lifter_data.pack(cfg, rig, fr, 5, np.random.default_rng(9),
                                "cpu")
    ts = np.zeros(5)
    fas = [FrameArrays(fr.kp[i], fr.valid[i], fr.prob[i], fr.in_view[i],
                       fr.present[i], ts) for i in range(len(fr))]
    pnet, perr = build_lifter_dataset(fas, rc, synthetic_ring_rig(rc),
                                      seed=9, device="cpu")
    np.testing.assert_array_equal(err, perr)
    np.testing.assert_allclose(net, pnet, rtol=0, atol=1e-6)
