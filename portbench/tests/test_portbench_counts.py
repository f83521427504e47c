"""The frozen operation and byte counts against counts by hand."""

import numpy as np
import pytest

from portbench import counts
from portbench.cell import load

MCFG = load("panoptic.batch_s4").config["matcher"]
LCFG = load("panoptic.batch_s4").config["lifter"]


@pytest.mark.parametrize("slots,per_camera", [(4, [2, 3, 0, 4, 1]),
                                              (16, [12, 14, 10, 16, 13])])
def test_frame_sizes(slots, per_camera):
    present = np.zeros((5, slots), bool)
    for c, n in enumerate(per_camera):
        present[c, :n] = True
    H, E = counts.frame_sizes(present)
    assert H == sum(per_camera)
    assert E == sum(per_camera[a] * per_camera[b]
                    for a in range(5) for b in range(a + 1, 5))


@pytest.mark.parametrize("H,E", [(10, 35), (65, 1687)])
def test_gat_costs_by_hand(H, E):
    ops, byt = counts.gat_costs(MCFG, np.array([H]), np.array([E]))
    # layer widths (in, out x heads): 902->400, 400->400, 400->320,
    # 320->150, 150->1
    want = 0
    for li, (di, F) in enumerate([(902, 400), (400, 400), (400, 320),
                                  (320, 150), (150, 1)]):
        rows = H + 1 if li == 0 else H + E
        want += 2 * rows * (di * di + di * F) + 4 * rows * F + 6 * E * F
        if li < 4:
            want += 4 * E * F
    assert ops == want
    n_w = (902 * 902 + 902 + 902 * 400 + 400 + 2 * 400
           + 400 * 400 + 400 + 400 * 400 + 400 + 2 * 400
           + 400 * 400 + 400 + 400 * 320 + 320 + 2 * 320
           + 320 * 320 + 320 + 320 * 150 + 150 + 2 * 150
           + 150 * 150 + 150 + 150 * 1 + 1 + 2 * 1)
    assert byt == 4 * n_w + 4 * ((H + 1) * 902 + 5 * E) + 4 * E


def test_lifter_costs_by_hand():
    kn = (1260 * 3072 + 3072 * 3072 + 3072 * 2048 + 2048 * 2048
          + 2048 * 1024 + 3 * 1024 * 1024 + 1024 * 54)
    ops, byt = counts.lifter_costs(LCFG, 37)
    assert ops == 2 * 37 * kn
    nb = 3072 * 2 + 2048 * 2 + 1024 * 4 + 54
    assert byt == 2 * kn + 4 * nb + 4 * 37 * (1260 + 54)
    assert counts.train_step_ops(LCFG, 2096) == 6 * (kn + nb) * 2096


def test_decode_costs_by_hand():
    ops, byt = counts.decode_costs(5, 18, np.array([10.0]), np.array([35.0]),
                                   np.array([20.0]), np.array([3.0]))
    want = (35 * np.log2(35) + 20 * 4 * 5
            + 3 * (5 * 18 * 300 + 18 * 10 * 388))
    assert ops == pytest.approx(want, rel=1e-12)
    assert byt == 35 * 20 + 10 * 18 * 17 + 3 * (20 + 4 * 5 * 18 * 14
                                                 + 5 * 18 * 13) + 5 * 33 * 4


def test_batch_costs_sum_frames():
    rng = np.random.default_rng(0)
    present = rng.random((3, 5, 4)) < 0.6
    cfg = load("panoptic.batch_s4").config
    c = counts.batch_costs(cfg, present, np.array([3., 4, 5]),
                           np.array([1., 2, 2]))
    assert c["lifter"] == counts.lifter_costs(LCFG, 5)
    sizes = np.array([counts.frame_sizes(p) for p in present])
    assert c["gat"] == counts.gat_costs(MCFG, sizes[:, 0], sizes[:, 1])
