"""The counts of a stored lifter and of the median and IRLS priors, and
the defaults pinned: every cell of the mean prior and bf16 weights reads
the counts it read before they existed."""

import numpy as np
import pytest

from portbench import checkpoints, counts
from portbench.cell import load

# batch_costs on the present, live and persons below, before the stored
# dtypes and the other priors were counted
PINNED = {
    "panoptic.batch_s4": {"gat": (365131010.0, 7979124.0),
                          "decode": (485268.87242378376, 44808.0),
                          "lifter": (290918400.0, 58267520.0)},
    "arplab.batch_s4": {"gat": (566797866.0, 9758884.0),
                        "decode": (687531.898485923, 55298.0),
                        "lifter": (298659840.0, 59820848.0)},
}


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_defaults_count_as_before(workload):
    cfg = load(workload).config
    rng = np.random.default_rng(0)
    present = rng.random((3, len(cfg["cameras"]["names"]), 4)) < 0.6
    got = counts.batch_costs(cfg, present, np.array([3., 4, 5]),
                             np.array([1., 2, 2]))
    assert {k: tuple(map(float, v)) for k, v in got.items()} == \
        PINNED[workload]


def test_int8_lifter_count_from_its_weights():
    """pan_irls's int8 lifter: its stored weights' own bytes (int8 wq, fp32
    row and column scales and biases; the head served in bf16)."""
    layers, meta = checkpoints.lifter("models_demo/pan_irls/pose_estimator")
    byt = 4.0 * 64 * (1260 + 54)
    for layer in layers:
        for k, t in layer.items():
            byt += t.numel() * (2 if k == "w" else 1 if k == "wq" else 4)
    ops, got = counts.lifter_costs(meta, 64, "int8")
    assert got == byt == 29_656_712.0
    assert ops == counts.lifter_costs(meta, 64)[0]


def test_lifter_costs_refuse_an_unknown_dtype():
    with pytest.raises(ValueError):
        counts.lifter_costs(load("panoptic.batch_s4").config["lifter"], 8,
                            "fp8")


@pytest.mark.parametrize("C,J", [(5, 18), (6, 18), (4, 25)])
def test_prior_counts_by_hand(C, J):
    cp = C * (C - 1) // 2
    assert counts.prior_ops("mean", C, J) == J * cp * 388
    assert counts.prior_ops("median", C, J) == J * cp * (388 + 1)
    solve = 54 * C + 65
    assert counts.prior_ops("irls", C, J) == (J - 1) * (
        16 * C + 6 * solve + 5 * 32 * C)
    with pytest.raises(ValueError):
        counts.prior_ops("dlt", C, J)


@pytest.mark.parametrize("prior", ["mean", "median", "irls"])
def test_decode_costs_by_prior(prior):
    args = (5, 18, np.array([10.0]), np.array([35.0]), np.array([20.0]),
            np.array([3.0]))
    ops, byt = counts.decode_costs(*args, prior=prior)
    base_ops, base_byt = counts.decode_costs(*args)
    assert byt == base_byt
    assert ops - base_ops == pytest.approx(
        3 * (counts.prior_ops(prior, 5, 18) - 18 * 10 * 388), abs=1e-6)


def test_batch_costs_follow_the_configuration():
    cfg = load("panoptic.batch_s4").config
    cfg = dict(cfg, lifter=dict(cfg["lifter"], prior="irls", stored="int8"))
    present = np.ones((2, 5, 4), bool)
    live, persons = np.array([8., 9]), np.array([3., 4])
    c = counts.batch_costs(cfg, present, live, persons)
    assert c["lifter"] == counts.lifter_costs(cfg["lifter"], 7, "int8")
    sizes = np.array([counts.frame_sizes(p) for p in present])
    assert c["decode"] == counts.decode_costs(5, 18, sizes[:, 0],
                                              sizes[:, 1], live, persons,
                                              "irls")
