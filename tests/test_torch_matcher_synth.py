"""The port's matcher scenes synthesised on the device, against the JAX
package on the CPU.

``build_scene_bank`` must give the JAX package's arrays, segments and file
sets exactly.  ``synth_scenes`` draws from a ``torch.Generator`` (not
``jax.random``'s numbers), so it is held to the invariants and marginals
of ``tests/test_matcher_synth.py``: shapes, labels only on weighted pairs,
weights in {0, 1, 2}, observations only in present slots; the label
density, the multiplicity mix and the populated slots a scene within the
same bands of the host synthesiser ``build_matcher_scenes`` and of the JAX
``synth_scenes`` on the same bank; null scenes (weight 0, no label) where a
composite overflows its slots.  ``train_matcher(synth_bank=...)`` runs on
them with finite losses and a checkpoint, and refuses the host path.
"""

import jax
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.matching.features import build_topology as j_topology
from mpe3d_tpu.train.matcher_synth import build_scene_bank as j_bank
from mpe3d_tpu.train.matcher_synth import synth_scenes as j_synth
from mpe3d_tpu_torch.config import (PANOPTIC, MatcherConfig,
                                    MatcherTrainConfig)
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.train.matcher import train_matcher
from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes
from mpe3d_tpu_torch.train.matcher_synth import build_scene_bank, synth_scenes


@pytest.fixture(scope="module")
def recordings():
    rig = synthetic_ring_rig(PANOPTIC)
    noise = SceneNoise(pixel_sigma=1.0, joint_dropout=0.05,
                       spurious_rate=0.08, camera_dropout=0.05)
    return [generate_frames(PANOPTIC, rig, 40, n_people=(1, 1),
                            seed=10 + i, noise=noise, with_gt=False)
            for i in range(3)]


@pytest.fixture(scope="module")
def bank(recordings):
    return build_scene_bank(recordings, PANOPTIC,
                            min_views=PANOPTIC.min_number_of_views)


def _synth(bank, n, slots, seed):
    gen = torch.Generator().manual_seed(seed)
    out = synth_scenes(bank.tensors("cpu", build_topology(5, slots)), gen,
                       n)
    return tuple(t.numpy() for t in out)


def test_scene_bank_matches_jax(recordings, bank):
    ref = j_bank(recordings, J_PANOPTIC,
                 min_views=J_PANOPTIC.min_number_of_views)
    for name in ("kp", "valid", "prob", "obs", "nsk", "real_k",
                 "aug_frame", "aug_mask"):
        got, want = getattr(bank, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert bank.file_segments == ref.file_segments
    assert bank.top_sets == ref.top_sets
    with pytest.raises(ValueError, match="no parseable"):
        build_scene_bank(recordings[:1] + [[]], PANOPTIC)


def test_synth_shapes_and_invariants(bank):
    n = 64
    kp, valid, prob, obs, present, labels, weight = _synth(bank, n, 6, 0)
    assert kp.shape == (n, 5, 6, 18, 2) and labels.shape == (n, 360)
    assert obs.dtype == bool and present.dtype == bool
    assert np.all((labels == 0) | (weight > 0))
    assert set(np.unique(weight)) <= {0.0, 1.0, 2.0}
    assert np.all(~obs.any(axis=3) | present)
    # absent slots hold nothing
    assert not kp[~present].any() and not valid[~present].any()
    live = weight.sum(axis=1) > 0
    assert live.mean() > 0.5 and labels.sum() > 0


def _marginals(labels, weight, present):
    live = weight.sum(axis=1) > 0
    labels, weight, present = labels[live], weight[live], present[live]
    pos = (labels.sum(axis=1) / np.maximum((weight > 0).sum(axis=1), 1))
    dup = (weight == 2.0).sum() / max((weight > 0).sum(), 1)
    return pos.mean(), dup, present.sum(axis=(1, 2)).mean(), live.mean()


def test_synth_matches_host_and_jax_marginals(recordings, bank):
    """The bands of ``tests/test_matcher_synth.py`` (both sides are
    estimates from about a thousand scenes): against the host synthesiser,
    and against the JAX package's ``synth_scenes`` on the same bank."""
    host = build_matcher_scenes(recordings, PANOPTIC, build_topology(5, 6),
                                limit=400, seed=3, augment=True)
    assert len(host) > 100
    kp, valid, prob, obs, present, labels, weight = _synth(bank, 1024, 6, 7)
    got = _marginals(labels, weight, present)
    hp, hdup, hslots, _ = _marginals(host.labels, host.pair_weight,
                                     host.present)
    assert abs(got[0] - hp) < 0.25 * max(hp, 1e-6), (got, hp)
    assert abs(got[1] - hdup) < 0.15
    assert abs(got[2] - hslots) < 0.25 * hslots
    jb = j_bank(recordings, J_PANOPTIC)
    jout = jax.jit(lambda key: j_synth(jb.device_arrays(), key, 1024,
                                       j_topology(5, 6), jb.file_segments,
                                       jb.top_sets))(jax.random.PRNGKey(7))
    want = _marginals(*(np.asarray(jout[i]) for i in (5, 6, 4)))
    assert abs(got[0] - want[0]) < 0.25 * want[0], (got, want)
    assert abs(got[1] - want[1]) < 0.15
    assert abs(got[2] - want[2]) < 0.25 * want[2]
    # the null-scene share (overflows of 6 slots) within 0.1
    assert abs(got[3] - want[3]) < 0.1, (got, want)


def test_synth_null_scene_semantics(bank):
    """With one slot a camera, composites of several people overflow and
    come out as null scenes (weight 0, no label); the live ones are
    consistent."""
    _, _, _, _, _, labels, weight = _synth(bank, 64, 1, 1)
    null = weight.sum(axis=1) == 0
    assert null.any() and not null.all()
    assert not labels[null].any()
    assert np.all((labels == 0) | (weight > 0))


def test_synth_is_reproducible(bank):
    a, b = _synth(bank, 16, 4, 5), _synth(bank, 16, 4, 5)
    c = _synth(bank, 16, 4, 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_train_matcher_with_bank(recordings, bank, tmp_path):
    """``train_matcher(synth_bank=...)``: scan epochs on scenes synthesised
    on the device, finite losses, a checkpoint; the host path refuses the
    bank."""
    rig = synthetic_ring_rig(PANOPTIC)
    topo = build_topology(5, 4)
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8, 8),
                        heads=(2, 2))
    tcfg = MatcherTrainConfig(epochs=3, batch_size=8, eval_every=1, limit=32)
    dev = build_matcher_scenes(recordings, PANOPTIC, topo, limit=40, seed=5,
                               augment=False)
    res = train_matcher(None, dev, PANOPTIC, rig, topo, cfg, tcfg,
                        checkpoint_path=str(tmp_path / "m"),
                        synth_bank=bank, log=lambda s: None, device="cpu")
    assert res.epochs_run == 3 and int(res.opt_state[0]) == 3 * 4
    assert all(np.isfinite(h["train_loss"]) for h in res.history)
    assert np.isfinite(res.best_val_loss)
    assert (tmp_path / "m.npz").exists()
    with pytest.raises(ValueError, match="scan_epoch"):
        train_matcher(None, dev, PANOPTIC, rig, topo, cfg,
                      MatcherTrainConfig(scan_epoch=False), synth_bank=bank,
                      device="cpu")
