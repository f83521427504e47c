"""The port's label-free lifter training against the JAX package on the CPU.

The training-side packing (``pack_error_input``, ``apply_camera_dropout``,
``apply_prior_dropout``) and ``build_lifter_dataset`` (augment on and off,
each prior, prior dropout) must give JAX's arrays within 1e-5; the loss
kinds within 1e-5 relative; the ``TrainableLifter`` forward JAX's
``apply_lifter`` within 1e-5 (fp32) and 1e-2 relative (bf16 operands).
``train_lifter`` at narrow widths (64, 32), ``shuffle=False``, from the
same JAX ``init_lifter`` draw, must track JAX's per-epoch train and dev
losses within 1e-3 relative for every loss kind with and without EMA, and
with ``optimise_matrices`` (refined rigs within 1e-4); with bf16 operands
within 1e-2.  Checkpoints are read both ways (params and optimizer state,
forward within 1e-6), and a leg resumed from a JAX-saved optimizer state
tracks JAX's resumed leg within 1e-3.  JAX trains on a one-device mesh, so
both sides take the same batches.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import LifterTrainConfig as JTrainConfig
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.lifting import loss as jloss
from mpe3d_tpu.lifting import pack as jpack
from mpe3d_tpu.models.mlp import apply_lifter, init_lifter
from mpe3d_tpu.parallel.mesh import make_mesh
from mpe3d_tpu.train import checkpoint as jckpt
from mpe3d_tpu.train.lifter import train_lifter as j_train
from mpe3d_tpu.train.lifter_data import build_lifter_dataset as j_build
from mpe3d_tpu_torch import checkpoint as ckpt
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, LifterTrainConfig
from mpe3d_tpu_torch.data.synthetic import (SceneNoise,
                                            generate_single_person_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.lifting import loss, pack
from mpe3d_tpu_torch.train.lifter import init_lifter_tree, train_lifter
from mpe3d_tpu_torch.train.lifter_data import build_lifter_dataset

import torch_testing  # noqa: F401

WIDTHS = (64, 32)
DATA_TOL, LOSS_RTOL, BF16_RTOL, CKPT_TOL = 1e-5, 1e-3, 1e-2, 1e-6
NOISE = SceneNoise(pixel_sigma=1.5, joint_dropout=0.1, spurious_rate=0.1,
                   camera_dropout=0.1)
TRAIN = dict(epochs=3, batch_size=32, eval_every=1, lr=1e-3, shuffle=False)


@pytest.fixture(scope="module")
def wire():
    return generate_single_person_frames(PANOPTIC,
                                         synthetic_ring_rig(PANOPTIC), 48,
                                         seed=1, noise=NOISE)


@pytest.fixture(scope="module")
def data(wire):
    net, err = build_lifter_dataset(wire, PANOPTIC,
                                    synthetic_ring_rig(PANOPTIC),
                                    max_combinations=3, seed=0, device="cpu")
    return net[:96], err[:96], net[96:136], err[96:136]


@pytest.fixture(scope="module")
def init():
    cfg = JLifterConfig(widths=WIDTHS)
    return jax.tree_util.tree_map(np.asarray,
                                  init_lifter(jax.random.PRNGKey(0), cfg))


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


@pytest.mark.parametrize("augment, prior", [
    (False, "mean"), (True, "mean"), (True, "median"), (True, "irls")])
def test_lifter_dataset_matches_jax(wire, augment, prior):
    kw = dict(augment=augment, max_combinations=3, seed=2, prior=prior,
              prior_dropout=0.25)
    net, err = build_lifter_dataset(wire[:24], PANOPTIC,
                                    synthetic_ring_rig(PANOPTIC),
                                    device="cpu", **kw)
    jnet, jerr = j_build(wire[:24], J_PANOPTIC, j_ring(J_PANOPTIC), **kw)
    assert net.shape == jnet.shape and err.shape == jerr.shape
    assert len(net) > (24 if augment else 0)
    np.testing.assert_allclose(net, jnet, atol=DATA_TOL, rtol=0)
    np.testing.assert_allclose(err, jerr, atol=DATA_TOL, rtol=0)


def test_training_pack_and_loss_match_jax(data):
    net, err, _, _ = data
    rng = np.random.default_rng(0)
    J = PANOPTIC.n_joints
    cams = (rng.random((8, 5)) > 0.4).astype(np.float32)
    joints = (rng.random((8, J)) > 0.3).astype(np.float32)
    x = net[:8]
    got = pack.apply_prior_dropout(pack.apply_camera_dropout(
        torch.from_numpy(x), torch.from_numpy(cams), J),
        torch.from_numpy(joints), J)
    ref = jpack.apply_prior_dropout(jpack.apply_camera_dropout(
        jnp.asarray(x), jnp.asarray(cams), J), jnp.asarray(joints), J)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    kp = rng.uniform(0, 1900, (3, 31, J, 2)).astype(np.float32)
    v, p = rng.random((3, 31, J)).astype(np.float32), rng.random(
        (3, 31, J)).astype(np.float32)
    o = rng.random((3, 31, J)) > 0.3
    np.testing.assert_array_equal(
        pack.pack_error_input(*map(torch.from_numpy, (kp, v, p, o))).numpy(),
        np.stack([np.asarray(jpack.pack_error_input(kp[i], v[i], p[i], o[i]))
                  for i in range(3)]))
    pred = (rng.normal(0, 0.05, (16, 3 * J)) + np.tile([0, -0.1, 0], J))
    pred = pred.astype(np.float32)
    rig = synthetic_ring_rig(PANOPTIC)
    for kind in ("reference", "per_term", "huber"):
        got = loss.reprojection_loss(torch.from_numpy(pred),
                                     torch.from_numpy(err[:16]),
                                     rig.to("cpu"), J, kind=kind)
        ref = jloss.reprojection_loss(jnp.asarray(pred),
                                      jnp.asarray(err[:16]),
                                      j_ring(J_PANOPTIC), J, kind=kind)
        assert float(got) == pytest.approx(float(ref), rel=DATA_TOL)
    np.testing.assert_allclose(
        loss.reprojection_error(torch.from_numpy(pred),
                                torch.from_numpy(err[:16]), rig.to("cpu"),
                                J).numpy(),
        jloss.reprojection_error(jnp.asarray(pred), jnp.asarray(err[:16]),
                                 j_ring(J_PANOPTIC), J), rtol=DATA_TOL)
    with pytest.raises(ValueError, match="kind"):
        loss.reprojection_loss(torch.from_numpy(pred),
                               torch.from_numpy(err[:16]), rig.to("cpu"), J,
                               kind="l2")


@pytest.mark.parametrize("residual", [False, True])
def test_trainable_lifter_forward_matches_apply_lifter(data, init, residual):
    net = data[0][:16]
    cfg = LifterConfig(widths=WIDTHS, residual_prior=residual)
    jcfg = JLifterConfig(widths=WIDTHS, residual_prior=residual)
    for cdt, jdt, rtol in ((None, None, DATA_TOL),
                           ("bf16", jnp.bfloat16, BF16_RTOL)):
        m = weights.trainable_lifter_from_tree(init, cfg, "cpu", cdt)
        got = m(torch.from_numpy(net)).detach().numpy()
        ref = np.asarray(apply_lifter(jax.tree_util.tree_map(
            jnp.asarray, init), jnp.asarray(net), jcfg, compute_dtype=jdt))
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max())
        back = weights.lifter_tree(m)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(init)):
            np.testing.assert_array_equal(a, b)
    tree = init_lifter_tree(cfg, 3)
    assert (not np.any(tree["layers"][-1]["w"])) == residual


def _losses(history):
    return np.array([[h["train_loss"], h["val_loss"]] for h in history])


def _both(data, init, tmp_path=None, **kw):
    net, err, nd, ed = data
    port = train_lifter(net, err, nd, ed, PANOPTIC,
                        synthetic_ring_rig(PANOPTIC),
                        LifterConfig(widths=WIDTHS),
                        LifterTrainConfig(**{**TRAIN, **kw}), params=init,
                        log=lambda s: None, device="cpu",
                        checkpoint_path=(str(tmp_path / "p" / "pose_estimator")
                                         if tmp_path else None))
    ref = j_train(net, err, nd, ed, J_PANOPTIC, j_ring(J_PANOPTIC),
                  JLifterConfig(widths=WIDTHS),
                  JTrainConfig(**{**TRAIN, **kw}), params=init, mesh=_mesh(),
                  log=lambda s: None,
                  checkpoint_path=(str(tmp_path / "j" / "pose_estimator")
                                   if tmp_path else None))
    return port, ref


@pytest.mark.parametrize("kind", ["reference", "per_term", "huber"])
@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_train_lifter_tracks_jax(data, init, kind, ema):
    port, ref = _both(data, init, loss=kind, ema_decay=ema)
    assert len(port.history) == len(ref.history) == TRAIN["epochs"]
    np.testing.assert_allclose(_losses(port.history), _losses(ref.history),
                               rtol=LOSS_RTOL)
    assert port.epochs_run == ref.epochs_run
    assert port.best_val_loss == pytest.approx(ref.best_val_loss,
                                               rel=LOSS_RTOL)


def test_train_lifter_partial_batch_tracks_jax(data, init):
    """Fewer samples than a batch: one partial batch an epoch (the JAX
    trainer's per-batch path), in order."""
    port, ref = _both(data, init, batch_size=128, loss="per_term")
    np.testing.assert_allclose(_losses(port.history), _losses(ref.history),
                               rtol=LOSS_RTOL)


def test_train_lifter_optimise_matrices_and_bf16_track_jax(data, init):
    port, ref = _both(data, init, optimise_matrices=True)
    np.testing.assert_allclose(_losses(port.history), _losses(ref.history),
                               rtol=LOSS_RTOL)
    for f in ("T_wc", "K", "dist"):
        np.testing.assert_allclose(getattr(port.rig, f),
                                   np.asarray(getattr(ref.rig, f)),
                                   atol=1e-4, rtol=1e-5)
    assert not np.array_equal(port.rig.T_wc,
                              synthetic_ring_rig(PANOPTIC).T_wc)
    port, ref = _both(data, init, compute_dtype="bf16", loss="per_term")
    np.testing.assert_allclose(_losses(port.history), _losses(ref.history),
                               rtol=BF16_RTOL)


def test_train_lifter_refuses_mesh_and_orbax(data, init, tmp_path):
    """What was refused now trains: a one-device mesh trains as no mesh,
    a mesh of two local devices asks for a ``torch.distributed`` world
    (the port trains one process a device; ``tests/test_torch_parallel.py``
    holds the worlds to JAX), and the orbax backend trains with saves on
    the saver thread: the checkpoint JAX loads is the result."""
    from mpe3d_tpu_torch.parallel.mesh import make_mesh as p_mesh

    net, err, nd, ed = data
    args = (net, err, nd, ed, PANOPTIC, synthetic_ring_rig(PANOPTIC),
            LifterConfig(widths=WIDTHS))
    quiet = dict(params=init, log=lambda s: None, device="cpu")
    one = train_lifter(*args, LifterTrainConfig(**TRAIN),
                       mesh=p_mesh(devices=["cpu"]), **quiet)
    plain = train_lifter(*args, LifterTrainConfig(**TRAIN), **quiet)
    np.testing.assert_array_equal(_losses(one.history),
                                  _losses(plain.history))
    with pytest.raises(ValueError, match="torchrun"):
        train_lifter(*args, LifterTrainConfig(**TRAIN),
                     mesh=p_mesh(devices=["cpu", "cpu"]), **quiet)
    stem = str(tmp_path / "pose_estimator")
    res = train_lifter(*args, LifterTrainConfig(
        **TRAIN, checkpoint_backend="orbax", save_rel_improve=0.0),
        checkpoint_path=stem, **quiet)
    assert os.path.isdir(stem + ".orbax") and not os.path.exists(
        stem + ".npz")
    np.testing.assert_array_equal(_losses(res.history),
                                  _losses(plain.history))
    loaded, _, meta = jckpt.load_checkpoint(
        stem, init_lifter(jax.random.PRNGKey(1), JLifterConfig(
            widths=WIDTHS)))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    ckpt.flatten_tree(res.params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert meta["train_config"]["checkpoint_backend"] == "orbax"
    assert meta["val_loss"] == res.best_val_loss


def test_checkpoints_cross_load_and_resume(data, init, tmp_path):
    """Port-saved checkpoints load in JAX (params and optimizer state) and
    JAX-saved ones in the port, with the same forward; a leg resumed from
    a JAX-saved optimizer state tracks JAX's resumed leg."""
    net, err, nd, ed = data
    port, ref = _both(data, init, tmp_path, epochs=2)
    jcfg, cfg = JLifterConfig(widths=WIDTHS), LifterConfig(widths=WIDTHS)
    x = jnp.asarray(nd[:8])
    # the port's checkpoint through JAX's loader, and JAX's through the
    # port's
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))
    stem = str(tmp_path / "p" / "pose_estimator")
    jp, _, meta = jckpt.load_checkpoint(stem, init)
    jmeta = jckpt.read_meta(str(tmp_path / "j" / "pose_estimator"))
    assert set(meta) == set(jmeta) and meta["epoch"] == jmeta["epoch"]
    assert set(meta["train_config"]) == set(jmeta["train_config"])
    assert jckpt.lifter_config_from_meta(jckpt.read_meta(stem), jcfg) == jcfg
    tree, lcfg, _ = ckpt.load_lifter_checkpoint(
        str(tmp_path / "j" / "pose_estimator"), cfg)
    assert lcfg == cfg
    for a_tree, b_tree in ((jp, port.params), (tree, ref.params)):
        a = weights.trainable_lifter_from_tree(a_tree, cfg, "cpu")
        b = weights.trainable_lifter_from_tree(b_tree, cfg, "cpu")
        np.testing.assert_allclose(a(torch.from_numpy(nd[:8])).detach(),
                                   b(torch.from_numpy(nd[:8])).detach(),
                                   atol=CKPT_TOL)
    np.testing.assert_allclose(
        weights.trainable_lifter_from_tree(jp, cfg, "cpu")(
            torch.from_numpy(nd[:8])).detach(),
        apply_lifter(jax.tree_util.tree_map(jnp.asarray, jp), x, jcfg),
        atol=CKPT_TOL)
    # optimizer state: the port's (count, mu, nu) into optax's template
    ckpt.save_checkpoint(str(tmp_path / "o"), port.params, port.opt_state,
                         meta={"lifter_config": cfg})
    _, jo, _ = jckpt.load_checkpoint(str(tmp_path / "o"), init,
                                     tx.init({"model": init}))
    flat = jax.tree_util.tree_leaves(jo)
    assert int(flat[0]) == port.opt_state[0] == 2 * (len(net) // 32)
    for a, b in zip(flat[1:], ckpt.flatten_tree(port.opt_state)[1:]):
        np.testing.assert_array_equal(np.asarray(a), b)
    # JAX's optimizer state resumed in the port
    jstate = tx.init({"model": jax.tree_util.tree_map(jnp.asarray,
                                                      ref.params)})
    for _ in range(2):      # a state that is not the initial one
        g = jax.tree_util.tree_map(lambda t: jnp.full_like(t, 0.01),
                                   {"model": ref.params})
        _, jstate = tx.update(g, jstate)
    jckpt.save_checkpoint(str(tmp_path / "jo"), ref.params, jstate,
                          meta={"lifter_config": dataclasses.asdict(jcfg)})
    leaves = ckpt.read_optimizer_leaves(str(tmp_path / "jo"))
    assert len(leaves) == 1 + 2 * 2 * len(WIDTHS + (1,))
    resumed = train_lifter(net, err, nd, ed, PANOPTIC,
                           synthetic_ring_rig(PANOPTIC), cfg,
                           LifterTrainConfig(**{**TRAIN, "epochs": 1}),
                           params=ckpt.load_lifter_checkpoint(
                               str(tmp_path / "jo"), cfg)[0],
                           opt_state=leaves, log=lambda s: None,
                           device="cpu")
    jresumed = j_train(net, err, nd, ed, J_PANOPTIC, j_ring(J_PANOPTIC),
                       jcfg, JTrainConfig(**{**TRAIN, "epochs": 1}),
                       params=ref.params, opt_state=jstate, mesh=_mesh(),
                       log=lambda s: None)
    np.testing.assert_allclose(_losses(resumed.history),
                               _losses(jresumed.history), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="leaves"):
        train_lifter(net, err, nd, ed, PANOPTIC,
                     synthetic_ring_rig(PANOPTIC), cfg,
                     LifterTrainConfig(**TRAIN), params=ref.params,
                     opt_state=leaves[:3], device="cpu")
    assert ckpt.checkpoint_exists(stem)
    assert not ckpt.checkpoint_exists(str(tmp_path / "none"))


def test_jsonl_logger_and_nan_debugging_match_jax(data, init, tmp_path,
                                                  capsys):
    """``utils/logging.py``: ``JsonlLogger`` as ``train_lifter``'s log
    writes the records (and prints the lines) JAX's logger writes for the
    same events, the time apart; ``enable_nan_debugging`` makes a backward
    pass through a NaN raise."""
    from mpe3d_tpu.utils import logging as jlog
    from mpe3d_tpu_torch.utils import logging as plog

    net, err, nd, ed = data
    got = plog.JsonlLogger(str(tmp_path / "p" / "run.jsonl"), run="lifter")
    train_lifter(net, err, nd, ed, PANOPTIC, synthetic_ring_rig(PANOPTIC),
                 LifterConfig(widths=WIDTHS),
                 LifterTrainConfig(**{**TRAIN, "epochs": 2}), params=init,
                 log=got, device="cpu")
    got.event("done", loss=0.25, epochs=2)
    got.close()
    printed = capsys.readouterr().out
    lines = (tmp_path / "p" / "run.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["kind"] for r in recs] == ["log", "log", "done"]
    ref = jlog.JsonlLogger(str(tmp_path / "j.jsonl"), run="lifter")
    for r in recs:
        ref.event(r["kind"], **{k: v for k, v in r.items()
                                if k not in ("t", "kind", "run")})
    ref.close()
    want = [json.loads(line) for line in
            (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in r.items() if k != "t"} for r in recs] == \
        [{k: v for k, v in r.items() if k != "t"} for r in want]
    assert printed.splitlines()[-1] == "[done] loss=0.25 epochs=2"
    plog.enable_nan_debugging()
    try:
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * float("nan")).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
