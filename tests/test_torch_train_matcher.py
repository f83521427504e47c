"""The port's matcher training against the JAX package on the CPU.

``TrainableMatcher`` (through ``train/matcher.py::MatcherObjective``, a
batch as one union graph) must give the JAX package's ``scene_scores`` of
``make_matcher_step`` within 1e-5 on training scenes with their pair
multiplicities: a plain, a residual and a bias-free narrow matcher, the
alt-1 graph (plain and residual), and one full-width matcher.  The MSE and
BCE losses and their gradients within 1e-5 (relative and absolute), BCE
finite at saturated scores.  ``train_matcher`` at narrow widths
(``scan_epoch=False``, so both take ``default_rng(seed)``'s batches; the
same numpy init, dropout off, a one-device mesh on the JAX side) must
track JAX's per-epoch train and dev losses within 1e-3 relative with MSE,
BCE and ``prune_dist``, and on the alt-1 graph; with the scan path's dev evaluation (one full
batch an epoch, so the order does not matter); early stopping and
``epochs_run`` equal.  Checkpoints and optimizer state are read both ways,
and a resumed leg tracks JAX's resumed leg.  Dropout: eval deterministic,
train-mode scale 1 / (1 - p).  The reference's own training test
(``tests/test_training.py::test_matcher_training_learns``) fails on this
tree's ring rig; these compare with JAX's output instead of copying its
assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.config import MatcherTrainConfig as JTrainConfig
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching.features import build_topology as j_topology
from mpe3d_tpu.models.gat import init_matcher
from mpe3d_tpu.parallel.mesh import make_mesh
from mpe3d_tpu.train import checkpoint as jckpt
from mpe3d_tpu.train.matcher import bce_per_element as j_bce
from mpe3d_tpu.train.matcher import make_matcher_step
from mpe3d_tpu.train.matcher import train_matcher as j_train
from mpe3d_tpu_torch import checkpoint as ckpt
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import (PANOPTIC, MatcherConfig,
                                    MatcherTrainConfig)
from mpe3d_tpu_torch.data.synthetic import (SceneNoise,
                                            generate_single_person_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.ops.gat_kernel import dropout
from mpe3d_tpu_torch.train.matcher import (MatcherObjective, bce_per_element,
                                           matcher_loss, scene_tensors,
                                           train_matcher)
from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes
from mpe3d_tpu_torch.weights import random_matcher_tree

import torch_testing  # noqa: F401

NARROW = dict(hidden=(8, 8), heads=(2, 2))
SCORE_TOL, LOSS_RTOL = 1e-5, 1e-3
NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.1,
                   camera_dropout=0.05)
TRAIN = dict(epochs=3, batch_size=8, eval_every=1, lr=1e-3,
             scan_epoch=False)


@pytest.fixture(scope="module")
def files():
    rig = synthetic_ring_rig(PANOPTIC)
    return [generate_single_person_frames(PANOPTIC, rig, 24, seed=s,
                                          noise=NOISE) for s in (0, 1, 2)]


@pytest.fixture(scope="module")
def scenes(files):
    """(train, dev) scenes on the S=4 topology: 20 and 11 scenes."""
    topo = build_topology(5, 4)
    train = build_matcher_scenes(files[:2], PANOPTIC, topo, limit=20, seed=0)
    dev = build_matcher_scenes(files[2:], PANOPTIC, topo, limit=11, seed=1)
    assert len(train) == 20 and len(dev) == 11
    return train, dev


def _jcfg(cfg: MatcherConfig) -> JMatcherConfig:
    return JMatcherConfig(**dataclasses.asdict(cfg))


def _rig_config(alt: str):
    return (dataclasses.replace(PANOPTIC, graph_alternative=alt),
            dataclasses.replace(J_PANOPTIC, graph_alternative=alt))


def _jax_scores(rc_j, cfg, tree, batch, topo_j):
    match_rig = j_ring(J_PANOPTIC).select(
        np.asarray(J_PANOPTIC.matching_camera_indices()))
    _, _, scene_scores, _, _ = make_matcher_step(
        match_rig, rc_j, topo_j, _jcfg(cfg), optax.adam(1e-4))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    kp, valid, prob, obs, present, _, weight = batch
    return np.asarray(jax.jit(jax.vmap(scene_scores,
                                       in_axes=(None,) + (0,) * 6))(
        params, *map(jnp.asarray, (kp, valid, prob, obs, present, weight))))


def _objective(rc, cfg, **kw):
    rig = synthetic_ring_rig(PANOPTIC)
    return MatcherObjective(rig.select(PANOPTIC.matching_camera_indices()),
                            rc, build_topology(5, 4), cfg, "cpu", **kw)


@pytest.mark.parametrize("alt, variant", [
    ("3", {}), ("3", dict(residual=True)), ("3", dict(bias=False)),
    ("1", {}), ("1", dict(residual=True))])
def test_trainable_scores_match_jax(scenes, alt, variant):
    rc, rc_j = _rig_config(alt)
    in_dim = rc.matcher_feature_dim_alt(alt)
    cfg = MatcherConfig(in_dim=in_dim, **NARROW, **variant)
    tree = random_matcher_tree(cfg, 3)
    train, _ = scenes
    s = train.select(np.arange(6))
    batch = scene_tensors(s, "cpu")
    obj = _objective(rc, cfg)
    model = weights.trainable_matcher_from_tree(tree, cfg, "cpu")
    got = obj.scores(model, *batch[:5], batch[6]).detach().numpy()
    ref = _jax_scores(rc_j, cfg, tree, batch, j_topology(5, 4))
    assert got.shape == ref.shape == (6, 160)
    np.testing.assert_allclose(got, ref, atol=SCORE_TOL, rtol=0)
    assert np.ptp(got[s.pair_weight > 0]) > 1e-3


def test_full_width_scores_match_jax(scenes):
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim)
    tree = random_matcher_tree(cfg, 4)
    s = scenes[0].select(np.arange(3))
    batch = scene_tensors(s, "cpu")
    model = weights.trainable_matcher_from_tree(tree, cfg, "cpu")
    got = _objective(PANOPTIC, cfg).scores(model, *batch[:5], batch[6])
    ref = _jax_scores(J_PANOPTIC, cfg, tree, batch, j_topology(5, 4))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=SCORE_TOL,
                               rtol=0)


def _jax_loss(cfg, use_bce):
    match_rig = j_ring(J_PANOPTIC).select(
        np.asarray(J_PANOPTIC.matching_camera_indices()))
    _, eval_step, scene_scores, _, _ = make_matcher_step(
        match_rig, J_PANOPTIC, j_topology(5, 4), _jcfg(cfg),
        optax.adam(1e-4), use_bce=use_bce)

    def loss(params, batch):
        kp, valid, prob, obs, present, labels, weight = batch
        scores = jax.vmap(scene_scores, in_axes=(None,) + (0,) * 6)(
            params, kp, valid, prob, obs, present, weight)
        per = j_bce(scores, labels) if use_bce else (scores - labels) ** 2
        return jnp.sum(per * weight) / jnp.maximum(jnp.sum(weight), 1.0)
    return eval_step, jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("use_bce", [False, True])
def test_loss_and_gradients_match_jax(scenes, use_bce):
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    tree = random_matcher_tree(cfg, 5)
    batch = scene_tensors(scenes[0].select(np.arange(8)), "cpu")
    model = weights.trainable_matcher_from_tree(tree, cfg, "cpu")
    loss = _objective(PANOPTIC, cfg, use_bce=use_bce).loss(model, batch)
    grads = torch.autograd.grad(loss, model.tree_params())
    eval_step, vg = _jax_loss(cfg, use_bce)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = tuple(jnp.asarray(b.numpy()) for b in batch)
    jl, jg = vg(params, jbatch)
    assert abs(float(eval_step(params, jbatch)) - float(jl)) < 1e-7
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for g, r in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_bce_finite_at_saturation():
    """``bce_per_element`` at scores saturated to exactly 0 and 1: finite
    values and gradients, equal to the JAX package's."""
    s = torch.tensor([0.0, 1.0, 0.5, 1e-20, 1.0 - 1e-7], requires_grad=True)
    y = torch.tensor([0.0, 1.0, 1.0, 1.0, 0.0])
    val = bce_per_element(s, y)
    (grad,) = torch.autograd.grad(val.sum(), s)
    assert torch.isfinite(val).all() and torch.isfinite(grad).all(), grad
    jval, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(j_bce(v, jnp.asarray(y.numpy()))))(
        jnp.asarray(s.detach().numpy()))
    np.testing.assert_allclose(val.detach().numpy(),
                               np.asarray(j_bce(jnp.asarray(
                                   s.detach().numpy()),
                                   jnp.asarray(y.numpy()))), rtol=1e-6)
    np.testing.assert_allclose(float(val.sum().detach()), float(jval),
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    # the weighted loss of saturated scores is finite as well
    w = torch.tensor([1.0, 2.0, 1.0, 1.0, 2.0])
    assert torch.isfinite(matcher_loss(s, y, w, use_bce=True))


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _run_both(train, dev, cfg, tcfg, init, rigs=(PANOPTIC, J_PANOPTIC),
              **kw):
    """The port's and JAX's train_matcher on the same scenes from ``init``
    on the rig configs ``rigs``: (port result, JAX result)."""
    rig = synthetic_ring_rig(PANOPTIC)
    jtcfg = JTrainConfig(**dataclasses.asdict(tcfg))
    port = train_matcher(train, dev, rigs[0], rig, build_topology(5, 4),
                         cfg, tcfg, params=init, log=lambda s: None,
                         device="cpu", **kw.get("port", {}))
    ref = j_train(train, dev, rigs[1], j_ring(J_PANOPTIC),
                  j_topology(5, 4), _jcfg(cfg), jtcfg, mesh=_mesh(),
                  params=jax.tree_util.tree_map(jnp.asarray, init),
                  log=lambda s: None, **kw.get("jax", {}))
    return port, ref


def _losses(res):
    return [(h["epoch"], h["train_loss"], h["val_loss"]) for h in res.history]


def _assert_tracks(port, ref):
    got, want = _losses(port), _losses(ref)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want],
                               rtol=LOSS_RTOL)
    assert port.epochs_run == ref.epochs_run


@pytest.mark.parametrize("loss, alt", [(dict(), "3"), (dict(use_bce=True), "3"),
                                       (dict(prune_dist=0.2), "3"),
                                       (dict(), "1")])
def test_train_matcher_matches_jax(scenes, loss, alt):
    rc, rc_j = _rig_config(alt)
    cfg = MatcherConfig(in_dim=rc.matcher_feature_dim_alt(alt), **NARROW)
    tcfg = MatcherTrainConfig(**TRAIN, **loss)
    port, ref = _run_both(*scenes, cfg, tcfg, random_matcher_tree(cfg, 6),
                          rigs=(rc, rc_j))
    _assert_tracks(port, ref)
    assert len(port.history) == 3
    assert port.history[-1]["train_loss"] != port.history[0]["train_loss"]


def test_prune_dist_zeroes_far_pairs(scenes):
    """The pruned weights are JAX's ``_prune_w`` (pairs past the gate out,
    pairs with no shared joint kept)."""
    from mpe3d_tpu.matching.features import pair_ray_distances as j_dist

    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    s = scenes[0]
    kp, valid, _, obs, _, _, weight = scene_tensors(s, "cpu")
    got = _objective(PANOPTIC, cfg, prune_dist=0.2).pruned_weight(
        kp, valid, obs, weight).numpy()
    match_rig = j_ring(J_PANOPTIC).select(
        np.asarray(J_PANOPTIC.matching_camera_indices()))
    d = np.stack([np.asarray(j_dist(jnp.asarray(s.kp[i]), jnp.asarray(
        s.valid[i] * s.observed[i]), match_rig, j_topology(5, 4)))
        for i in range(len(s))])
    want = s.pair_weight * ((d <= 0.2) | (d >= 999.0))
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < (s.pair_weight > 0).sum()


def test_scan_dev_evaluation_matches_jax(scenes):
    """The scan path (one full batch an epoch, so the permutation does not
    matter) with its padded dev evaluation (11 dev scenes in batches of 8:
    5 zero-weight repeats) against JAX's ``eval_epoch``."""
    train, dev = scenes
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    tcfg = MatcherTrainConfig(**{**TRAIN, "scan_epoch": True,
                                 "batch_size": 20})
    port, ref = _run_both(train, dev, cfg, tcfg, random_matcher_tree(cfg, 7))
    _assert_tracks(port, ref)


def test_early_stopping_matches_jax(scenes):
    """A dev set with flipped labels gets worse as training improves: both
    packages stop after the same evaluations, ``epochs_run`` being the
    epoch that ran."""
    train, dev = scenes
    dev = dataclasses.replace(dev, labels=(dev.pair_weight > 0)
                              * (1.0 - dev.labels))
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    tcfg = MatcherTrainConfig(**{**TRAIN, "epochs": 8, "eval_every": 2,
                                 "patience": 2})
    port, ref = _run_both(train, dev, cfg, tcfg, random_matcher_tree(cfg, 8))
    _assert_tracks(port, ref)
    assert port.epochs_run < 8 and len(port.history) == 3
    assert port.best_val_loss == pytest.approx(ref.best_val_loss,
                                               rel=LOSS_RTOL)


def test_checkpoints_both_ways_and_resume(scenes, tmp_path):
    """A port checkpoint (params, optimizer state, meta) read by JAX's
    ``load_checkpoint`` and a JAX one by the port; each package's leg
    resumed from the other's checkpoint tracks the other's resumed leg."""
    train, dev = scenes
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW,
                        residual=True)
    # the reference's learning rate: at 1e-3 this residual matcher's
    # resumed leg grows the packages' rounding-level gradient differences
    # (1e-8) to 3e-3 of the dev loss within an epoch
    tcfg = MatcherTrainConfig(**{**TRAIN, "epochs": 2, "lr": 1e-4})
    init = random_matcher_tree(cfg, 9)
    pstem, jstem = str(tmp_path / "p" / "m"), str(tmp_path / "j" / "m")
    port, ref = _run_both(train, dev, cfg, tcfg, init,
                          port=dict(checkpoint_path=pstem),
                          jax=dict(checkpoint_path=jstem))
    _assert_tracks(port, ref)
    jcfg = _jcfg(cfg)
    tmpl_p = init_matcher(jax.random.PRNGKey(0), jcfg)
    tmpl_o = optax.adamw(tcfg.lr, weight_decay=tcfg.weight_decay).init(
        tmpl_p)
    # the port's checkpoint in JAX
    jp, jo, meta = jckpt.load_checkpoint(pstem, tmpl_p, tmpl_o)
    for a, b in zip(ckpt.flatten_tree(port.params),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(jax.tree_util.tree_leaves(jo)[0]) == 3 * (meta["epoch"] + 1)
    assert jckpt.matcher_config_from_meta(meta, jcfg) == jcfg
    assert meta["n_slots"] == 4
    # JAX's checkpoint in the port
    tree, got_cfg = ckpt.load_matcher_checkpoint(jstem, MatcherConfig())
    assert got_cfg == cfg
    jp, jo, jmeta = jckpt.load_checkpoint(jstem, tmpl_p, tmpl_o)
    for a, b in zip(ckpt.flatten_tree(tree), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    jleaves = ckpt.read_optimizer_leaves(jstem)
    for a, b in zip(jleaves, jax.tree_util.tree_leaves(jo)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the legs resumed from JAX's checkpoint in each package
    port2 = train_matcher(train, dev, PANOPTIC, synthetic_ring_rig(PANOPTIC),
                          build_topology(5, 4), cfg, tcfg, params=tree,
                          opt_state=jleaves, log=lambda s: None,
                          device="cpu")
    ref2 = j_train(train, dev, J_PANOPTIC, j_ring(J_PANOPTIC),
                   j_topology(5, 4), jcfg,
                   JTrainConfig(**dataclasses.asdict(tcfg)), mesh=_mesh(),
                   params=jp, opt_state=jo, log=lambda s: None)
    _assert_tracks(port2, ref2)
    assert int(port2.opt_state[0]) == 3 * (jmeta["epoch"] + 1) + 2 * 3


def test_dropout_semantics(scenes):
    """Inverted dropout keeps about 1 - p of the elements, each scaled by
    1 / (1 - p), the draws from the generator; the matcher with dropout
    rates is deterministic without a generator (eval) and draws with
    one (train), the same seed giving the same scores."""
    x = torch.ones(20000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, g)
    kept = y[y != 0]
    assert torch.all(kept == 1.0 / 0.75)
    assert abs(len(kept) / len(x) - 0.75) < 0.02
    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW,
                        feat_drop=0.2, attn_drop=0.3)
    model = weights.trainable_matcher_from_tree(random_matcher_tree(cfg, 10),
                                                cfg, "cpu")
    obj = _objective(PANOPTIC, cfg)
    batch = scene_tensors(scenes[0].select(np.arange(4)), "cpu")
    args = (model, *batch[:5], batch[6])
    e1, e2 = obj.scores(*args), obj.scores(*args)
    assert torch.equal(e1, e2)
    t1 = obj.scores(*args, generator=torch.Generator().manual_seed(1))
    t2 = obj.scores(*args, generator=torch.Generator().manual_seed(1))
    t3 = obj.scores(*args, generator=torch.Generator().manual_seed(2))
    assert torch.equal(t1, t2)
    assert not torch.equal(t1, e1) and not torch.equal(t1, t3)
    # the same rates in JAX's eval mode give the port's eval scores
    ref = _jax_scores(J_PANOPTIC, cfg, weights.matcher_tree(model), batch,
                      j_topology(5, 4))
    np.testing.assert_allclose(e1.detach().numpy(), ref, atol=SCORE_TOL,
                               rtol=0)


def test_train_matcher_refuses_meshes_and_orbax(scenes, tmp_path):
    """What was refused now trains: a one-device mesh as no mesh, a mesh
    of two local devices asks for a ``torch.distributed`` world
    (``tests/test_torch_parallel.py`` holds the worlds to JAX), and the
    orbax backend writes the best parameters and optimizer state, which
    JAX's ``load_checkpoint`` reads."""
    from mpe3d_tpu_torch.parallel.mesh import make_mesh as p_mesh

    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    rig = synthetic_ring_rig(PANOPTIC)
    topo = build_topology(5, 4)
    init = random_matcher_tree(cfg, 3)
    tcfg = MatcherTrainConfig(**TRAIN)
    quiet = dict(params=init, log=lambda s: None, device="cpu")
    one = train_matcher(*scenes, PANOPTIC, rig, topo, cfg, tcfg,
                        mesh=p_mesh(devices=["cpu"]), **quiet)
    plain = train_matcher(*scenes, PANOPTIC, rig, topo, cfg, tcfg, **quiet)
    assert _losses(one) == _losses(plain)
    with pytest.raises(ValueError, match="torchrun"):
        train_matcher(*scenes, PANOPTIC, rig, topo, cfg, tcfg,
                      mesh=p_mesh(devices=["cpu", "cpu"]), **quiet)
    stem = str(tmp_path / "skeleton_matching")
    res = train_matcher(*scenes, PANOPTIC, rig, topo, cfg,
                        dataclasses.replace(tcfg, checkpoint_backend="orbax"),
                        checkpoint_path=stem, **quiet)
    assert _losses(res) == _losses(plain)
    tmpl = init_matcher(jax.random.PRNGKey(0), _jcfg(cfg))
    loaded, opt, meta = jckpt.load_checkpoint(
        stem, tmpl, optax.adamw(1e-3).init(tmpl))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    ckpt.flatten_tree(res.params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert opt is not None and meta["val_loss"] == res.best_val_loss