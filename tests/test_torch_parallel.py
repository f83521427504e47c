"""Data- and tensor-parallel training of the port over ``torch.distributed``
against the JAX package's meshes, on the CPU.

One world of two processes (this file run as a script: gloo, a ``file://``
store, a process-group timeout, the processes under a subprocess timeout
well inside the per-test alarm) trains, from the same numpy-seeded inputs
as the tests here:

* the lifter over a 2x1 data-parallel mesh (widths 64, 32, ``shuffle=
  False``): per-epoch train and dev losses within 1e-3 relative of JAX's
  ``train_lifter(mesh=make_mesh(devices=jax.devices()[:2]))`` on two
  virtual CPU devices, and within 1e-5 of the port's one-process run (the
  same global batches), parameters within 1e-4;
* the lifter over a 1x2 tensor-parallel mesh (widths 64, 32, 16, so a
  column-parallel layer feeds the whole head: the gather path) with orbax
  checkpoints: losses within 1e-3 of JAX's ``make_mesh(n_data=1,
  n_model=2)``, and rank 0's checkpoint, the whole tree gathered from the
  slices, read by JAX's ``load_checkpoint`` equal to the result;
* the matcher over the 2x1 mesh on host scenes (``scan_epoch=False``, a
  dev batch of 3 scenes padded at zero weight): losses within 1e-3 of
  JAX's two-device run;
* the matcher on scenes synthesised on the device: every rank synthesises
  the whole batch and keeps its block, so the losses are the port's
  one-process run's within 1e-5 (JAX synthesises with ``jax.random``, so
  its scenes differ).

``torchrun --nproc-per-node 2 -m mpe3d_tpu_torch train-lifter --cpu`` runs
the command line's world (``_train_world``: env:// from torchrun, gloo)
against the one-process command.  The mesh's argument checks,
``pad_to_multiple`` and the tensor-parallel layout are held to JAX's
directly; ``infer_batch`` refuses a mesh of ranks.

    python tests/test_torch_parallel.py --rank R --world 2 --dir DIR
"""

import argparse
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_testing import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS, TP_WIDTHS = (64, 32), (64, 32, 16)
NARROW = dict(hidden=(8, 8), heads=(2, 2))
LIFTER_TRAIN = dict(epochs=3, batch_size=32, eval_every=1, lr=1e-3,
                    shuffle=False)
MATCHER_TRAIN = dict(epochs=3, batch_size=8, eval_every=1, lr=1e-3,
                     scan_epoch=False)
SYNTH_TRAIN = dict(epochs=3, batch_size=8, eval_every=1, limit=32)
PG_TIMEOUT_S, WORLD_TIMEOUT_S = 120, 400
LOSS_RTOL, WORLD_RTOL = 1e-3, 1e-5
TASKS = ("lifter_dp", "lifter_tp", "matcher_host", "matcher_synth")


# ---------------------------------------------------------------------------
# the inputs (the same in the world and in the tests) and the port's runs
# ---------------------------------------------------------------------------


def _lifter_data():
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.data.synthetic import (SceneNoise,
                                                generate_single_person_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.train.lifter_data import build_lifter_dataset

    rig = synthetic_ring_rig(PANOPTIC)
    noise = SceneNoise(pixel_sigma=1.5, joint_dropout=0.1,
                       spurious_rate=0.1, camera_dropout=0.1)
    wire = generate_single_person_frames(PANOPTIC, rig, 48, seed=1,
                                         noise=noise)
    net, err = build_lifter_dataset(wire, PANOPTIC, rig, max_combinations=3,
                                    seed=0, device="cpu")
    return net[:96], err[:96], net[96:136], err[96:136]


def _lifter_init(widths):
    from mpe3d_tpu_torch.config import LifterConfig
    from mpe3d_tpu_torch.train.lifter import init_lifter_tree

    return init_lifter_tree(LifterConfig(widths=widths), 7)


def _matcher_scenes():
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.data.synthetic import (SceneNoise,
                                                generate_single_person_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.matching.features import build_topology
    from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes

    rig = synthetic_ring_rig(PANOPTIC)
    noise = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03,
                       spurious_rate=0.1, camera_dropout=0.05)
    files = [generate_single_person_frames(PANOPTIC, rig, 24, seed=s,
                                           noise=noise) for s in (0, 1, 2)]
    topo = build_topology(5, 4)
    return (build_matcher_scenes(files[:2], PANOPTIC, topo, limit=20,
                                 seed=0),
            build_matcher_scenes(files[2:], PANOPTIC, topo, limit=11,
                                 seed=1), files)


def _matcher_init():
    from mpe3d_tpu_torch.config import PANOPTIC, MatcherConfig
    from mpe3d_tpu_torch.weights import random_matcher_tree

    cfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    return cfg, random_matcher_tree(cfg, 3)


def _serving():
    """A narrow pipeline on the CPU and 7 parsed S=4 frames."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    rig = synthetic_ring_rig(PANOPTIC)
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, **NARROW)
    lcfg = LifterConfig(widths=WIDTHS)
    pipe = PoseEstimationPipeline(
        PANOPTIC, rig,
        weights.matcher_from_tree(weights.random_matcher_tree(mcfg, 0),
                                  mcfg, "cpu"),
        weights.lifter_from_tree(weights.random_lifter_tree(lcfg, 1), lcfg,
                                 "cpu"), slot_buckets=(4,),
        person_buckets=(8,), threshold=0.05, decode_top_k=0, device="cpu")
    frames = [parse_frame(f, PANOPTIC, max_skeletons=4)
              for f in generate_frames(PANOPTIC, rig, 7, n_people=(1, 2),
                                       seed=41, with_gt=False)]
    return pipe, frames


def run_port(task, mesh=None, ckpt=None):
    """The port's run of ``task`` (over ``mesh``, one process without):
    {"history": [(epoch, train, val)], "params": leaves}."""
    from mpe3d_tpu_torch.checkpoint import flatten_tree
    from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig,
                                        LifterTrainConfig,
                                        MatcherTrainConfig)
    from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
    from mpe3d_tpu_torch.matching.features import build_topology
    from mpe3d_tpu_torch.train.lifter import train_lifter
    from mpe3d_tpu_torch.train.matcher import train_matcher
    from mpe3d_tpu_torch.train.matcher_synth import build_scene_bank

    rig = synthetic_ring_rig(PANOPTIC)
    quiet = dict(log=lambda s: None, device="cpu", mesh=mesh)
    if task.startswith("lifter"):
        widths = WIDTHS if task == "lifter_dp" else TP_WIDTHS
        backend = "orbax" if ckpt else "npz"
        res = train_lifter(*_lifter_data(), PANOPTIC, rig,
                           LifterConfig(widths=widths),
                           LifterTrainConfig(**LIFTER_TRAIN,
                                             checkpoint_backend=backend,
                                             save_rel_improve=0.0),
                           params=_lifter_init(widths),
                           checkpoint_path=ckpt, **quiet)
    else:
        train, dev, files = _matcher_scenes()
        cfg, init = _matcher_init()
        topo = build_topology(5, 4)
        if task == "matcher_host":
            res = train_matcher(train, dev, PANOPTIC, rig, topo, cfg,
                                MatcherTrainConfig(**MATCHER_TRAIN),
                                params=init, **quiet)
        else:
            bank = build_scene_bank(files, PANOPTIC)
            res = train_matcher(None, dev, PANOPTIC, rig, topo, cfg,
                                MatcherTrainConfig(**SYNTH_TRAIN),
                                params=init, synth_bank=bank, **quiet)
    return {"history": [(h["epoch"], h["train_loss"], h["val_loss"])
                        for h in res.history],
            "params": flatten_tree(res.params)}


def _worker(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from mpe3d_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    dp = make_mesh(device="cpu")
    tp = make_mesh(n_data=1, n_model=world, device="cpu")
    assert (dp.n_data, dp.n_model, tp.n_data, tp.n_model) == (world, 1, 1,
                                                              world)
    out = {}
    for task in TASKS:
        t0 = time.time()
        out[task] = run_port(
            task, tp if task == "lifter_tp" else dp,
            ckpt=(os.path.join(d, "tp", "pose_estimator")
                  if task == "lifter_tp" else None))
        out[task]["seconds"] = time.time() - t0
    if rank == 0:
        with open(os.path.join(d, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


class _World:
    """The two-process world, started at once and waited for when its
    results are first asked for."""

    def __init__(self, d):
        self.dir, self._out = str(d), None
        env = subprocess_env(PYTHONPATH=REPO)
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", "2", "--dir", self.dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(2)]
        self.t0 = time.monotonic()

    def results(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                left = WORLD_TIMEOUT_S - (time.monotonic() - self.t0)
                try:
                    logs.append(p.communicate(timeout=max(left, 1))[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
            assert all(p.returncode == 0 for p in self.procs), \
                "\n".join(logs)[-4000:]
            with open(os.path.join(self.dir, "results.pkl"), "rb") as f:
                self._out = pickle.load(f)
        return self._out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(tmp_path_factory.mktemp("world"))
    yield w
    for p in w.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_lifter(mesh_kw, widths):
    import jax

    from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
    from mpe3d_tpu.config import LifterConfig as JLifterConfig
    from mpe3d_tpu.config import LifterTrainConfig as JTrainConfig
    from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
    from mpe3d_tpu.parallel.mesh import make_mesh as j_mesh
    from mpe3d_tpu.train.lifter import train_lifter as j_train

    res = j_train(*_lifter_data(), J_PANOPTIC, j_ring(J_PANOPTIC),
                  JLifterConfig(widths=widths),
                  JTrainConfig(**LIFTER_TRAIN), params=_lifter_init(widths),
                  mesh=j_mesh(devices=jax.devices()[:2], **mesh_kw),
                  log=lambda s: None)
    return [(h["epoch"], h["train_loss"], h["val_loss"])
            for h in res.history]


def _assert_tracks(got, want, rtol):
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want],
                               rtol=rtol)


def test_lifter_data_parallel_tracks_jax_and_one_process(world):
    ref = _jax_lifter({}, WIDTHS)
    one = run_port("lifter_dp")
    got = world.results()["lifter_dp"]
    assert len(got["history"]) == LIFTER_TRAIN["epochs"]
    _assert_tracks(got["history"], ref, LOSS_RTOL)
    _assert_tracks(got["history"], one["history"], WORLD_RTOL)
    for a, b in zip(got["params"], one["params"]):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_lifter_tensor_parallel_tracks_jax_and_saves_whole(world):
    import jax

    from mpe3d_tpu.config import LifterConfig as JLifterConfig
    from mpe3d_tpu.models.mlp import init_lifter
    from mpe3d_tpu.train.checkpoint import load_checkpoint

    ref = _jax_lifter({"n_data": 1, "n_model": 2}, TP_WIDTHS)
    got = world.results()["lifter_tp"]
    _assert_tracks(got["history"], ref, LOSS_RTOL)
    stem = os.path.join(world.dir, "tp", "pose_estimator")
    assert os.path.isdir(stem + ".orbax")
    loaded, _, meta = load_checkpoint(
        stem, init_lifter(jax.random.PRNGKey(0),
                          JLifterConfig(widths=TP_WIDTHS)))
    leaves = jax.tree_util.tree_leaves(loaded)
    assert [np.shape(l) for l in leaves] == [a.shape for a in got["params"]]
    for a, b in zip(leaves, got["params"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert meta["train_config"]["checkpoint_backend"] == "orbax"


def test_matcher_data_parallel_host_scenes_track_jax(world):
    import jax
    import jax.numpy as jnp

    from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
    from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
    from mpe3d_tpu.config import MatcherTrainConfig as JTrainConfig
    from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
    from mpe3d_tpu.matching.features import build_topology as j_topology
    from mpe3d_tpu.parallel.mesh import make_mesh as j_mesh
    from mpe3d_tpu.train.matcher import train_matcher as j_train

    train, dev, _ = _matcher_scenes()
    cfg, init = _matcher_init()
    import dataclasses
    res = j_train(train, dev, J_PANOPTIC, j_ring(J_PANOPTIC),
                  j_topology(5, 4), JMatcherConfig(**dataclasses.asdict(cfg)),
                  JTrainConfig(**MATCHER_TRAIN),
                  mesh=j_mesh(devices=jax.devices()[:2]),
                  params=jax.tree_util.tree_map(jnp.asarray, init),
                  log=lambda s: None)
    ref = [(h["epoch"], h["train_loss"], h["val_loss"])
           for h in res.history]
    _assert_tracks(world.results()["matcher_host"]["history"], ref,
                   LOSS_RTOL)


def test_matcher_data_parallel_device_scenes_match_one_process(world):
    one = run_port("matcher_synth")
    got = world.results()["matcher_synth"]
    assert len(got["history"]) == SYNTH_TRAIN["epochs"]
    _assert_tracks(got["history"], one["history"], WORLD_RTOL)


def test_infer_batch_refuses_a_mesh_of_ranks():
    """``infer_batch(mesh=...)`` splits frames over one process's devices;
    a mesh of ranks (what ``make_mesh()`` gives under a world) raises."""
    from mpe3d_tpu_torch.parallel.mesh import Mesh

    pipe, frames = _serving()
    ranks = Mesh(np.array([[0], [1]], dtype=object), distributed=True)
    with pytest.raises(ValueError, match="mesh of ranks"):
        pipe.infer_batch(frames, mesh=ranks)


def _epoch_lines(text):
    return [[float(line.split("|")[i].split()[-1]) for i in (1, 2)]
            for line in text.splitlines() if line.startswith("epoch")]


def test_train_lifter_under_torchrun_matches_one_process(tmp_path, capsys):
    """``torchrun --standalone --nproc-per-node 2 -m mpe3d_tpu_torch
    train-lifter --cpu --resume`` on a narrow checkpoint: the command joins
    torchrun's world (gloo) and trains over a data-axis mesh of both ranks;
    only rank 0 prints (each line once) and saves; its epoch lines are the
    one-process command's at the same global batch within 1e-5 relative,
    its checkpoint's parameters within 1e-4, its files the same."""
    from mpe3d_tpu_torch import cli
    from mpe3d_tpu_torch.checkpoint import read_checkpoint, save_checkpoint
    from mpe3d_tpu_torch.config import LifterConfig

    for name, extra in (("train", ["--frames", "40", "--seed", "1"]),
                        ("dev", ["--frames", "16", "--seed", "2"])):
        cli.main(["generate-synthetic", "--single-person", "--output",
                  str(tmp_path / f"{name}.json"), *extra])
    lcfg = LifterConfig(widths=WIDTHS)
    dirs = {k: tmp_path / k for k in ("world", "one")}
    for d in dirs.values():
        save_checkpoint(str(d / "pose_estimator"), _lifter_init(WIDTHS),
                        meta={"lifter_config": lcfg, "prior": "mean",
                              "epoch": 0})
    args = ["train-lifter", "--cpu", "--resume", "--trainset",
            str(tmp_path / "train.json"), "--devset",
            str(tmp_path / "dev.json"), "--epochs", "6", "--batch-size",
            "100"]
    env = subprocess_env(PYTHONPATH=REPO)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "mpe3d_tpu_torch", *args,
         "--modelsdir", str(dirs["world"])],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=WORLD_TIMEOUT_S)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    capsys.readouterr()
    cli.main([*args, "--modelsdir", str(dirs["one"])])
    one = capsys.readouterr().out
    for line in ("dataset length: 200 (dev 80)", "resuming from",
                 "best dev loss"):
        assert r.stdout.count(line) == 1 and one.count(line) == 1, r.stdout
    got, want = _epoch_lines(r.stdout), _epoch_lines(one)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=WORLD_RTOL)
    assert (sorted(p.name for p in dirs["world"].iterdir())
            == sorted(p.name for p in dirs["one"].iterdir()))
    a, meta_a = read_checkpoint(str(dirs["world"] / "pose_estimator"))
    b, meta_b = read_checkpoint(str(dirs["one"] / "pose_estimator"))
    assert meta_a["epoch"] == meta_b["epoch"]
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), atol=1e-4)


def test_mesh_checks_and_layout_match_jax():
    import jax

    from mpe3d_tpu.parallel import mesh as jm
    from mpe3d_tpu_torch.parallel import mesh as pm

    for kw in (dict(n_model=3), dict(n_model=0), dict(n_data=0),
               dict(n_data=3, n_model=1)):
        with pytest.raises(ValueError) as want:
            jm.make_mesh(devices=jax.devices()[:2], **kw)
        with pytest.raises(ValueError) as got:
            pm.make_mesh(devices=["cpu", "cpu"], **kw)
        if "n_model" in str(want.value) or "empty" in str(want.value):
            assert str(got.value) == str(want.value)
    m = pm.make_mesh(n_data=1, n_model=2, devices=["cpu", "cpu"])
    assert (m.size, m.shape) == (2, {"data": 1, "model": 2})
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for k in (1, 2, 3, 5):
        got, n = pm.pad_to_multiple(x, k)
        want, n_j = jm.pad_to_multiple(x, k)
        np.testing.assert_array_equal(got, want)
        assert n == n_j
    jmesh = jm.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    for widths in (WIDTHS, TP_WIDTHS, (63, 32)):
        tree = _lifter_init(widths) if widths != (63, 32) else {
            "layers": [{"w": np.zeros((1260, 63))}, {"w": np.zeros((63, 32))},
                       {"w": np.zeros((32, 54))}]}
        spec = {pm.COL["w"]: "col", pm.ROW["w"]: "row", (): "whole"}
        got = [spec[s["w"]] for s in pm.lifter_tp_shardings(m, tree)
               ["layers"]]
        want = []
        for s in jm.lifter_tp_shardings(jmesh, tree)["layers"]:
            p = tuple(s["w"].spec)
            want.append("col" if p == (None, "model") else
                        "row" if p == ("model", None) else "whole")
        assert got == want


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    _worker(a.rank, a.world, a.dir)
