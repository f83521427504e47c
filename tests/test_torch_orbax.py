"""The port's orbax checkpoints (``mpe3d_tpu_torch/checkpoint_orbax.py``,
``checkpoint.py``) against the JAX package's, on the CPU.

* The JAX package writes (OCDBT, zstd, through orbax), the port reads:
  parameters, a nonzero Adam state, the meta and bf16 bit patterns equal
  bit for bit; and the reverse: the port writes the plain zarr layout and
  JAX's ``load_checkpoint`` reads it bit for bit.  tensorstore, an
  independent reader, gives every key's value the port's OCDBT reader
  gives, also for a store with interior B-tree nodes.
* The committed fixture ``tests/data/orbax_lifter/`` (a narrow lifter's
  parameters and Adam state, written by JAX's ``save_checkpoint(...,
  backend="orbax")``, its npz twin beside it) reads as its twin, and a
  fresh JAX save of the same tree reads the same.
* The semantics of ``tests/test_checkpoint_orbax.py`` on the port: a
  committed staging directory adopted, a twin npz and orbax pair (each
  save removes the other; the newer read), a params-only read of a
  checkpoint with optimizer leaves, a shape mismatch and a missing leaf
  raising, async saves waited for, the watchdog's npz fallback, the wait's
  deadline, a healed sidecar; a checksum mismatch and a missing zstd
  library raise.
* ``train-lifter`` / ``train-matcher --ckpt-backend orbax`` of one package
  resumed (``--resume``) by the other's command line.
"""

import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpe3d_tpu import cli as jcli
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.train import checkpoint as jck
from mpe3d_tpu_torch import checkpoint as ck
from mpe3d_tpu_torch import checkpoint_orbax as cko
from mpe3d_tpu_torch import cli

import torch_testing  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_lifter")
FIXTURE_CFG = dict(in_dim=120, out_dim=54, widths=(16, 8))


def _dims(cfg):
    d = (cfg.in_dim, *cfg.widths, cfg.out_dim)
    return list(zip(d[:-1], d[1:]))


def fixture_tree():
    """The fixture's tree: a narrow lifter (numpy draws) and the Adam state
    of three steps on numpy gradients, with its meta."""
    rng = np.random.default_rng(18)
    cfg = JLifterConfig(**FIXTURE_CFG)
    dims = _dims(cfg)
    params = {"layers": [
        {"b": rng.standard_normal(o).astype(np.float32) * 0.1,
         "w": rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)}
        for i, o in dims]}
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))
    state = tx.init({"model": params})
    p = {"model": params}
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                  .astype(np.float32)), p)
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
    meta = {"lifter_config": cfg, "epoch": 3, "prior": "mean"}
    return (jax.tree_util.tree_map(np.asarray, p["model"]),
            jax.tree_util.tree_map(np.asarray, state), meta)


def write_fixture(d):
    """JAX saves of the fixture tree into ``d``: ``pose_estimator.orbax/``
    (and its sidecar) and the npz twin ``twin.npz``."""
    params, state, meta = fixture_tree()
    jck.save_checkpoint(os.path.join(d, "pose_estimator"), params,
                        opt_state=state, meta=meta, backend="orbax")
    jck.save_checkpoint(os.path.join(d, "twin"), params, opt_state=state,
                        meta=meta)
    for f in os.listdir(d):
        if f.endswith(".lock"):
            os.remove(os.path.join(d, f))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _flat_equal(data, ref):
    assert sorted(data) == sorted(k for k in ref if k != "__meta_json__")
    for k in data:
        a, b = data[k], ref[k]
        if torch.is_tensor(a):
            a = a.view(torch.int16).numpy().view(np.uint16)
            b = np.asarray(b).view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


def test_committed_fixture_reads_as_its_npz_twin(tmp_path):
    d = tmp_path / "fixture"
    shutil.copytree(FIXTURE, d)
    data, meta = ck.open_checkpoint(str(d / "pose_estimator"))
    assert isinstance(data, cko.OrbaxCheckpoint)
    assert data.metadata["use_ocdbt"] is True
    with np.load(d / "twin.npz") as twin:
        _flat_equal(data, dict(twin))
        assert meta == json.loads(bytes(twin["__meta_json__"]).decode())
    assert meta["epoch"] == 3
    # a fresh JAX save of the same tree reads the same
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    write_fixture(str(fresh))
    again, meta2 = ck.open_checkpoint(str(fresh / "pose_estimator"))
    _flat_equal(again, {k: data[k] for k in data})
    assert meta2 == meta
    # and it loads as a lifter through the port's loader
    tree, cfg, prior = ck.load_lifter_checkpoint(
        str(d / "pose_estimator"), ck.LifterConfig())
    assert cfg.widths == (16, 8) and cfg.in_dim == 120 and prior == "mean"
    assert tree["layers"][0]["w"].shape == (120, 16)


def _jax_tree():
    params, state, meta = fixture_tree()
    params["layers"][1]["w16"] = jnp.asarray(
        params["layers"][1]["w"], jnp.bfloat16)
    return params, state, meta


def test_jax_writes_port_reads_bit_for_bit(tmp_path):
    params, state, meta = _jax_tree()
    stem = str(tmp_path / "ck")
    jck.save_checkpoint(stem, params, opt_state=state, meta=meta,
                        backend="orbax")
    leaves, got_meta = ck.read_checkpoint(stem)
    ref = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        if torch.is_tensor(a):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy().view(np.uint16),
                np.asarray(b).view(np.uint16))
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype
    opt = ck.read_optimizer_leaves(stem)
    ref_o = _leaves(state)
    assert len(opt) == len(ref_o) and int(opt[0]) == 3
    for a, b in zip(opt, ref_o):
        np.testing.assert_array_equal(a, b)
        assert a.shape == b.shape
    assert got_meta == json.loads(jck._meta_json(meta))


def test_port_writes_jax_reads_bit_for_bit(tmp_path):
    params, state, meta = fixture_tree()
    tparams = {"layers": [{k: torch.from_numpy(v.copy())
                           for k, v in l.items()}
                          for l in params["layers"]]}
    tparams["layers"][1]["w16"] = torch.from_numpy(
        params["layers"][1]["w"].copy()).to(torch.bfloat16)
    stem = str(tmp_path / "ck")
    ck.save_checkpoint(stem, tparams, opt_state=state, meta=meta,
                       backend="orbax")
    assert os.path.isdir(stem + ".orbax")
    with open(os.path.join(stem + ".orbax", "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False
    tmpl = {"layers": [dict(l) for l in params["layers"]]}
    tmpl["layers"][1]["w16"] = jnp.zeros((16, 8), jnp.bfloat16)
    loaded, opt, jmeta = jck.load_checkpoint(stem, tmpl, state)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    ck.tree_leaves(tparams)):
        if b.dtype == torch.bfloat16:
            assert a.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                b.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(_leaves(opt), _leaves(state)):
        np.testing.assert_array_equal(a, b)
    assert jmeta["epoch"] == 3 and jmeta["lifter_config"]["widths"] == [16, 8]


def test_tensorstore_agrees_with_the_ocdbt_reader(tmp_path):
    import tensorstore as ts

    params, state, meta = _jax_tree()
    stem = str(tmp_path / "ck")
    jck.save_checkpoint(stem, params, opt_state=state, meta=meta,
                        backend="orbax")
    roots = [stem + ".orbax"]
    # a store whose B-tree has interior nodes (small nodes, many keys)
    tree = str(tmp_path / "tree")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tree}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(0)
    for i in range(60):
        kv.write(f"key{i:03d}/s{'x' * (i % 5)}",
                 rng.integers(0, 256, i % 40, dtype=np.uint8).tobytes()
                 ).result()
    roots.append(tree)
    for root in roots:
        store = cko.OcdbtStore(root)
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{root}/"}).result()
        keys = sorted(k.decode() for k in kv.list().result())
        assert sorted(store.keys()) == keys and len(keys) >= 20
        for k in keys:
            assert store.get(k) == kv.read(k).result().value, k
    # every array as tensorstore's zarr driver reads it
    data = cko.OrbaxCheckpoint(stem + ".orbax")
    for name in data:
        ref = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{stem}.orbax/",
            "path": f"{name}/"}}).result().read().result()
        got = data[name]
        if torch.is_tensor(got):
            got = got.view(torch.int16).numpy().view(np.uint16)
            ref = np.asarray(ref).view(np.uint16)
        np.testing.assert_array_equal(got, ref)


def test_corrupt_node_and_missing_zstd_raise(tmp_path, monkeypatch):
    d = tmp_path / "fixture"
    shutil.copytree(FIXTURE, d)
    root = d / "pose_estimator.orbax"
    monkeypatch.setattr(cko, "_ZSTD", False)
    with pytest.raises(RuntimeError, match="libzstd.so.1"):
        cko.OrbaxCheckpoint(str(root))
    monkeypatch.undo()
    manifest = root / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 0xFF
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        cko.OrbaxCheckpoint(str(root))


def _lifter(seed, widths=(16,)):
    rng = np.random.default_rng(seed)
    dims = _dims(JLifterConfig(widths=widths))
    return {"layers": [{"b": rng.standard_normal(o).astype(np.float32),
                        "w": rng.standard_normal((i, o)).astype(np.float32)}
                       for i, o in dims]}


def _equal(a, b):
    for x, y in zip(ck.tree_leaves(a), ck.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_orbax_staging_is_adopted_and_overwrite_replaces(tmp_path):
    p1, p2 = _lifter(0), _lifter(2)
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, p1, meta={"epoch": 1}, backend="orbax")
    ck.save_checkpoint(path, p2, meta={"epoch": 2}, backend="orbax")
    assert os.path.isdir(path + ".orbax")
    assert not os.path.isdir(path + ".orbax.next")
    # the crash window: a committed save demoted to staging
    os.rename(path + ".orbax", path + ".orbax.next")
    os.rename(path + ".json", path + ".json.next")
    assert ck.checkpoint_exists(path)
    assert ck.read_meta(path)["epoch"] == 2
    loaded, opt, meta = ck.load_checkpoint(path, p1)
    _equal(loaded, p2)
    assert opt is None and meta["epoch"] == 2
    assert os.path.isdir(path + ".orbax")
    assert not os.path.isdir(path + ".orbax.next")
    # JAX reads what the port swapped in
    _equal(jck.load_checkpoint(path, p1)[0], p2)


def test_backend_switch_never_reads_a_stale_twin(tmp_path, capsys):
    p1, p2 = _lifter(0), _lifter(2)
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, p1, meta={"epoch": 1}, backend="npz")
    ck.save_checkpoint(path, p2, meta={"epoch": 2}, backend="orbax")
    assert not os.path.exists(path + ".npz")
    loaded, _, meta = ck.load_checkpoint(path, p1)
    _equal(loaded, p2)
    assert meta["epoch"] == 2
    ck.save_checkpoint(path, p1, meta={"epoch": 3}, backend="npz")
    assert not os.path.isdir(path + ".orbax")
    loaded, _, meta = ck.load_checkpoint(path, p2)
    _equal(loaded, p1)
    assert meta["epoch"] == 3
    # a twin from outside: the newer is read, with JAX's message
    jck.save_checkpoint(str(tmp_path / "j"), p2, meta={"epoch": 4},
                        backend="orbax")
    shutil.copytree(str(tmp_path / "j.orbax"), path + ".orbax")
    later = time.time() + 5
    os.utime(path + ".orbax", (later, later))
    capsys.readouterr()
    loaded, _, _ = ck.load_checkpoint(path, p1)
    _equal(loaded, p2)
    assert "loading the newer (orbax)" in capsys.readouterr().err


def test_params_only_read_shape_mismatch_and_missing_leaf(tmp_path):
    params = _lifter(0)
    state = (np.asarray(5, np.int32), params, params)
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, params, opt_state=state, meta={"epoch": 3},
                       backend="orbax")
    loaded, opt, meta = ck.load_checkpoint(path, _lifter(1))
    _equal(loaded, params)
    assert opt is None and meta["epoch"] == 3
    _, opt, _ = ck.load_checkpoint(path, _lifter(1), state)
    assert int(opt[0]) == 5
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(path, _lifter(0, widths=(32,)))
    longer = {"layers": params["layers"] + _lifter(3)["layers"][:1]}
    with pytest.raises(ValueError, match="lacks"):
        ck.load_checkpoint(path, longer)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path / "nope"), params)


def test_async_saves_wait_and_failures_surface(tmp_path):
    params = _lifter(0)
    path = str(tmp_path / "sub" / "ck")
    t = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in l.items()}
                    for l in params["layers"]]}
    ck.save_checkpoint(path, t, meta={"epoch": 1}, backend="orbax",
                       wait=False)
    t["layers"][0]["w"].add_(1.0)           # after the submit: not saved
    ck.wait_for_async_saves()
    _equal(ck.load_checkpoint(path, params)[0], params)
    with pytest.raises(TypeError):
        ck.save_checkpoint(path, {"layers": [{"w": object()}]},
                           backend="orbax", wait=False)
        ck.wait_for_async_saves()
    ck.wait_for_async_saves()               # drained: no re-raise
    _equal(ck.load_checkpoint(path, params)[0], params)
    # the wait's own deadline: a TimeoutError with the saver's stack
    release = threading.Event()
    fut = ck._save_executor().submit(lambda: release.wait(60))
    stuck = os.path.abspath(str(tmp_path / "stuck"))
    ck._PENDING_SAVES.append((stuck, fut))
    try:
        with pytest.raises(TimeoutError, match="did not commit within"):
            ck.wait_for_async_saves(timeout=0.5)
        assert any(p == stuck for p, _ in ck._PENDING_SAVES)
        # another path's load neither blocks on nor inherits it
        _equal(ck.load_checkpoint(path, params)[0], params)
    finally:
        release.set()
        fut.result(timeout=60)
        ck._PENDING_SAVES[:] = [pf for pf in ck._PENDING_SAVES
                                if pf[0] != stuck]


def test_wedged_write_falls_back_to_npz(tmp_path, monkeypatch, capsys):
    release, calls = threading.Event(), []
    real = cko.write_orbax_dir

    def wedged(path, flat):
        calls.append(path)
        release.wait(30)
        real(path, flat)

    monkeypatch.setattr(cko, "write_orbax_dir", wedged)
    monkeypatch.setenv("MPE3D_ORBAX_WATCHDOG_S", "1")
    params = _lifter(0)
    path = str(tmp_path / "ck")
    try:
        ck.save_checkpoint(path, params, meta={"epoch": 9}, backend="orbax",
                           wait=False)
        t0 = time.monotonic()
        ck.wait_for_async_saves()
        assert time.monotonic() - t0 < 20 and len(calls) == 1
        assert os.path.exists(path + ".npz")
        assert not os.path.isdir(path + ".orbax")
        loaded, _, meta = ck.load_checkpoint(path, params)
        _equal(loaded, params)
        assert meta["epoch"] == 9
        assert "WATCHDOG" in capsys.readouterr().err
    finally:
        release.set()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.name == "mpe3d-ckpt-orbax-write" for t in threading.enumerate()):
        time.sleep(0.05)
    assert not os.path.isdir(path + ".orbax.next")
    assert not [f for f in os.listdir(tmp_path) if "orbax.next-" in f]
    assert ck.load_checkpoint(path, params)[2]["epoch"] == 9


def test_sidecar_heals_from_the_embedded_meta(tmp_path):
    params = _lifter(0)
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, params, meta={"epoch": 1}, backend="orbax")
    ck.save_checkpoint(path, params, meta={"epoch": 2}, backend="orbax")
    assert os.path.exists(os.path.join(path + ".orbax", "_mpe3d_meta.json"))
    with open(path + ".json", "w") as f:
        json.dump({"epoch": 1}, f)
    os.utime(path + ".json", (0, 0))
    assert ck.read_meta(path)["epoch"] == 2
    assert jck.read_meta(path)["epoch"] == 2


def _wire(d):
    for name, extra in (("train", ["--single-person", "--frames", "40",
                                   "--seed", "1"]),
                        ("dev", ["--single-person", "--frames", "16",
                                 "--seed", "2"])):
        cli.main(["generate-synthetic", "--output", str(d / f"{name}.json"),
                  *extra])
    return str(d / "train.json"), str(d / "dev.json")


def _epochs(text):
    return [[float(line.split("|")[i].split()[-1]) for i in (1, 2)]
            for line in text.splitlines() if line.startswith("epoch")]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_train_commands_resume_each_others_orbax(tmp_path, capsys, first):
    """train-lifter / train-matcher with ``--ckpt-backend orbax`` by one
    command line, ``--resume`` by the other: the resumed legs' epoch
    lines equal each command line resuming its own checkpoint within
    1e-3 relative."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig

    train, dev = _wire(tmp_path)
    a, b = ((cli.main, jcli.main) if first == "port"
            else (jcli.main, cli.main))
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8, 8),
                         heads=(2, 2))
    lcfg = LifterConfig(widths=(64, 64))
    seed_dir = tmp_path / "seed"
    ck.save_checkpoint(str(seed_dir / "skeleton_matching"),
                       weights.random_matcher_tree(mcfg, 0),
                       meta={"matcher_config": mcfg})
    ck.save_checkpoint(str(seed_dir / "pose_estimator"),
                       weights.random_lifter_tree(lcfg, 1),
                       meta={"lifter_config": lcfg, "prior": "mean",
                             "epoch": 0})
    lifter = ["train-lifter", "--cpu", "--trainset", train, "--devset", dev,
              "--epochs", "6", "--batch-size", "200", "--loss", "per_term",
              "--resume"]
    matcher = ["train-matcher", "--cpu", "--trainset", train, dev,
               "--devset", dev, train, "--epochs", "6", "--batch-size", "8",
               "--limit", "8", "--resume"]
    for cmd in (lifter, matcher):
        first_dir = tmp_path / f"{cmd[0]}-first"
        shutil.copytree(seed_dir, first_dir)
        a([*cmd, "--modelsdir", str(first_dir), "--ckpt-backend", "orbax"])
        stem = "pose_estimator" if cmd is lifter else "skeleton_matching"
        assert (first_dir / f"{stem}.orbax").is_dir()
        assert not (first_dir / f"{stem}.npz").exists()
        legs = {}
        for name, main in (("other", b), ("same", a)):
            d = tmp_path / f"{cmd[0]}-{name}"
            shutil.copytree(first_dir, d)
            capsys.readouterr()
            main([*cmd, "--modelsdir", str(d), "--ckpt-backend", "orbax"])
            out = capsys.readouterr().out
            assert "resuming from" in out
            legs[name] = _epochs(out)
            assert (d / f"{stem}.orbax").is_dir()
        assert len(legs["other"]) == 2
        np.testing.assert_allclose(legs["other"], legs["same"], rtol=1e-3)
