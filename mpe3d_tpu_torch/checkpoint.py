"""The JAX package's npz checkpoints, read and written with numpy alone.

Format (written by ``mpe3d_tpu/train/checkpoint.py::save_checkpoint``):
``<stem>.npz`` holds the parameter leaves as ``p.leaf_NNNNN`` in
``jax.tree_util`` flatten order — dicts flatten with their keys sorted, so a
matcher layer's leaves come as ``attn_l, attn_r, b1, b2, w1, w2`` (a
bias-free matcher's without ``b1, b2``; a residual matcher's layers after
the first with a projection shortcut ``wr`` and its bias ``br`` where their
in and out widths differ, ``mpe3d_tpu/models/gat.py::init_matcher``) and a
lifter layer's as ``b, w`` — plus the meta JSON as a uint8 leaf
``__meta_json__``; ``<stem>.json`` is a sidecar copy of the meta.  bf16
servable exports (meta ``"stored": "bf16"``) store the weight bit patterns as
uint16, which are viewed back as bfloat16 here, never cast.  int8 servable
exports (``"stored": "int8"``) hold the tree of
``quantize_lifter_weights`` with its defaults: every layer but the last as
``b, rscale, scale, wq`` (int8 ``wq`` unpadded, fp32 scales), the last as
``b, w`` (fp32).

Writing (``save_checkpoint``, ``mpe3d_tpu/train/checkpoint.py:79-137``):
``p.leaf_*`` as above, optimizer leaves ``o.leaf_*`` in the order optax
flattens the state of the lifter's ``chain(clip_by_global_norm, adam)``
and the matcher's ``adamw`` (their clip, decay and scale states have no
leaves: Adam's ``count``, then ``mu``, then ``nu``, each a tree of the
trained variables, ``{"model": lifter tree, "rig": CameraRig}`` when the
rig is trained), and ``__meta_json__``; the npz is committed with one
``os.replace``, then the ``.json`` sidecar, so each package reads the
other's checkpoints, parameters and optimizer state both.  ``read_meta``
heals a sidecar older than its npz from the embedded copy.

The orbax backend (``backend="orbax"``, ``mpe3d_tpu/train/checkpoint.py``
:135-630, 738-830) writes the same flat leaves into ``<path>.orbax/``
(``checkpoint_orbax.py``: OCDBT and plain zarr read, plain zarr written,
no orbax, no tensorstore), with the JAX package's semantics:

* every save runs on one saver thread, so saves of a path serialise;
  ``wait=False`` returns at once (the leaves are snapshotted first: a
  tensor is cloned on its device, and the saver thread copies it to the
  host), and ``wait_for_async_saves(path, timeout)`` waits for them and
  re-raises the first failure, within a deadline;
* a save writes ``<path>.orbax.next-<token>/``, promotes it to
  ``<path>.orbax.next/`` and swaps it in with its meta
  (``_finalize_orbax_local``), so the live ``<path>.orbax/`` is deleted
  only once its replacement is on disk; a committed staging directory is
  adopted by the next read or save;
* a write that misses the watchdog's deadline (``MPE3D_ORBAX_WATCHDOG_S``,
  300 s) is abandoned, and the same snapshot is committed as npz, with a
  message saying so;
* an npz save removes the orbax artifacts and an orbax save the npz; where
  both exist, the newer is read, with a message;
* a sidecar older than the meta embedded in ``<path>.orbax/`` is healed
  from it; a params-only read of a checkpoint that holds optimizer leaves
  reads the parameters alone; a missing leaf or a shape that differs from
  the template raises.

Under ``torch.distributed`` the trainers save from rank 0 alone (tensor-
parallel slices are gathered to it first), every rank reads, and only
rank 0 swaps a staging directory in; no read waits on a barrier, so a
load on one rank alone cannot deadlock.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import sys
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch import checkpoint_orbax
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig, config_from_meta

_LIFTER_KEYS = ("b", "w")
_INT8_KEYS = ("b", "rscale", "scale", "wq")


def read_checkpoint(stem: str) -> Tuple[List[Any], Dict[str, Any]]:
    """The parameter leaves of the checkpoint at ``stem`` (``<stem>.npz``
    or ``<stem>.orbax/``, ``open_checkpoint``) in flatten order, and the
    meta (the copy saved with the arrays first, else the sidecar)."""
    data, meta = open_checkpoint(stem)
    return _leaves(data, "p", stem), meta


def _leaves(data: Mapping[str, Any], prefix: str, stem: str) -> List[Any]:
    names = sorted(k for k in data if k.startswith(prefix + ".leaf_"))
    if [int(n[len(prefix) + 6:]) for n in names] != list(range(len(names))):
        raise ValueError(f"{stem}: {prefix}.leaf_* leaves are not "
                         f"contiguous")
    return [data[k] for k in names]


class _NpzLeaves(Mapping):
    """The arrays of an npz file, each read on access."""

    def __init__(self, path: str):
        with np.load(path) as data:
            self._names = list(data.files)
        self.path = path

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        with np.load(self.path) as data:
            return data[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


def open_checkpoint(stem: str) -> Tuple[Mapping[str, Any], Dict[str, Any]]:
    """({leaf name: array}, meta) of the checkpoint at ``stem``, the arrays
    read on access.  Waits for this process's pending saves of ``stem`` and
    adopts a committed staging directory first; where both ``<stem>.npz``
    and ``<stem>.orbax/`` exist, the newer is read (a message says so)."""
    wait_for_async_saves(stem)
    _finalize_orbax(stem)
    have_npz = os.path.exists(stem + ".npz")
    have_orbax = os.path.isdir(stem + ".orbax")
    if have_npz and have_orbax:
        # each backend removes the other on save, so a twin is an older
        # layout or an outside copy
        have_npz = (os.path.getmtime(stem + ".npz")
                    >= os.path.getmtime(stem + ".orbax"))
        print(f"[mpe3d_torch] both {stem}.npz and .orbax/ exist; loading "
              f"the newer ({'npz' if have_npz else 'orbax'})",
              file=sys.stderr)
    if have_npz:
        data: Mapping[str, Any] = _NpzLeaves(stem + ".npz")
        embedded = (json.loads(bytes(data["__meta_json__"]).decode())
                    if "__meta_json__" in data else None)
    elif have_orbax:
        data = checkpoint_orbax.OrbaxCheckpoint(stem + ".orbax")
        embedded = data.embedded_meta()
    else:
        raise FileNotFoundError(f"no checkpoint at {stem} (.npz or "
                                f".orbax/)")
    return data, embedded if embedded is not None else read_meta(stem)


def bf16_from_bits(u16) -> torch.Tensor:
    """bfloat16 tensor with the given uint16 bit patterns (a bfloat16
    tensor, as an orbax checkpoint gives it, as it is)."""
    if torch.is_tensor(u16) and u16.dtype == torch.bfloat16:
        return u16
    u16 = np.ascontiguousarray(u16, dtype=np.uint16)
    return torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)


def matcher_layer_keys(cfg: MatcherConfig) -> List[Tuple[str, ...]]:
    """Each matcher layer's parameter names in flatten (sorted) order, as
    ``init_matcher`` makes them for ``cfg``."""
    out = []
    for li, (d_in, d, _) in enumerate(cfg.layer_dims()):
        keys = ["attn_l", "attn_r", "w1", "w2"]
        if cfg.bias:
            keys += ["b1", "b2"]
        if cfg.residual and li > 0 and d_in != d:
            keys += ["wr", "br"] if cfg.bias else ["wr"]
        out.append(tuple(sorted(keys)))
    return out


def _unflatten(leaves, keys, n_layers: int, stem: str):
    if len(leaves) != len(keys) * n_layers:
        raise ValueError(f"{stem}: {len(leaves)} leaves, expected "
                         f"{len(keys)} x {n_layers} layers")
    return {"layers": [dict(zip(keys, leaves[i * len(keys):
                                             (i + 1) * len(keys)]))
                       for i in range(n_layers)]}


def load_matcher_checkpoint(stem: str, default_cfg: MatcherConfig
                            ) -> Tuple[Dict[str, Any], MatcherConfig]:
    """Matcher tree ``{"layers": [{attn_l, attn_r, b1, b2, w1, w2}, ...]}`` of
    numpy arrays (keys per layer as ``matcher_layer_keys``), and the
    architecture stored in the meta."""
    leaves, meta = read_checkpoint(stem)
    cfg = matcher_config_from_meta(meta, default_cfg)
    layer_keys = matcher_layer_keys(cfg)
    if len(leaves) != sum(map(len, layer_keys)):
        raise ValueError(f"{stem}: {len(leaves)} leaves, the matcher "
                         f"config has {sum(map(len, layer_keys))}")
    layers, i = [], 0
    for keys in layer_keys:
        layers.append(dict(zip(keys, leaves[i:i + len(keys)])))
        i += len(keys)
    return {"layers": layers}, cfg


def load_lifter_checkpoint(stem: str, default_cfg: LifterConfig
                           ) -> Tuple[Dict[str, Any], LifterConfig, str]:
    """Lifter tree ``{"layers": [{"b", "w"}, ...]}`` (bf16 weights as
    bfloat16 tensors, everything else numpy; int8 exports: ``{"b", "rscale",
    "scale", "wq"}`` layers and a ``{"b", "w"}`` head), the architecture
    stored in the meta, and the packing prior (meta key ``prior``)."""
    leaves, meta = read_checkpoint(stem)
    cfg = lifter_config_from_meta(meta, default_cfg)
    stored = meta.get("stored", "fp32")
    n_layers = len(cfg.widths) + 1
    if stored == "int8":
        n_q = len(_INT8_KEYS) * (n_layers - 1)
        tree = _unflatten(leaves[:n_q], _INT8_KEYS, n_layers - 1, stem)
        tree["layers"] += _unflatten(leaves[n_q:], _LIFTER_KEYS, 1,
                                     stem)["layers"]
        if any(layer["wq"].dtype != np.int8 for layer in tree["layers"][:-1]):
            raise ValueError(f"{stem}: stored int8 layers without int8 wq")
        return tree, cfg, meta.get("prior", "mean")
    if stored not in ("fp32", "bf16"):
        raise NotImplementedError(
            f"{stem}: stored={stored!r} lifters are not ported")
    tree = _unflatten(leaves, _LIFTER_KEYS, n_layers, stem)
    if stored == "bf16":
        for layer in tree["layers"]:
            layer["w"] = bf16_from_bits(layer["w"])
    return tree, cfg, meta.get("prior", "mean")


# ---------------------------------------------------------------------------
# writing, and the meta
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    """A tree's leaves in ``jax.tree_util`` flatten order, as they are:
    dict keys sorted, lists, tuples and NamedTuples in order (a NamedTuple
    without fields, like optax's ``EmptyState``, has no leaves), None no
    leaf; every other value a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def flatten_tree(tree) -> List[np.ndarray]:
    """``tree_leaves``, each leaf as a numpy array."""
    return [t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in tree_leaves(tree)]


def unflatten_tree(template, leaves: List[Any]):
    """``template``'s structure with its leaves (``tree_leaves`` order)
    replaced by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def _json_default(o):
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.integer):
        return int(o)
    return str(o)


def _meta_json(meta: Optional[Dict[str, Any]]) -> str:
    meta = dict(meta or {})
    for k, v in list(meta.items()):
        if dataclasses.is_dataclass(v):
            meta[k] = dataclasses.asdict(v)
    return json.dumps(meta, indent=2, default=_json_default)


def _write_meta_at(file_path: str, meta: Optional[Dict[str, Any]]) -> None:
    with open(file_path, "w") as f:
        f.write(_meta_json(meta))


def save_checkpoint(path: str, params, opt_state=None,
                    meta: Optional[Dict[str, Any]] = None,
                    backend: str = "npz", wait: bool = True) -> None:
    """Write a checkpoint at ``path``: parameters ``p.*``, optimizer leaves
    ``o.*`` of ``opt_state`` when given, the meta, and the ``<path>.json``
    sidecar.  ``params`` / ``opt_state``: trees ``tree_leaves`` takes
    (numpy arrays or tensors on any device); dataclasses in ``meta`` are
    expanded.

    ``backend="npz"``: ``<path>.npz``, replaced in one rename, so a crash
    leaves the old checkpoint or the new one.  ``backend="orbax"``:
    ``<path>.orbax/`` (module header); with ``wait=False`` the save runs
    on the saver thread (``wait_for_async_saves`` before reading it back or
    exiting; the trainers do)."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend: {backend!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if backend == "orbax":
        _save_orbax(path, params, opt_state, meta, wait)
        return
    arrays = {f"p.leaf_{i:05d}": a
              for i, a in enumerate(flatten_tree(params))}
    arrays.update({f"o.leaf_{i:05d}": a
                   for i, a in enumerate(flatten_tree(opt_state))})
    # on the saver thread: serialised with any pending orbax save of the
    # path, which could otherwise remove this save's artifacts
    _save_executor().submit(_npz_commit, os.path.abspath(path), arrays,
                            meta).result()


def _npz_commit(path: str, arrays: Dict[str, np.ndarray], meta) -> None:
    """Commit arrays and meta (embedded as ``__meta_json__``) as
    ``<path>.npz`` and the sidecar, then remove any orbax artifacts of the
    path (they would shadow it)."""
    meta_json = _meta_json(meta)
    arrays = dict(arrays, __meta_json__=np.frombuffer(
        meta_json.encode(), dtype=np.uint8).copy())
    np.savez(path + ".npz.tmp.npz", **arrays)
    os.replace(path + ".npz.tmp.npz", path + ".npz")
    with open(path + ".json.tmp", "w") as f:
        f.write(meta_json)
    os.replace(path + ".json.tmp", path + ".json")
    _remove_orbax_artifacts(path)


# ---------------------------------------------------------------------------
# the orbax backend
# ---------------------------------------------------------------------------

_SAVE_EXECUTOR = None
_EXECUTOR_LOCK = threading.Lock()
_PENDING_SAVES: list = []


def _save_executor():
    """The one saver thread of this process."""
    global _SAVE_EXECUTOR
    with _EXECUTOR_LOCK:
        if _SAVE_EXECUTOR is None:
            from concurrent.futures import ThreadPoolExecutor
            _SAVE_EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mpe3d-ckpt-save")
    return _SAVE_EXECUTOR


@contextmanager
def _path_lock(path: str):
    """An exclusive lock on one checkpoint path, across threads and
    processes (flock): the swap (rmtree + rename) is not atomic, and a
    reader in another process must not interleave with it."""
    import fcntl

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path + ".lock", "a+") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _rank() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``, (0, 1) without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _sidecar_stale(path: str) -> bool:
    """Whether the meta embedded in ``<path>.orbax/`` is newer than the
    ``<path>.json`` sidecar (a crash between the swap and the sidecar's
    refresh)."""
    emb = os.path.join(path + ".orbax", "_mpe3d_meta.json")
    if not os.path.exists(emb):
        return False
    side = path + ".json"
    return (not os.path.exists(side)
            or os.path.getmtime(side) < os.path.getmtime(emb))


def _finalize_orbax(path: str) -> None:
    """``_finalize_orbax_local`` on rank 0 only (every rank reads the same
    directory); no barrier, so that a read on one rank alone cannot
    deadlock."""
    if _rank()[0] == 0:
        _finalize_orbax_local(path)


def _finalize_orbax_local(path: str) -> None:
    """Swap a committed staging save into place: ``<path>.orbax.next/`` ->
    ``<path>.orbax/`` with its meta (``<path>.json.next`` moved in as
    ``_mpe3d_meta.json``, so one rename commits arrays and meta), then
    refresh the sidecar from the embedded meta.  The staging directory
    only exists complete, so this is safe at any time, after a crash too;
    a ``.json.next`` without staging (a save that died before its arrays
    committed) is ignored."""
    staging, dest = path + ".orbax.next", path + ".orbax"
    if not (os.path.isdir(staging) or os.path.exists(path + ".json.next")
            or _sidecar_stale(path)):
        return
    with _path_lock(path):
        if os.path.isdir(staging):
            if os.path.exists(path + ".json.next"):
                os.replace(path + ".json.next",
                           os.path.join(staging, "_mpe3d_meta.json"))
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            os.rename(staging, dest)
        emb = os.path.join(dest, "_mpe3d_meta.json")
        if os.path.isdir(dest) and os.path.exists(emb) \
                and _sidecar_stale(path):
            shutil.copyfile(emb, path + ".json.tmp")
            os.replace(path + ".json.tmp", path + ".json")


def _remove_orbax_artifacts(path: str) -> None:
    token_dirs = glob.glob(path + ".orbax.next-*")
    if not (os.path.isdir(path + ".orbax")
            or os.path.isdir(path + ".orbax.next")
            or os.path.exists(path + ".json.next") or token_dirs):
        return
    with _path_lock(path):
        for d in (path + ".orbax", path + ".orbax.next", *token_dirs):
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
        if os.path.exists(path + ".json.next"):
            os.remove(path + ".json.next")


def _thread_stack(thread: threading.Thread) -> str:
    """The formatted stack of another live thread (what a wedged saver is
    doing)."""
    import traceback

    frame = sys._current_frames().get(thread.ident)
    if frame is None:
        return "<thread not found (already exited?)>"
    return "".join(traceback.format_stack(frame))


def _watchdog_seconds() -> float:
    """The deadline of one orbax write (``MPE3D_ORBAX_WATCHDOG_S``, 300 s;
    0 disables the watchdog)."""
    return float(os.environ.get("MPE3D_ORBAX_WATCHDOG_S", "300"))


def _snapshot(leaf):
    """A copy of a leaf that later in-place updates cannot reach: a tensor
    is cloned on its device (the saver thread moves it to the host)."""
    if torch.is_tensor(leaf):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


def _save_orbax(path: str, params, opt_state, meta, wait: bool) -> None:
    # leaves and meta are snapshotted in the caller's thread: the trainer
    # goes on updating its tensors while the saver thread writes
    flat = {f"p.leaf_{i:05d}": _snapshot(l)
            for i, l in enumerate(tree_leaves(params))}
    flat.update({f"o.leaf_{i:05d}": _snapshot(l)
                 for i, l in enumerate(tree_leaves(opt_state))})
    meta = dict(meta or {})
    abspath = os.path.abspath(path)

    def write_with_watchdog() -> bool:
        """Write into this attempt's own ``<path>.orbax.next-<token>/``
        and promote it to ``<path>.orbax.next/`` within the deadline;
        False when the writer missed it (it is abandoned and, should it
        finish later, deletes its own token directory and nothing else)."""
        deadline = _watchdog_seconds()
        # token directories of crashed or abandoned writers, old enough
        # that no healthy writer of another process can own them
        stale_s = max(2 * deadline if deadline > 0 else 0.0, 600.0)
        with _path_lock(abspath):
            for stale in glob.glob(abspath + ".orbax.next-*"):
                try:
                    if time.time() - os.path.getmtime(stale) > stale_s:
                        shutil.rmtree(stale, ignore_errors=True)
                except OSError:
                    pass
        token = f"{abspath}.orbax.next-{uuid.uuid4().hex[:8]}"

        def promote():
            with _path_lock(abspath):
                if os.path.isdir(abspath + ".orbax.next"):
                    shutil.rmtree(abspath + ".orbax.next")
                os.rename(token, abspath + ".orbax.next")

        if deadline <= 0:
            checkpoint_orbax.write_orbax_dir(token, flat)
            promote()
            return True
        done, abandoned, err = threading.Event(), threading.Event(), []

        def write():
            try:
                checkpoint_orbax.write_orbax_dir(token, flat)
            except Exception as e:  # noqa: BLE001 -- surfaced through err
                err.append(e)
            finally:
                if abandoned.is_set():
                    shutil.rmtree(token, ignore_errors=True)
                done.set()

        writer = threading.Thread(target=write, daemon=True,
                                  name="mpe3d-ckpt-orbax-write")
        writer.start()
        if done.wait(timeout=deadline):
            if err:
                raise err[0]
            promote()
            return True
        abandoned.set()
        print(f"[mpe3d_torch] WATCHDOG: orbax save of {abspath} exceeded "
              f"{deadline:.0f}s; abandoning the wedged writer thread and "
              f"falling back to a synchronous npz save.\n"
              f"Wedged writer stack:\n{_thread_stack(writer)}",
              file=sys.stderr, flush=True)
        return False

    def task():
        _finalize_orbax(abspath)            # adopt a committed predecessor
        # the meta goes to .json.next BEFORE the arrays commit, so a
        # finalize always swaps arrays and meta in as a pair
        _write_meta_at(abspath + ".json.next", meta)
        if not write_with_watchdog():
            # the same snapshot through the npz backend, which removes the
            # orbax artifacts (this save's .json.next included)
            _npz_commit(abspath, {k: (v.cpu().numpy() if torch.is_tensor(v)
                                      else v) for k, v in flat.items()},
                        meta)
            return
        _finalize_orbax(abspath)
        with _path_lock(abspath):
            if os.path.exists(abspath + ".npz"):
                os.remove(abspath + ".npz")     # it would shadow this save

    # every save goes through the one saver thread, so saves of a path
    # serialise and an older queued snapshot never commits after a newer
    fut = _save_executor().submit(task)
    if wait:
        fut.result()
    else:
        _PENDING_SAVES.append((abspath, fut))


def wait_for_async_saves(path: Optional[str] = None,
                         timeout: Optional[float] = None) -> None:
    """Block until this process's pending ``wait=False`` saves have
    committed: all of them, or those of ``path``.  Re-raises the first
    failure.  The whole wait has a deadline of ``timeout`` seconds
    (default: the watchdog's times the pending count plus 60 s, at least
    120 s; ``MPE3D_CKPT_WAIT_TIMEOUT_S`` overrides it; none when the
    watchdog is off), past which a TimeoutError carries the saver
    thread's stack and the undrained saves stay pending."""
    global _PENDING_SAVES
    if path is None:
        pending, _PENDING_SAVES = _PENDING_SAVES, []
    else:
        target = os.path.abspath(path)
        pending = [pf for pf in _PENDING_SAVES if pf[0] == target]
        _PENDING_SAVES = [pf for pf in _PENDING_SAVES if pf[0] != target]
    if not pending:
        return
    if timeout is None:
        env = os.environ.get("MPE3D_CKPT_WAIT_TIMEOUT_S")
        if env:
            timeout = float(env)
        elif _watchdog_seconds() > 0:
            timeout = max(120.0, _watchdog_seconds() * len(pending) + 60.0)
    deadline = None if timeout is None else time.monotonic() + timeout
    from concurrent.futures import TimeoutError as FutureTimeout
    first_err, wedged = None, []
    for p, fut in pending:
        try:
            fut.result(None if deadline is None
                       else max(0.0, deadline - time.monotonic()))
        except (TimeoutError, FutureTimeout):
            wedged.append((p, fut))
        except Exception as e:  # noqa: BLE001 -- raised after the drain
            if first_err is None:
                first_err = e
    if wedged:
        _PENDING_SAVES.extend(pf for pf in wedged if not pf[1].done())
        stacks = "\n".join(f"--- {t.name} ---\n{_thread_stack(t)}"
                           for t in threading.enumerate()
                           if t.name.startswith("mpe3d-ckpt"))
        extra = (f"; additionally a drained save FAILED: {first_err!r}"
                 if first_err is not None else "")
        raise TimeoutError(
            f"async checkpoint save of {wedged[0][0]} did not commit within "
            f"{timeout:.0f}s{extra}; saver thread stack(s):\n{stacks}"
        ) from first_err
    if first_err is not None:
        raise first_err


# ---------------------------------------------------------------------------
# reading, and the meta
# ---------------------------------------------------------------------------


def checkpoint_exists(path: str) -> bool:
    """Whether a checkpoint of either backend is at ``path`` (a committed
    staging directory included)."""
    return (os.path.exists(path + ".npz") or os.path.isdir(path + ".orbax")
            or os.path.isdir(path + ".orbax.next"))


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's meta without its arrays.  A committed orbax staging
    directory is adopted first, and a sidecar older than its npz (a crash
    between the two renames) or than the meta in ``<path>.orbax/`` is
    rewritten from the embedded copy."""
    _finalize_orbax(path)
    npz, side = path + ".npz", path + ".json"
    if os.path.exists(npz) and (
            not os.path.exists(side)
            or os.path.getmtime(side) < os.path.getmtime(npz)):
        try:
            with np.load(npz) as data:
                if "__meta_json__" in data.files:
                    with open(side + ".tmp", "w") as f:
                        f.write(bytes(data["__meta_json__"]).decode())
                    os.replace(side + ".tmp", side)
        except (OSError, ValueError):
            pass        # an unreadable npz: fall through to the sidecar
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    return {}


def load_checkpoint(path: str, params_template, opt_state_template=None):
    """(params, opt_state or None, meta) of the checkpoint at ``path``
    (either backend), in the templates' structures
    (``mpe3d_tpu/train/checkpoint.py:738-789``): a leaf the checkpoint
    lacks or whose shape differs from the template's raises ValueError;
    optimizer leaves are read only when a template is given and the
    checkpoint holds them."""
    data, meta = open_checkpoint(path)

    def unflatten(template, prefix):
        out = []
        for i, t in enumerate(tree_leaves(template)):
            name = f"{prefix}.leaf_{i:05d}"
            if name not in data:
                raise ValueError(f"checkpoint {path} lacks template leaf "
                                 f"{name}")
            arr = data[name]
            if tuple(arr.shape) != tuple(np.shape(t)):
                raise ValueError(f"checkpoint leaf {name} shape "
                                 f"{tuple(arr.shape)} != template "
                                 f"{tuple(np.shape(t))}")
            out.append(arr)
        return unflatten_tree(template, out)

    params = unflatten(params_template, "p")
    opt_state = None
    if opt_state_template is not None and any(k.startswith("o.")
                                              for k in data):
        opt_state = unflatten(opt_state_template, "o")
    return params, opt_state, meta


def lifter_config_from_meta(meta: Dict[str, Any],
                            default: LifterConfig) -> LifterConfig:
    """The LifterConfig a checkpoint was trained with: the meta's fields
    (widths, residual_prior, ...) over ``default``."""
    return config_from_meta(LifterConfig, meta.get("lifter_config"),
                            default)


def matcher_config_from_meta(meta: Dict[str, Any],
                             default: MatcherConfig) -> MatcherConfig:
    """The MatcherConfig a checkpoint was trained with
    (``mpe3d_tpu/train/checkpoint.py:716-736``): the architecture the meta
    stores (hidden, heads, residual, bias, slopes, dropout rates) over
    ``default``; the JAX package's serving switches are dropped."""
    return config_from_meta(MatcherConfig, meta.get("matcher_config"),
                            default)


def read_optimizer_leaves(stem: str) -> Optional[List[Any]]:
    """The ``o.leaf_*`` arrays of the checkpoint at ``stem`` in order, or
    None when it holds no optimizer state."""
    data, _ = open_checkpoint(stem)
    leaves = _leaves(data, "o", stem)
    return leaves or None
