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
heals a sidecar older than its npz from the embedded copy.  Orbax
checkpoints are not in the port (ROADMAP.md section 1, item 8).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig, config_from_meta

ORBAX_REFUSED = ("orbax checkpoints are not in the PyTorch port (ROADMAP.md "
                 "section 1, item 8); use the npz backend")

_LIFTER_KEYS = ("b", "w")
_INT8_KEYS = ("b", "rscale", "scale", "wq")


def read_checkpoint(stem: str) -> Tuple[List[np.ndarray], Dict[str, Any]]:
    """The parameter leaves of ``<stem>.npz`` in flatten order, and the meta
    (embedded copy first, the sidecar where the npz has none)."""
    with np.load(stem + ".npz") as data:
        names = sorted(k for k in data.files if k.startswith("p.leaf_"))
        leaves = [data[k] for k in names]
        raw = data["__meta_json__"] if "__meta_json__" in data.files else None
    if [int(n[len("p.leaf_"):]) for n in names] != list(range(len(names))):
        raise ValueError(f"{stem}.npz: parameter leaves are not contiguous")
    if raw is not None:
        meta = json.loads(bytes(raw).decode())
    elif os.path.exists(stem + ".json"):
        with open(stem + ".json") as f:
            meta = json.load(f)
    else:
        meta = {}
    return leaves, meta


def bf16_from_bits(u16: np.ndarray) -> torch.Tensor:
    """bfloat16 tensor with the given uint16 bit patterns."""
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


def flatten_tree(tree) -> List[np.ndarray]:
    """A tree's leaves in ``jax.tree_util`` flatten order: dict keys
    sorted, lists, tuples and NamedTuples in order (a NamedTuple without
    fields, like optax's ``EmptyState``, has no leaves), None no leaf;
    every other value a leaf, as a numpy array."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_tree(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in flatten_tree(t)]
    if torch.is_tensor(tree):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


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


def save_checkpoint(path: str, params, opt_state=None,
                    meta: Optional[Dict[str, Any]] = None,
                    backend: str = "npz") -> None:
    """Write ``<path>.npz`` (parameters ``p.*``, optimizer leaves ``o.*``
    of ``opt_state`` when given, the meta) and the ``<path>.json``
    sidecar.  ``params`` / ``opt_state``: trees ``flatten_tree`` takes;
    dataclasses in ``meta`` are expanded.  The npz replaces the old one in
    one rename, so a crash leaves the old checkpoint or the new one."""
    if backend == "orbax":
        raise NotImplementedError(ORBAX_REFUSED)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend: {backend!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {f"p.leaf_{i:05d}": a
              for i, a in enumerate(flatten_tree(params))}
    arrays.update({f"o.leaf_{i:05d}": a
                   for i, a in enumerate(flatten_tree(opt_state))})
    meta_json = _meta_json(meta)
    arrays["__meta_json__"] = np.frombuffer(meta_json.encode(),
                                            dtype=np.uint8).copy()
    np.savez(path + ".npz.tmp.npz", **arrays)
    os.replace(path + ".npz.tmp.npz", path + ".npz")
    with open(path + ".json.tmp", "w") as f:
        f.write(meta_json)
    os.replace(path + ".json.tmp", path + ".json")


def checkpoint_exists(path: str) -> bool:
    """Whether a checkpoint of either package's backends is at ``path``
    (an orbax one is then refused where it is read)."""
    return (os.path.exists(path + ".npz") or os.path.isdir(path + ".orbax")
            or os.path.isdir(path + ".orbax.next"))


def read_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's meta without its arrays; a sidecar older than its
    npz (a crash between the two renames) is first rewritten from the
    copy embedded in the npz."""
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


def read_optimizer_leaves(stem: str) -> Optional[List[np.ndarray]]:
    """The ``o.leaf_*`` arrays of ``<stem>.npz`` in order, or None when the
    checkpoint holds no optimizer state."""
    with np.load(stem + ".npz") as data:
        names = sorted(k for k in data.files if k.startswith("o.leaf_"))
        return [data[k] for k in names] if names else None
