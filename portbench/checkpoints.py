"""A stored lifter's weights, read for the references in numpy and plain
torch: nothing of the program, so that a comparison on stored weights
also checks how the program loads them.

A checkpoint is ``<stem>.npz`` and its meta ``<stem>.json`` (a stem is
relative to the repository's root).  The npz holds the parameter leaves
``p.leaf_00000``, ``p.leaf_00001``, ... in the order a tree of dicts
flattens, keys sorted: layer by layer, a plain layer as ``b, w`` and an
int8 one as ``b, rscale, scale, wq``.  The meta's ``lifter_config``
holds the architecture (``in_dim``, ``out_dim``, ``widths``,
``negative_slope``, ``residual_prior``), ``prior`` the packing prior
("mean", "median", "irls") and ``stored`` the dtype of the weights:

* ``bf16``: every ``w`` as the uint16 bits of its bf16 values;
* ``int8``: every layer but the head int8 ``wq`` [K, N] with fp32 row
  scales ``rscale`` [K] and column scales ``scale`` [N]
  (``w ~ rscale[:, None] * wq * scale[None, :]``), the head fp32;
* ``fp32``: fp32 weights (a training checkpoint).

The layers come back as a served lifter runs them: an int8 layer as
``{"wq" int8, "rscale", "scale", "b" fp32}``, every other layer (the
head of an int8 lifter too) as ``{"w" bf16, "b" fp32}``, an fp32 weight
rounded to bf16 once, to nearest even."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.cell import ROOT

PLAIN = ("b", "w")
INT8 = ("b", "rscale", "scale", "wq")


def path(stem: str) -> str:
    """A stem relative to the repository's root (or absolute), as a
    path."""
    return os.path.join(ROOT, stem)


def meta(stem: str) -> Dict[str, Any]:
    """The lifter's meta: ``in_dim``, ``out_dim``, ``widths`` (a list),
    ``negative_slope``, ``residual_prior`` (False where not stored),
    ``prior`` ("mean" where not stored), ``stored`` ("fp32" where not
    stored)."""
    with open(path(stem) + ".json") as f:
        m = json.load(f)
    lc = m["lifter_config"]
    return {"in_dim": int(lc["in_dim"]), "out_dim": int(lc["out_dim"]),
            "widths": [int(w) for w in lc["widths"]],
            "negative_slope": float(lc["negative_slope"]),
            "residual_prior": bool(lc.get("residual_prior", False)),
            "prior": m.get("prior", "mean"),
            "stored": m.get("stored", "fp32")}


def _bf16(a: np.ndarray, stored: str) -> torch.Tensor:
    if stored == "bf16":
        return torch.from_numpy(
            np.ascontiguousarray(a, np.uint16).view(np.int16)
        ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def lifter(stem: str, device="cpu"
           ) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Any]]:
    """The layers (module header) on ``device``, and ``meta(stem)``."""
    m = meta(stem)
    with np.load(path(stem) + ".npz") as data:
        names = sorted(k for k in data.files if k.startswith("p.leaf_"))
        leaves = [data[k] for k in names]
    if [int(n[7:]) for n in names] != list(range(len(names))):
        raise ValueError(f"{stem}: the p.leaf_* leaves are not contiguous")
    d = [m["in_dim"], *m["widths"], m["out_dim"]]
    dims = list(zip(d[:-1], d[1:]))
    keys = ([INT8] * (len(dims) - 1) + [PLAIN] if m["stored"] == "int8"
            else [PLAIN] * len(dims))
    if len(leaves) != sum(map(len, keys)):
        raise ValueError(f"{stem}: {len(leaves)} leaves, its meta's "
                         f"layers take {sum(map(len, keys))}")
    dev = torch.device(device)
    layers, i = [], 0
    for (k, n), ks in zip(dims, keys):
        raw = dict(zip(ks, leaves[i:i + len(ks)]))
        i += len(ks)
        want = {"b": (n,), "w": (k, n), "wq": (k, n), "rscale": (k,),
                "scale": (n,)}
        for key, a in raw.items():
            if tuple(a.shape) != want[key]:
                raise ValueError(f"{stem}: layer {len(layers)} {key} "
                                 f"{tuple(a.shape)}, expected {want[key]}")
        if "wq" in raw:
            if raw["wq"].dtype != np.int8:
                raise ValueError(f"{stem}: int8 layer of {raw['wq'].dtype}")
            layer = {"wq": torch.from_numpy(raw["wq"])}
            layer.update({key: torch.from_numpy(np.asarray(raw[key],
                                                           np.float32))
                          for key in ("rscale", "scale", "b")})
        else:
            layer = {"w": _bf16(raw["w"], m["stored"]),
                     "b": torch.from_numpy(np.asarray(raw["b"], np.float32))}
        layers.append({key: t.to(dev) for key, t in layer.items()})
    return layers, m
