"""A cell of the benchmark: one ``workloads`` entry of BENCHMARK.json with
its configuration, traffic mix, per-layer metrics and comparison limits,
each found by name in files of its own:

* ``configs/<config>.json``: the configuration's sizes (the manifest's
  ``file``);
* ``traffic/<traffic>.json``: the mix, whose ``kind`` names the general
  loop that reads it and runs the cell (``loops/<kind>.py``);
* ``metrics/<metric>.py``: one reader a per-layer metric;
* ``limits/<workload>.json``: the limit of each number the cell's
  comparison checks."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def manifest(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> Dict[str, Any]:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    loop: Any = None        # the loop module of its kind (``loop``)

    def __post_init__(self):
        if self.loop is None:
            self.loop = loop(self.kind)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load(workload: str, man: Optional[Dict[str, Any]] = None) -> Cell:
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, config, _json("traffic", entry["traffic"] + ".json"),
                _json("limits", workload + ".json"), entry["chips"],
                [m for m in man["end_to_end"] if mine(m)],
                [m for m in man["per_layer"] if mine(m)])


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(kind: str):
    """The loop module of a traffic kind, ``loops/<kind>.py``."""
    return importlib.import_module("portbench.loops." + kind)
