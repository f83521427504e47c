"""Cells that are built but not in BENCHMARK.json yet: each
``portbench/queued/<workload>.json`` holds the manifest entries that
adding it takes (its workload, its own end-to-end and per-layer
metrics, bounds left to the measurement).  The tests run such a cell
through the manifest with its entries added."""

import json
import os

from portbench.cell import HERE, Cell, load, manifest

QUEUED = os.path.join(HERE, "queued")


def entries(workload: str) -> dict:
    with open(os.path.join(QUEUED, workload + ".json")) as f:
        return json.load(f)


def manifest_with(workload: str) -> dict:
    man = manifest()
    for key, more in entries(workload).items():
        man[key] = man[key] + more
    return man


def load_any(workload: str) -> Cell:
    """A cell of BENCHMARK.json, or a queued one."""
    if os.path.exists(os.path.join(QUEUED, workload + ".json")):
        return load(workload, manifest_with(workload))
    return load(workload)
