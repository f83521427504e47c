"""BENCHMARK.json holds to the benchmark's contract, and everything it
names is found by name in files of its own."""

import json
import os
import re

import pytest

from portbench.cell import HERE, ROOT, load, manifest, reader
from portbench.tests.queued import entries, manifest_with

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_and_names():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    names = [c["name"] for c in man["configs"]]
    cells = [w["name"] for w in man["workloads"]]
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert set(names) == {w["config"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m["workloads"]:
            assert w in cells
            cell = load(w, man)
            assert m["moves"] in [e["name"] for e in cell.end_to_end]


def test_every_cell_is_found_by_name():
    man = manifest()
    for w in man["workloads"]:
        cell = load(w["name"], man)
        assert os.path.exists(os.path.join(HERE, "loops",
                                           cell.kind + ".py"))
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in man["per_layer"]:
        assert callable(reader(m["name"]))


def test_configs_hold_the_published_widths():
    for name, m_in, l_in in (("panoptic", 902, 1260), ("arplab", 1082, 1512)):
        with open(os.path.join(HERE, "configs", name + ".json")) as f:
            cfg = json.load(f)
        assert cfg["matcher"]["in_dim"] == m_in
        assert cfg["matcher"]["hidden"] == [40, 40, 40, 30]
        assert cfg["matcher"]["heads"] == [10, 10, 8, 5]
        assert cfg["lifter"]["in_dim"] == l_in
        assert cfg["lifter"]["widths"] == [3072, 3072, 2048, 2048, 1024,
                                           1024, 1024, 1024]
        assert cfg["lifter"]["out_dim"] == 54


@pytest.mark.parametrize("workload", sorted(
    f[:-5] for f in os.listdir(os.path.join(HERE, "queued"))))
def test_queued_cells_are_complete(workload):
    """A queued cell's entries (``portbench/queued/``) hold to the
    contract but for the bounds, which its measurement sets, and name
    nothing BENCHMARK.json names."""
    more = entries(workload)
    assert set(more) <= {"workloads", "end_to_end", "per_layer"}
    man = manifest_with(workload)
    for key in ("workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[key]]
        assert len(names) == len(set(names)) and all(NAME.match(n)
                                                     for n in names)
    (w,) = more["workloads"]
    assert w["name"] == workload and w["chips"] == 1 and _line(w["why"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in more["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "source", "workloads"}
        assert m["workloads"] == [workload]
        assert UNIT.match(m["unit"]) and m["source"] == "host_clock"
    cell = load(workload, man)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.limits
    for m in more["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"] == [workload] and m["moves"] in e2e
        assert callable(reader(m["name"])) and _line(m["layer"])
