"""The reader of ``lifter_rows_per_launch.batch`` on a fake stretch: the
program's ``lifter.rows`` counter over its ``lifter.launches`` counter,
and None when the program records no launches (a program without the
counter, or a stretch without a lifter launch)."""

import pytest

from portbench.cell import reader
from portbench.tests.test_portbench_graph_replay import _ctx


def test_rows_over_launches(monkeypatch):
    # 4 batches of 4 chunks of 250 rows, one launch a chunk
    ctx = _ctx(monkeypatch, {"batch.replay": 4, "lifter.rows": 4000,
                             "lifter.launches": 16})
    assert reader("lifter_rows_per_launch.batch")(ctx) == pytest.approx(250.0)


def test_groups_of_64_rows(monkeypatch):
    ctx = _ctx(monkeypatch, {"lifter.rows": 4000, "lifter.launches": 64})
    assert reader("lifter_rows_per_launch.batch")(ctx) == pytest.approx(62.5)


@pytest.mark.parametrize("counters", [
    {"batch.replay": 4, "lifter.rows": 4000},
    {"lifter.rows": 4000, "lifter.launches": 0},
    {"lifter.launches": 16},
    {}])
def test_nothing_to_read_without_both_counters(monkeypatch, counters):
    ctx = _ctx(monkeypatch, counters)
    assert reader("lifter_rows_per_launch.batch")(ctx) is None
