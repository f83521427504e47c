"""The batch path's CUDA graph policy (``pipeline._BatchGraphs``) on the
CPU, with a stand-in for the graph injected into a pipeline's cache.

The stand-in captures by running the body once (as a capture issues it
from the host) and replays by running it again with the program's spans
and counters off (a replay issues nothing from the host), copying the
results into the static outputs it returned at the capture.  With it the
policy runs on the CPU: a key's first batch runs eagerly, its second is
captured and replayed, later ones replay; the key follows the frame count
and every setting the body bakes in; at most ``MAX_BATCH_GRAPHS`` keys are
kept, least recently used out; ``reload_weights`` empties the cache; a
CPU pipeline, the eager body and the frame path never capture; a body
that will not capture runs eagerly from then on; the tracer's
``batch.replay``, ``batch.capture`` and ``lifter.rows`` count what the
policy did, and ``lifter.launches`` the run launches of a stand-in run
kernel (eagerly, at the capture and, from the capture's count, on a
replay); and every output equals a pipeline's without graphs.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch import pipeline as pl
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.utils import trace

import torch_testing  # noqa: F401

NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.05,
                   camera_dropout=0.05)
N = 3                       # frames a batch


class FakeGraph:
    """Stands in for ``pipeline._CudaGraph`` (module header)."""

    def __init__(self, stream):
        assert stream is None           # no side stream on the CPU
        self.body, self.out, self.replays = None, None, 0

    def capture(self, body):
        self.body = body
        self.out = body()
        return self.out

    def replay(self):
        self.replays += 1
        with mock.patch.object(trace, "span", lambda *a, **k: trace._OFF), \
                mock.patch.object(trace, "count", lambda *a, **k: None):
            for dst, src in zip(self.out, self.body()):
                dst.copy_(src)


class BrokenGraph(FakeGraph):
    """A graph whose capture fails, as a launch that will not capture."""

    def capture(self, body):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


@pytest.fixture(scope="module")
def trees():
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8,),
                         heads=(2,))
    lcfg = LifterConfig(widths=(64,))
    return (mcfg, weights.random_matcher_tree(mcfg, 0),
            weights.random_matcher_tree(mcfg, 5), lcfg,
            weights.random_lifter_tree(lcfg, 1))


@pytest.fixture(scope="module")
def frames():
    wire = generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), 4 * N,
                           n_people=(2, 3), seed=11, noise=NOISE)
    return [parse_frame(w, PANOPTIC, 4) for w in wire]


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _pipe(trees, graph=FakeGraph, union=True, matcher=1, **kw):
    mcfg, m1, m2, lcfg, ltree = trees
    pipe = pl.PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(m1 if matcher == 1 else m2, mcfg, "cpu"),
        weights.lifter_from_tree(ltree, lcfg, "cpu"), slot_buckets=(4,),
        person_buckets=(8,), use_frame_kernel=True if union else None,
        device="cpu", **{**dict(threshold=0.05, decode_top_k=0), **kw})
    if graph is not None:
        pipe._graphs = pl._BatchGraphs(graph, pipe.device)
    return pipe


def _batch(pipe, fas, pad_to=None):
    """(outputs, ticket) of one batch."""
    ticket = pipe.submit_batch(fas, slots=4, pad_to=pad_to)
    return pipe.collect_batch(ticket), ticket


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip((g.poses, g.persons, g.scores, g.quality),
                        (w.poses, w.persons, w.scores, w.quality)):
            np.testing.assert_array_equal(a, b)
        assert g.n_heads == w.n_heads


def _states(pipe):
    return [s if isinstance(s, str) else "graph"
            for s in pipe._graphs.entries.values()]


def test_first_sight_eager_second_captures_third_replays(trees, frames):
    pipe, plain = _pipe(trees), _pipe(trees, graph=None)
    batches = [frames[i * N:(i + 1) * N] for i in range(4)]
    tickets, persons = [], 0
    for b in batches:
        got, ticket = _batch(pipe, b)
        _assert_same(got, _batch(plain, b)[0])
        tickets.append(ticket)
        persons += sum(len(o.persons) for o in got)
    assert persons >= 4
    graph = pipe._graphs.entries[pipe._graph_key(4, N)]
    assert isinstance(graph, pl._Graph)
    # eager, then the capture and its replay, then two replays
    assert tickets[0][3] is None
    assert all(t[3] is graph for t in tickets[1:])
    assert graph.graph.replays == 3
    assert _states(pipe) == ["graph"] and not _states(plain)
    # the static input is the packed upload's one buffer, reused
    assert graph.input.dtype == torch.uint8 and graph.input.dim() == 1


def test_pad_to_micro_batch_is_its_own_key(trees, frames):
    pipe, plain = _pipe(trees), _pipe(trees, graph=None)
    for _ in range(3):
        got, ticket = _batch(pipe, frames[:2], pad_to=4)
        _assert_same(got, _batch(plain, frames[:2], pad_to=4)[0])
    assert ticket[3] is pipe._graphs.entries[pipe._graph_key(4, 4)]
    _batch(pipe, frames[:2])                 # n = 2: a first sight
    assert _states(pipe) == ["graph", "seen"]


@pytest.mark.parametrize("name, value", [("threshold", 0.2),
                                         ("decode_top_k", 4),
                                         ("lifter_prior", "median"),
                                         ("prior_gate_px", 40.0)])
def test_key_follows_every_baked_setting(trees, frames, name, value):
    pipe = _pipe(trees)
    b = frames[:N]
    for _ in range(2):
        _batch(pipe, b)
    old = pipe._graph_key(4, N)
    setattr(pipe, name, value)
    assert pipe._graph_key(4, N) != old
    got, ticket = _batch(pipe, b)
    assert ticket[3] is None                 # no stale replay: eager
    _assert_same(got, _batch(_pipe(trees, graph=None, **{name: value}),
                             b)[0])
    assert _states(pipe) == ["graph", "seen"]


def test_key_follows_the_frame_count(trees):
    pipe = _pipe(trees)
    keys = [pipe._graph_key(4, n) for n in (1, 2, 3)]
    assert [k[:2] for k in keys] == [(4, 1), (4, 2), (4, 3)]
    assert len(set(keys)) == 3


def test_lru_bound_holds():
    cache = pl._BatchGraphs(FakeGraph, torch.device("cpu"))
    M = pl.MAX_BATCH_GRAPHS
    for k in range(M + 3):
        assert cache.look((k,)) is None
        assert cache.look((k,)) == pl._SEEN
        cache.capture((k,), torch.empty(1), lambda: (torch.zeros(1),), ())
        assert isinstance(cache.look((k,)), pl._Graph)
        assert len(cache.entries) <= M
    assert list(cache.entries) == [(k,) for k in range(3, M + 3)]
    cache.look((3,))                         # used: now the most recent
    cache.look((M + 3,))                     # a new key evicts (4,)
    assert (4,) not in cache.entries and (3,) in cache.entries
    assert len(cache.entries) == M
    assert cache.look((0,)) is None          # evicted: a first sight again


def test_lru_bound_holds_on_the_pipeline(trees, frames, monkeypatch):
    monkeypatch.setattr(pl, "MAX_BATCH_GRAPHS", 2)
    pipe = _pipe(trees)
    for n in (4, 5, 6):
        for _ in range(2):
            _batch(pipe, frames[:2], pad_to=n)
    assert list(pipe._graphs.entries) == [pipe._graph_key(4, n)
                                          for n in (5, 6)]
    got, ticket = _batch(pipe, frames[:2], pad_to=4)
    assert ticket[3] is None                 # evicted: eager again
    _assert_same(got, _batch(_pipe(trees, graph=None), frames[:2],
                             pad_to=4)[0])


def test_reload_weights_empties_the_cache(trees, frames):
    mcfg, _, m2, _, _ = trees
    pipe = _pipe(trees)
    b = frames[:N]
    for _ in range(3):
        _batch(pipe, b)
    held = _batch(pipe, b)[1][3]
    assert isinstance(held, pl._Graph)
    pipe.reload_weights(matcher_tree=m2)
    assert not pipe._graphs.entries
    other = _pipe(trees, graph=None, matcher=2)
    for i in range(3):                       # eager, capture, replay
        got, ticket = _batch(pipe, b)
        _assert_same(got, _batch(other, b)[0])
        assert (ticket[3] is None) == (i == 0)
    assert ticket[3] is not held


def test_cpu_and_eager_body_never_capture(trees, frames):
    plain = _pipe(trees, graph=None)         # a CPU pipeline as built
    assert plain._graphs.graph_type is None
    eager = _pipe(trees, union=False)        # the eager body, graphs on
    assert not eager.batch_plan(4, N).union
    for pipe in (plain, eager):
        for _ in range(3):
            assert _batch(pipe, frames[:N])[1][3] is None
        assert not pipe._graphs.entries
    # the frame path shares the body, not the cache
    union = _pipe(trees)
    for f in frames[:3]:
        union.infer_fused(f)
    assert not union._graphs.entries


def test_a_body_that_will_not_capture_runs_eagerly(trees, frames, capsys):
    pipe, plain = _pipe(trees, graph=BrokenGraph), _pipe(trees, graph=None)
    for i in range(4):
        b = frames[i * N:(i + 1) * N]
        got, ticket = _batch(pipe, b)
        _assert_same(got, _batch(plain, b)[0])
        assert ticket[3] is None
    assert _states(pipe) == ["eager"]
    assert capsys.readouterr().err.count("did not capture") == 1


def test_replicas_keep_their_own_caches(trees):
    pipe = _pipe(trees)
    assert pipe.enable_multi_device_serving(["cpu", "cpu"]) == 2
    caches = {id(r._graphs) for r in pipe._replicas} | {id(pipe._graphs)}
    assert len(caches) == 3


def test_tracer_counts_what_the_policy_did(trees, frames):
    pipe = _pipe(trees)
    P = pipe._p_max(4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):                   # eager, capture, 2 replays
            _batch(pipe, frames[i * N:(i + 1) * N])
    snap = trace.snapshot()
    assert snap.counters == {"batch.capture": 1, "batch.replay": 3,
                             "lifter.rows": 4 * N * P}
    spans = snap.spans
    roots = [i for i, s in enumerate(spans) if s.name == "batch.submit"]
    mine = [[s.name for s in spans if s.parent == r
             and not s.name.startswith("chunk.")] for r in roots]
    chunk = ["chunk.features", "chunk.gat", "chunk.decode", "chunk.lifter",
             "chunk.quality"]
    # the chunks' spans nest in the body's _run_frames; a replay has none
    inner = [[s.name for j, s in enumerate(spans)
              if s.name.startswith("chunk.") and _root(spans, j) == r]
             for r in roots]
    assert inner == [chunk, chunk, [], []]
    assert mine[0] == ["batch.pack", "batch.download"]
    for names in mine[1:]:
        assert names == ["batch.pack", "batch.replay", "batch.download"]


def test_tracer_counts_the_lifter_launches(trees, frames, monkeypatch):
    """With a stand-in for the run kernel (the plain run, a launch counted
    for each of its row groups, as ``run_layers`` launches on a card)
    ``lifter.launches`` counts a batch's launches on every batch: from
    ``Lifter.forward`` eagerly and at the capture, on a replay the graph's
    as its capture counted them; rows over launches is a chunk's rows (its
    frames times the person slots: one launch a chunk)."""
    from mpe3d_tpu_torch.ops import fused_mlp as fm

    def run(x, layers, slope, acts):
        fm.mlp_run.launches += len(fm.row_groups(x.shape[0]))
        return fm.run_plain(x, layers, slope, acts)

    monkeypatch.setattr(fm, "run_layers", run)
    pipe = _pipe(trees)
    P = pipe._p_max(4)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(4):                   # eager, capture, 2 replays
            _batch(pipe, frames[i * N:(i + 1) * N])
    counters = trace.snapshot().counters
    chunks = pipe.batch_plan(4, N).chunks
    per_batch = sum(len(fm.row_groups(m * P)) for m in chunks)
    assert per_batch == len(chunks)
    assert counters["lifter.launches"] == 4 * per_batch
    assert counters["lifter.rows"] == 4 * N * P
    assert counters["batch.replay"] == 3
    graphs = [e for e in pipe._graphs.entries.values()
              if isinstance(e, pl._Graph)]
    assert [g.lifter_launches for g in graphs] == [per_batch]


def _root(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


def test_nothing_counted_without_a_profiler(trees, frames):
    pipe = _pipe(trees)
    for _ in range(3):
        _batch(pipe, frames[:N])
    assert trace.snapshot().counters == {}


def test_kernel_state_lists_the_caches_graphs_read():
    from mpe3d_tpu_torch.ops import fused_mlp, gat_tiled
    with mock.patch.dict(fused_mlp._RUNS, {"a": 1}, clear=True), \
            mock.patch.dict(gat_tiled._PLANS, {"b": 2}, clear=True):
        assert pl._kernel_state() == (1, 2)
