"""The tiled GAT's incidence list and its K2 with the head max inside, on
the CPU.

* An emulation of the incidence build (``tiled_incidence`` in
  ``csrc/gat_tiled.cu``: 32 warps, each walking a segment of the entries
  32 a step; per-(head, segment) counts scanned across the segments and
  the heads, then the placement walk, lanes of one head grouped by
  ``same_head_lanes``, a ballot per bit of the head)
  gives exactly the order of
  ``torch.argsort(head * 2E + ent, stable=True)`` and ``incidence_plain``,
  on the Panoptic S=10/16 and ARPLAB 6 x 16 topologies, E=9, E=4096 and
  E=5184 (past the steps the build keeps in registers), compacted edge
  sets in any order, heads of degree 0 and of degree past 256 (the K2
  block's staging chunk) up to 2E.
* ``k1_plain`` + ``k2_plain`` (the masked head max now computed in K2)
  against one layer of the JAX tiled stack (``_k1_layer``'s m1/m2, the max
  combine, ``_k2_layer`` and the epilogue) in interpret mode: 2e-5, the
  reference's gate between its tiled and XLA forms (fp32 both sides, head
  sums in another order).
* The plain tiled stack on a pruned, compacted topology (the trained
  matcher at full width) against JAX ``apply_matcher_tiled`` in interpret
  mode: scores within 2e-5.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.ops import gat_tiled as jtiled
from mpe3d_tpu.ops.gat_kernel import gat_layer_arrays
from mpe3d_tpu.ops.tiles import round_up
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
from mpe3d_tpu_torch.config import PANOPTIC, MatcherConfig
from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
from mpe3d_tpu_torch.matching import features as tfeat
from mpe3d_tpu_torch.models import gat as tgat
from mpe3d_tpu_torch.ops import gat_tiled
from mpe3d_tpu_torch.ops.gat_kernel import GatTopology, layer_views

TILED_TOL = 2e-5
DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")

# the incidence build's launch shape, shared tables and the bits of a head
# index + 1 its lane grouping compares (csrc/gat_tiled.cu)
INC_THREADS, WARP, MAX_HEADS, HEAD_BITS = 1024, 32, gat_tiled.MAX_HEADS, 10


def emulate_incidence(e1, e2, H):
    """``tiled_incidence`` step by step: (head_ptr [H+1], head_ent [2E])."""
    e1, e2 = np.asarray(e1, np.int64), np.asarray(e2, np.int64)
    n_ent = 2 * len(e1)
    ent = np.arange(n_ent)
    heads = np.where(ent & 1, e2[ent >> 1], e1[ent >> 1])
    heads = np.where((heads >= 0) & (heads < H), heads, -1)
    steps = -(-n_ent // INC_THREADS)
    n_warps = INC_THREADS // WARP

    def step(w, st):
        """(entries, heads) of warp w's lanes at step st of its segment."""
        e = w * steps * WARP + st * WARP + np.arange(WARP)
        return e, np.where(e < n_ent, heads[np.minimum(e, n_ent - 1)], -1)

    bits = int(H).bit_length()                       # 32 - __clz(H)
    assert bits <= HEAD_BITS

    def groups(h):
        """Per lane: its rank among the step's lanes of its head and
        whether it is the group's first (``same_head_lanes``: the lanes
        that agree with it on every bit of h + 1 below ``bits``)."""
        v = h + 1
        assert v.max() < 1 << bits
        peers = np.ones((WARP, WARP), bool)
        for b in range(bits):
            bit = (v >> b) & 1
            peers &= bit[:, None] == bit[None, :]
        rank = np.array([peers[lane, :lane].sum() for lane in range(WARP)])
        return rank, rank == 0

    wc = np.zeros((MAX_HEADS, n_warps), np.int64)   # [head][segment]
    for w in range(n_warps):                         # pass 1: atomic counts
        for st in range(steps):
            _, h = step(w, st)
            np.add.at(wc[:, w], h[h >= 0], 1)
    assert wc.max() < 1 << 16                        # 16-bit halves
    tot = wc.sum(1)
    wc = np.cumsum(wc, 1) - wc                       # across the segments
    per = MAX_HEADS // WARP                          # across the heads
    c = np.where(np.arange(MAX_HEADS) < H, tot, 0).reshape(WARP, per)
    run = np.cumsum(c.sum(1)) - c.sum(1)
    ptr = (run[:, None] + np.cumsum(c, 1) - c).reshape(-1)
    head_ptr = np.append(ptr[:H], c.sum())
    head_ent = np.full(n_ent, -1, np.int64)
    for w in range(n_warps):                         # pass 2
        for st in range(steps):
            e, h = step(w, st)
            rank, first = groups(h)
            for lane in np.nonzero(h >= 0)[0]:
                head_ent[ptr[h[lane]] + wc[h[lane], w] + rank[lane]] = e[lane]
            for lane in np.nonzero((h >= 0) & first)[0]:
                wc[h[lane], w] += (h == h[lane]).sum()
            assert wc.max() < 1 << 16                # unsigned short
    return head_ptr, head_ent


def _hand_made(H, E, seed, empty, busy, busy_deg):
    """A compacted edge set: random endpoints, head ``empty`` in no edge,
    head ``busy`` in ``busy_deg`` edges (as either endpoint)."""
    rng = np.random.default_rng(seed)
    others = np.array([h for h in range(H) if h not in (empty, busy)])
    e1, e2 = rng.choice(others, E), rng.choice(others, E)
    hit = rng.choice(E, busy_deg, replace=False)
    side = rng.random(busy_deg) < 0.5
    e1[hit[side]], e2[hit[~side]] = busy, busy
    return e1, e2


def _topology_case(name):
    if name.startswith("topology"):
        C, S = map(int, name.split("_")[1:])
        topo = tfeat.build_topology(C, S)
        return np.asarray(topo.e1), np.asarray(topo.e2), topo.n_heads
    if name == "compacted_permuted":
        # a pruned S=16 set: a random subset in rank order, not edge order
        topo = tfeat.build_topology(5, 16)
        idx = np.random.default_rng(4).permutation(topo.n_pairs)[:1280]
        return np.asarray(topo.e1)[idx], np.asarray(topo.e2)[idx], 80
    if name == "zero_and_300":
        return _hand_made(80, 1200, 5, empty=3, busy=7, busy_deg=300) + (80,)
    if name == "degree_2E":
        return np.full(700, 5), np.full(700, 5), 10
    if name == "max_heads":
        e1, e2 = _hand_made(MAX_HEADS, 3000, 6, empty=0, busy=MAX_HEADS - 1,
                            busy_deg=600)
        return e1, e2, MAX_HEADS
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "topology_2_3", "topology_5_10", "topology_5_16", "topology_6_16",
    "topology_2_64", "topology_2_72", "compacted_permuted", "zero_and_300",
    "degree_2E", "max_heads"])
def test_incidence_order_matches_stable_argsort(name):
    e1, e2, H = _topology_case(name)
    E = len(e1)
    te1, te2 = torch.tensor(e1), torch.tensor(e2)
    heads = torch.stack([te1, te2], 1).reshape(-1)
    ent = torch.arange(2 * E)
    want = ent[torch.argsort(heads * 2 * E + ent, stable=True)]
    ptr, got = emulate_incidence(e1, e2, H)
    np.testing.assert_array_equal(got, want.numpy())
    deg = np.bincount(heads.numpy(), minlength=H)
    np.testing.assert_array_equal(np.diff(ptr), deg)
    pptr, pent = gat_tiled.incidence_plain(te1.int(), te2.int(), H)
    assert pptr.dtype == pent.dtype == torch.int32
    np.testing.assert_array_equal(pptr.numpy(), ptr)
    np.testing.assert_array_equal(pent.numpy(), got)
    if name in ("zero_and_300", "max_heads"):
        assert deg.min() == 0 and deg.max() > 256
    if name == "degree_2E":
        assert deg.max() == 2 * E


# ---------------------------------------------------------------------------
# K2 with the head max inside, against one layer of the JAX tiled stack
# ---------------------------------------------------------------------------

def _jax_layer(x_all, pw, e1, e2, H, arrays, nh, alpha, slope, const):
    """One layer (not the last) of ``mpe3d_tpu/ops/gat_tiled.py::
    gat_stack_tiled`` (:326-361): the head-side projection, ``_k1_layer``
    (its per-block head max m1/m2), the max combine, ``_k2_layer``, the
    epilogue; the next activations [H+E, F] (heads, then edges)."""
    E = x_all.shape[0] - H
    B = jtiled._pick_block(E, H)
    pad = round_up(E, B) - E
    onehot = lambda e: np.eye(H, dtype=np.float32)[e]   # noqa: E731

    def pad_rows(a):
        a = jnp.asarray(a)
        return jnp.concatenate([a, jnp.zeros((pad, a.shape[1]), a.dtype)])

    i1, i2 = pad_rows(onehot(e1)), pad_rows(onehot(e2))
    pwp = pad_rows(np.asarray(pw, np.float32).reshape(E, 1))
    xh, xe = jnp.asarray(x_all[:H]), pad_rows(x_all[H:])
    w1, b1, w2, b2, alf, arf, seg, rep = (jnp.asarray(a) for a in arrays)
    mm = jtiled._mm
    zh = mm(jtiled._leaky(mm(xh, w1) + b1, alpha), w2) + b2
    a1h, a2h = mm(zh * alf, seg), mm(zh * arf, seg)
    out_e, z_e, l1m, l2m, m1, m2 = jtiled._k1_layer(
        xe[:1] if const else xe, pwp, i1, i2, zh, a1h, a2h, w1, b1, w2, b2,
        alf, arf, seg, rep, alpha=alpha, nh=nh, B=B, interpret=True,
        const_proj=const)
    ls = jtiled._leaky(a1h + a2h, alpha)
    m = jnp.maximum(ls, jnp.maximum(m1.T, m2.T))
    den, num = jtiled._k2_layer(l1m, l2m, pwp, i1, i2, i1.T, i2.T, z_e, m,
                                rep, B=B, interpret=True, const_ze=const)
    es = jnp.exp(ls - m)
    out_h = (mm(es, rep) * zh + num) / mm(es + den, rep)
    return np.concatenate([np.asarray(jtiled._leaky(out_h, slope)),
                           np.asarray(jtiled._leaky(out_e, slope))[:E]])


def _narrow_case(name, d_in):
    if name == "panoptic_3_4":
        topo = tfeat.build_topology(3, 4)
        return np.asarray(topo.e1), np.asarray(topo.e2), topo.n_heads
    # H=20, E=400: head 3 in no edge, head 7 in 300 (past K2's chunk)
    return _hand_made(20, 400, 8, empty=3, busy=7, busy_deg=300) + (20,)


@pytest.mark.parametrize("name", ["panoptic_3_4", "zero_and_300"])
@pytest.mark.parametrize("edge_const", [False, True])
def test_k2_plain_head_max_against_pallas_interpret(name, edge_const):
    """Layers 0 and 1 of a narrow random matcher (d_in 20, 3 x 6 and
    2 x 6 heads x features): the port's K1 + K2 plain versions, the head
    max inside K2, against the JAX layer in interpret mode; some pairs
    dead.  Layer 1 takes the JAX layer 0's output as its input."""
    d_in = 20
    cfg = MatcherConfig(in_dim=d_in, hidden=(6, 6), heads=(3, 2))
    tree = weights.random_matcher_tree(cfg, 4)
    e1, e2, H = _narrow_case(name, d_in)
    E = len(e1)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(H + E, d_in)).astype(np.float32)
    if edge_const:
        x[H:] = tfeat.edge_node_features(E, d_in).numpy()
    pw = (rng.random(E) < 0.8).astype(np.float32)
    jcfg = JMatcherConfig(in_dim=d_in, hidden=(6, 6), heads=(3, 2),
                          alpha=cfg.alpha, hidden_slope=cfg.hidden_slope)
    arrays = gat_layer_arrays(jax.tree_util.tree_map(jnp.asarray, tree),
                              jcfg)
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    views = layer_views(m.flat, m.dims)
    te1, te2 = torch.tensor(e1), torch.tensor(e2)
    for l in range(2):
        const = edge_const and l == 0
        _, d, nh = m.dims[l]
        ref = _jax_layer(x, pw, e1, e2, H, arrays[l], nh, cfg.alpha,
                         cfg.hidden_slope, const)
        xe, state = gat_tiled.k1_plain(
            torch.tensor(x), torch.tensor(pw), te1, te2, H, views[l], nh, d,
            cfg.alpha, cfg.hidden_slope, False, const)
        assert len(state) == 5          # K1 no longer gives the head max
        xh = gat_tiled.k2_plain(state, torch.tensor(pw), te1, te2, H, nh, d,
                                cfg.alpha, cfg.hidden_slope, const)
        got = torch.cat([xh, xe]).numpy()
        np.testing.assert_allclose(got, ref, atol=TILED_TOL)
        x = ref


# ---------------------------------------------------------------------------
# the plain tiled stack on a pruned, compacted topology
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pruned_s8():
    """A synthetic Panoptic frame of 5-7 people at S=8 (H=40, E=640),
    pruned at 0.2 m to at most 320 pairs by the port's gate: the heads'
    features, the compacted endpoints (in rank order) and pair weights."""
    jr = j_ring(J_PANOPTIC)
    f = j_generate(J_PANOPTIC, jr, 1, n_people=(5, 7), seed=21)[0]
    fa = j_parse(f, J_PANOPTIC, 8)
    jtopo = jfeat.build_topology(5, 8)
    hf, _ = jfeat.head_features(fa.kp, fa.valid, fa.prob, fa.in_view,
                                fa.present, jr, (1920.0, 1080.0))
    pm = np.asarray(jfeat.pair_mask_from_present(jnp.asarray(fa.present),
                                                 jtopo))
    kp = torch.tensor(fa.kp[:, :8].astype(np.float32))
    shared = torch.tensor((fa.valid[:, :8] * fa.in_view[:, :8])
                          .astype(np.float32))
    rig = synthetic_ring_rig(PANOPTIC).select(
        PANOPTIC.matching_camera_indices()).to("cpu")
    ttopo = tfeat.build_topology(5, 8)
    idx, w = tfeat.prune_pair_candidates(kp, shared, rig, ttopo,
                                         torch.tensor(pm), 0.2, 320)
    idx = idx.numpy()
    e1, e2 = np.asarray(ttopo.e1)[idx], np.asarray(ttopo.e2)[idx]
    assert (w.numpy() > 0).sum() > 50 and not np.all(np.diff(idx) > 0)
    return np.asarray(hf), e1, e2, w.numpy()


@pytest.mark.parametrize("edge_const", [False, True])
def test_pruned_tiled_stack_against_pallas_interpret(pruned_s8, edge_const):
    """The trained pan_irls_bf16 matcher at full width on the compacted
    pairs: port ``apply_matcher_tiled`` against JAX's in interpret mode
    (its 0/1 incidence built from the compacted endpoints)."""
    hf, e1, e2, w = pruned_s8
    H, E = hf.shape[0], len(e1)
    tree, cfg = load_matcher_checkpoint(
        os.path.join(DEMO, "skeleton_matching"), MatcherConfig())
    ef = tfeat.edge_node_features(E, cfg.in_dim).numpy()
    jcfg = JMatcherConfig(in_dim=cfg.in_dim, hidden=cfg.hidden,
                          heads=cfg.heads, alpha=cfg.alpha,
                          hidden_slope=cfg.hidden_slope)
    onehot = np.eye(H, dtype=np.float32)
    jtopo = SimpleNamespace(inc1=onehot[e1], inc2=onehot[e2])
    ref = jtiled.apply_matcher_tiled(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(hf), ef,
        jtopo, jnp.asarray(w), jcfg, interpret=True, edge_const=edge_const)
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    gtopo = GatTopology(torch.tensor(e1, dtype=torch.int32),
                        torch.tensor(e2, dtype=torch.int32), H)
    got = tgat.apply_matcher_tiled(m, torch.tensor(hf), torch.tensor(ef),
                                   gtopo, torch.tensor(w), edge_const)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TILED_TOL)
