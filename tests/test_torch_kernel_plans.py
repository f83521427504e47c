"""The tile plans of the port's redesigned kernels, on the CPU.

* The fused GAT projection (``ops/fused_proj.py::proj_plan``): every output
  element of both GEMMs is owned by exactly one tile, each tile's k-splits
  cover k exactly once, and small GEMMs split k to fill the card's SMs.
* The per-layer GEMM plans of the GAT stack kernel and of K1 of the tiled
  kernels (``ops/fused_proj.py::layer_plans``, on the rows each GEMM has:
  H + 1 at layer 0 when the shared edge row is projected once): every
  output tile owned once, k-splits of 1 to 8 that partition k, and at S=4
  every GEMM fills at least 100 of the 132 SMs unless it already splits k
  as far as 8 splits and its stages allow.
* The lifter run (``ops/fused_mlp.py::plan_run``), bf16 and mixed with
  int8 layers (the int8 demo lifters, a narrow ragged net): every (layer,
  64-column slab, K-chunk) tile is owned by exactly one block, the chunks
  of a slab cover its rows once, a bf16-only net keeps the plan it had
  before int8 layers joined the run, the device tables lay partials,
  counters, activations and the int8 layers' scales out without overlap,
  the launch plan groups bf16 and int8 layers into one run, and the int8
  weights' fragment order is a bijection the kernel's byte formula reads
  back.  A plain emulation that walks the plan (fp32 partials of exact
  products of bf16 operands, summed in chunk order as the kernel sums
  them; the int8 fold, fragment read and scales) is held to
  ``fused_mlp_plain`` within 1e-5 x max|out| per layer, and to the JAX
  ``apply_lifter`` within the net tolerances of
  ``tests/test_torch_pack_mlp.py`` (1e-5 on a narrow bf16 net, 1e-3
  decameters on the 29.1 M-param trained lifters: bf16 operand flips
  cascade through their 9 layers) and, for the narrow mixed net, to the
  TPU kernel in interpret mode and ``apply_lifter`` within the mixed-net
  tolerance of ``tests/test_torch_quant.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.lifting.pack import pack_lifter_input as j_pack
from mpe3d_tpu.models.mlp import apply_lifter
from mpe3d_tpu.train.checkpoint import load_lifter_checkpoint as j_load
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig
from mpe3d_tpu_torch.ops import fused_mlp as fm
from mpe3d_tpu_torch.ops import fused_proj as fp

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
GAT_WIDTHS = ((902, 400), (400, 400), (400, 320), (320, 150), (150, 1))
SERVING = ((1260, 3072), (3072, 3072), (3072, 2048), (2048, 2048),
           (2048, 1024), (1024, 1024), (1024, 1024), (1024, 1024),
           (1024, 64))
# a narrow net whose slabs are ragged (widths not multiples of 64) and
# whose input width is not a multiple of 16
NARROW = ((70, 48), (48, 80), (80, 48), (48, 16))
N_BLOCKS = 132
SIZE = (1920.0, 1080.0)


# ---- the projection -----------------------------------------------------

@pytest.mark.parametrize("N", [180, 2640, 1, 37])
def test_proj_plan_covers_outputs(N):
    """At the real widths both GEMMs of every layer: each output element in
    one tile, each tile's k-splits a partition of [0, K); a GEMM with fewer
    tiles than SMs splits k until it fills the card or runs out of
    stages."""
    for D, F in GAT_WIDTHS:
        plan = fp.proj_plan(N, D, F, N_BLOCKS)
        for g, (rows, cols, K) in ((plan.fc1, (N, D, D)),
                                   (plan.fc2, (N, F, D))):
            assert (g.M, g.N, g.K) == (rows, cols, K)
            owner = np.zeros((rows, cols), np.int64)
            ks = {}
            for r0, c0, k0, k1 in g.block_work():
                assert r0 % fp.TILE_M == 0 and c0 % fp.TILE_N == 0
                assert k0 % fp.TILE_K == 0 and k0 < k1 <= K
                ks.setdefault((r0, c0), []).append((k0, k1))
            for (r0, c0), ranges in ks.items():
                ranges = sorted(ranges)
                assert len(ranges) == g.splits
                assert ranges[0][0] == 0 and ranges[-1][1] == K
                assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
                owner[r0:r0 + fp.TILE_M, c0:c0 + fp.TILE_N] += 1
            np.testing.assert_array_equal(owner, 1)
            ksteps = -(-K // fp.TILE_K)
            assert 1 <= g.splits <= min(fp.MAX_SPLITS, ksteps)


def test_proj_plan_fills_the_card():
    """At S=4 (180 rows) a GEMM splits k over up to 8 blocks of a cluster to
    fill the card: the 902- and 400-wide GEMMs, most of the work, launch at
    least 132 blocks, the narrower ones (15 tiles or fewer) at least 120 or
    one block a k-stage; at S=16 (2640 rows) the GEMMs of 210 tiles or more
    fill the card unsplit and the narrow end splits."""
    for D, F in GAT_WIDTHS:
        plan = fp.proj_plan(180, D, F, N_BLOCKS)
        for g in (plan.fc1, plan.fc2):
            ksteps = -(-g.K // fp.TILE_K)
            if g.tiles >= 21:
                assert g.blocks >= N_BLOCKS, (D, F, g)
            else:
                assert (g.blocks >= 120
                        or g.splits == min(ksteps, fp.MAX_SPLITS)), g
    for D, F in GAT_WIDTHS:
        plan = fp.proj_plan(2640, D, F, N_BLOCKS)
        for g in (plan.fc1, plan.fc2):
            assert g.splits == 1 if g.tiles >= 210 else g.blocks > g.tiles


def test_proj_cpu_entry_any_width():
    """The entry takes widths past the old 1024 cap (the tiled kernel
    stages no whole rows) and serves CPU tensors with the plain version."""
    rng = np.random.default_rng(1)
    x, w1, b1, w2, b2 = (torch.tensor(rng.normal(size=s) / 40,
                                      dtype=torch.float32)
                         for s in ((5, 1100), (1100, 1100), (1100,),
                                   (1100, 7), (7,)))
    got = fp.fused_linear_leaky_linear(x, w1, b1, w2, b2, 0.2)
    exact = fp.proj_plain(*(t.double() for t in (x, w1, b1, w2, b2)), 0.2)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-5)
    assert not hasattr(fp, "MAX_D")


# ---- the GAT stack and K1: one plan a layer -------------------------------

# (cameras, slots, matcher in_dim): Panoptic buckets and the ARPLAB 6 x 16
GAT_SHAPES = [(5, 2, 902), (5, 4, 902), (5, 10, 902), (5, 16, 902),
              (6, 16, 1082)]


def _gat_sizes(C, S, in_dim):
    dims = MatcherConfig(in_dim=in_dim).layer_dims()
    return C * S, C * (C - 1) // 2 * S * S, dims


@pytest.mark.parametrize("edge_const", [False, True])
@pytest.mark.parametrize("C, S, in_dim", GAT_SHAPES,
                         ids=[f"{c}x{s}" for c, s, _ in GAT_SHAPES])
def test_gat_layer_plans_cover_tiles(C, S, in_dim, edge_const):
    """Each layer's fc1 [rows, d_in] and fc2 [rows, F] GEMMs on the rows the
    layer projects: every 64 x 64 output tile owned by exactly ``splits``
    blocks whose k-ranges partition [0, K), 1 <= splits <= 8."""
    H, E, dims = _gat_sizes(C, S, in_dim)
    plans = fp.layer_plans(H, E, dims, edge_const, N_BLOCKS)
    assert len(plans) == len(dims)
    for l, ((d_in, d, nh), plan) in enumerate(zip(dims, plans)):
        rows = H + 1 if edge_const and l == 0 else H + E
        for g, shape in ((plan.fc1, (rows, d_in, d_in)),
                         (plan.fc2, (rows, nh * d, d_in))):
            assert (g.M, g.N, g.K) == shape
            assert 1 <= g.splits <= fp.MAX_SPLITS
            ks = {}
            for r0, c0, k0, k1 in g.block_work():
                ks.setdefault((r0, c0), []).append((k0, k1))
            grid = {(r, c) for r in range(0, g.M, fp.TILE_M)
                    for c in range(0, g.N, fp.TILE_N)}
            assert set(ks) == grid and g.blocks == len(grid) * g.splits
            for ranges in ks.values():
                ranges = sorted(ranges)
                assert len(ranges) == g.splits
                assert ranges[0][0] == 0 and ranges[-1][1] == g.K
                assert all(a[1] == b[0] and a[0] < a[1]
                           for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("edge_const", [False, True])
def test_gat_layer_plans_fill_the_card_at_s4(edge_const):
    """At S=4 (H=20, E=160) every GEMM of every layer launches blocks on at
    least 100 of the 132 SMs, or splits k as far as it can (8 splits, or
    one a 32-k stage): with 64 x 64 tiles no plan of at most 8 splits does
    more for the narrow ends (layer 0's fc2 on 21 rows: 7 tiles; layer 3's
    fc2 and layer 4: 9 or 3 tiles of 5-10 stages).  The wide GEMMs, fc1 of
    layers 0-3 and fc2 of layers 1-2, fill at least 100."""
    H, E, dims = _gat_sizes(5, 4, 902)
    plans = fp.layer_plans(H, E, dims, edge_const, N_BLOCKS)
    for l, plan in enumerate(plans):
        for g in (plan.fc1, plan.fc2):
            cap = min(fp.MAX_SPLITS, -(-g.K // fp.TILE_K))
            assert min(g.blocks, N_BLOCKS) >= 100 or g.splits == cap, (l, g)
        if l < 4:
            assert plan.fc1.blocks >= 100, (l, plan.fc1)
        if l in (1, 2):
            assert plan.fc2.blocks >= 100, (l, plan.fc2)
    # the shared edge row: layer 0 projects 21 rows instead of 180
    assert plans[0].fc1.M == (H + 1 if edge_const else H + E)


# ---- the lifter run -----------------------------------------------------

def _check_cover(plan, shapes, M):
    """Every (layer, slab, chunk) tile of ``plan`` owned once; a slab's
    chunks cover its rows [0, ceil(K/16) 16) once; a block's tiles in layer
    order, at most MAX_LAYER_TILES a layer, chunks of at most KC_MAX rows."""
    assert len(plan.blocks) == N_BLOCKS and plan.M == M
    seen = {}
    for tiles in plan.blocks:
        assert len(tiles) <= fm.MAX_BLOCK_TILES
        layers = [t.layer for t in tiles]
        assert layers == sorted(layers)
        for l in set(layers):
            assert layers.count(l) <= fm.MAX_LAYER_TILES
        for t in tiles:
            assert (t.layer, t.slab, t.chunk) not in seen
            seen[t.layer, t.slab, t.chunk] = t
            assert 0 < t.r1 - t.r0 <= fm.KC_MAX and t.r0 % fm.KBLOCK == 0
    for l, ((K, N), lay) in enumerate(zip(shapes, plan.layers)):
        assert (lay.K, lay.N, lay.n_slabs) == (K, N, -(-N // fm.SLAB))
        for j in range(lay.n_slabs):
            rows = [(seen[l, j, c].r0, seen[l, j, c].r1)
                    for c in range(lay.splits)]
            assert rows[0][0] == 0 and rows[-1][1] == -(-K // 16) * 16
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert len(seen) == sum(lay.n_slabs * lay.splits for lay in plan.layers)


def _block_bytes(plan, shapes, int8):
    """Weight bytes each block streams (a row of a 64-column slab: 128 bytes
    of bf16, 64 of int8; rows past K not counted)."""
    return [sum((min(t.r1, shapes[t.layer][0]) - t.r0)
                * (1 if int8[t.layer] else 2) * fm.SLAB for t in b)
            for b in plan.blocks]


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("shapes", [SERVING, NARROW],
                         ids=["serving", "narrow"])
def test_lifter_plan_covers_tiles(shapes, M):
    """Every (layer, slab, chunk) tile owned once; a slab's chunks cover
    its rows [0, ceil(K/16) 16) once; a block's tiles in layer order,
    at most MAX_LAYER_TILES a layer, chunks of at most KC_MAX rows; on the
    serving widths no block streams more than 1.1 x the mean bytes."""
    plan = fm.plan_run(shapes, M, N_BLOCKS)
    _check_cover(plan, shapes, M)
    if shapes is SERVING:
        per_block = _block_bytes(plan, shapes, [False] * len(shapes))
        mean = 2 * sum(K * N for K, N in shapes) / N_BLOCKS
        assert max(per_block) <= 1.1 * mean
        # the wide layers split K so that their tiles fill the grid
        assert all(lay.n_slabs * lay.splits >= 120 for lay in plan.layers[:8])


# digests of the bf16 plans before int8 layers joined the run: the split
# counts and a hash of every block's tile list, at 132 and at 7 blocks
BF16_PLANS = {
    ("serving", 132): ([5, 8, 4, 4, 8, 8, 8, 8, 8], "fcf9e6dabbb77c21"),
    ("serving", 7): ([2, 3, 3, 3, 3, 3, 3, 3, 6], "42c88b5ccaf4eae5"),
    ("narrow", 132): ([2, 1, 2, 1], "1255cb894d033309"),
    ("narrow", 7): ([2, 1, 2, 1], "768bd5524c273c37"),
}


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("net, n_blocks", list(BF16_PLANS))
def test_bf16_plan_unchanged(net, n_blocks, M):
    """A bf16-only net gets exactly the plan it had before the run kernel
    took int8 layers (weight bytes are balanced by the same costs, doubled
    for bf16 rows), with and without the explicit all-bf16 kinds."""
    import hashlib
    shapes = {"serving": SERVING, "narrow": NARROW}[net]
    splits, digest = BF16_PLANS[net, n_blocks]
    for plan in (fm.plan_run(shapes, M, n_blocks),
                 fm.plan_run(shapes, M, n_blocks, [False] * len(shapes))):
        assert [lay.splits for lay in plan.layers] == splits
        assert not any(lay.int8 for lay in plan.layers)
        tiles = repr([[tuple(t) for t in b] for b in plan.blocks])
        assert hashlib.sha256(tiles.encode()).hexdigest()[:16] == digest


PAN_COMPACT = ((1260, 1536), (1536, 1536), (1536, 1024), (1024, 1024),
               (1024, 512), (512, 512), (512, 512), (512, 512), (512, 64))
# a narrow mixed net: int8 -> int8 -> bf16 -> int8 -> bf16, ragged slabs,
# K = 70 at the input (the int8 fragments pad it to 80 rows)
NARROW_MIXED = ((70, 48), (48, 80), (80, 48), (48, 32), (32, 16))
NARROW_KINDS = (True, True, False, True, False)
MIXED_NETS = {"pan_irls": (SERVING, (True,) * 8 + (False,)),
              "pan_compact": (PAN_COMPACT, (True,) * 8 + (False,)),
              "narrow": (NARROW_MIXED, NARROW_KINDS)}


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("net", list(MIXED_NETS))
def test_mixed_plan_covers_tiles(net, M):
    """Mixed int8 + bf16 runs (the int8 demo lifters, a narrow ragged net):
    every tile owned once, chunks covering each slab's rows once; the plan
    marks the int8 layers; in each layer of the demo lifters no block
    streams more than one tile or 1.25 x the layer's mean weight bytes,
    whichever is more (a layer's blocks wait for each other at its grid
    barrier)."""
    shapes, int8 = MIXED_NETS[net]
    plan = fm.plan_run(shapes, M, N_BLOCKS, int8)
    _check_cover(plan, shapes, M)
    assert tuple(lay.int8 for lay in plan.layers) == int8
    if net != "narrow":
        for l, ((K, N), q) in enumerate(zip(shapes, int8)):
            layer_plan = plan._replace(blocks=tuple(
                tuple(t for t in b if t.layer == l) for b in plan.blocks))
            per_block = _block_bytes(layer_plan, shapes, int8)
            tile = max(t.r1 - t.r0 for b in layer_plan.blocks for t in b)
            mean = K * N * (1 if q else 2) / N_BLOCKS
            assert max(per_block) <= max(tile * fm.SLAB * (1 if q else 2),
                                         1.25 * mean)


def frag_matrix(wq):
    """The weight matrix the kernel reads from fragment-ordered int8
    weights [slabs, k-blocks, 1024], by the kernel's byte formula: byte
    p 512 + 16 lane + 8 ml + 2 r + h of k-block kb of slab s is register r
    of lane's m16n8k16 A fragment of m-tile 2 p + ml (the transposed
    product: weight columns are A rows), half h: the weight at row
    16 kb + 8 (r // 2) + 2 (lane % 4) + h and column
    64 s + 32 p + 16 ml + 8 (r % 2) + lane // 4.  Returns (the fp32 matrix
    [16 k-blocks, 64 slabs], the flat matrix index of each fragment
    byte)."""
    ns, nkb, _ = wq.shape
    i = np.arange(fm.FRAG_BYTES)
    p, lane, ml, r, h = i // 512, i // 16 % 32, i // 8 % 2, i // 2 % 4, i % 2
    k = 8 * (r // 2) + 2 * (lane % 4) + h
    n = 32 * p + 16 * ml + 8 * (r % 2) + lane // 4
    S, KB = np.meshgrid(np.arange(ns), np.arange(nkb), indexing="ij")
    rows = 16 * KB[..., None] + k
    cols = 64 * S[..., None] + n
    out = np.zeros((16 * nkb, 64 * ns), np.float32)
    out[rows, cols] = wq.numpy().astype(np.float32)
    return torch.from_numpy(out), rows * out.shape[1] + cols


@pytest.mark.parametrize("K, N", [(70, 100), (1260, 3072), (48, 16)])
def test_int8_fragments_bijection(K, N):
    """The packing's permutation of int8 weights into fragment order is a
    bijection onto the padded matrix (every fragment byte one weight, every
    weight one byte), the kernel's byte formula reads the matrix back with
    zeros in the padding, and ``int8_rows`` undoes it."""
    w = torch.tensor(np.random.default_rng(K + N).integers(
        -127, 128, (K, N)), dtype=torch.int8)
    wq = fm.int8_fragments(w)
    assert wq.shape == (-(-N // 64), -(-K // 16), fm.FRAG_BYTES)
    got, index = frag_matrix(wq)
    assert np.array_equal(np.sort(index.ravel()), np.arange(got.numel()))
    assert torch.equal(got[:K, :N], w.float())
    assert not got[K:].any() and not got[:, N:].any()
    assert torch.equal(fm.int8_rows(wq).float(), got)


def _mixed_layers(shapes, int8, seed):
    """Packed layers of a numpy-seeded mixed net (int8 layers with weights,
    column and row scales, bf16 ones), and its JAX tree: the same numbers,
    the bf16 weights as bf16."""
    rng = np.random.default_rng(seed)
    layers, jlayers, k_in = [], [], shapes[0][0]
    for (K, N), q in zip(shapes, int8):
        b = rng.uniform(-0.1, 0.1, N).astype(np.float32)
        if q:
            wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
            scale = (rng.uniform(0.5, 1.5, N) / 127 / K ** 0.5).astype(
                np.float32)
            rscale = rng.uniform(0.5, 2.0, K).astype(np.float32)
            layers.append(fm.pack_int8_layer(
                torch.from_numpy(wq), torch.from_numpy(scale),
                torch.from_numpy(rscale), torch.from_numpy(b), k_in))
            jlayers.append({"wq": jnp.asarray(wq), "scale": jnp.asarray(scale),
                            "rscale": jnp.asarray(rscale),
                            "b": jnp.asarray(b)})
        else:
            w = torch.tensor(rng.uniform(-1, 1, (K, N)) / K ** 0.5,
                             dtype=torch.bfloat16)
            layers.append(fm.pack_layer(w, torch.from_numpy(b), k_in))
            jlayers.append({"w": jnp.asarray(w.float().numpy()).astype(
                jnp.bfloat16), "b": jnp.asarray(b)})
        k_in = layers[-1].b.shape[0]
    return layers, {"layers": jlayers}


@pytest.mark.parametrize("M", [1, 8, 16])
def test_mixed_run_tables(M):
    """A mixed run's layer rows: the int8 flag, the column scales and the
    layer's own row scales on int8 layers, and each layer's pointer to the
    next layer's row scales exactly where that layer is int8."""
    plan = fm.plan_run(NARROW_MIXED, M, 7, NARROW_KINDS)
    ptrs = [(1000 + 16 * i, 2000 + 16 * i, 3000 + 16 * i, 4000 + 16 * i)
            for i in range(len(NARROW_MIXED))]
    tab = fm.run_tables(plan, ptrs, [True] * 4 + [False], "cpu")
    for i, (row, q) in enumerate(zip(tab.layers.tolist(), NARROW_KINDS)):
        nxt = i + 1 < len(ptrs) and NARROW_KINDS[i + 1]
        assert row[:2] == list(ptrs[i][:2])
        assert row[7:] == [int(q), ptrs[i][2] if q else 0,
                           ptrs[i][3] if q else 0,
                           ptrs[i + 1][3] if nxt else 0, 0]


@pytest.mark.parametrize("M", [1, 8, 16])
def test_lifter_run_tables(M):
    """The device tables of a plan (built here on the CPU): layer rows chain
    activations, partial blocks and slab counters do not overlap, every
    tile row matches its plan tile, and the workspace holds them all."""
    plan = fm.plan_run(NARROW, M, 7)
    ptrs = [(1000 + 16 * i, 2000 + 16 * i, 0, 0) for i in range(len(NARROW))]
    acts = [True, True, True, False]
    tab = fm.run_tables(plan, ptrs, acts, "cpu")
    lay = tab.layers.tolist()
    assert [r[:5] for r in lay] == [[w, b, K, N, int(a)] for (w, b, _, _),
                                    (K, N), a in zip(ptrs, NARROW, acts)]
    assert all(r[7:] == [0] * 5 for r in lay)
    assert lay[0][5] == -1 and lay[-1][6] == -1
    for prev, cur in zip(lay, lay[1:]):
        assert cur[5] == prev[6] >= 0
    out_ends = [r[6] + M * r[3] for r in lay[:-1]]
    assert all(a <= b[6] for a, b in zip(out_ends, lay[1:-1]))
    assert tab.acts_offset + 2 * out_ends[-1] <= tab.parts_offset
    tiles = tab.tiles.tolist()
    flat = [t for b in plan.blocks for t in b]
    assert len(tiles) == len(flat)
    assert tab.block_tiles.tolist() == list(np.cumsum(
        [0] + [len(b) for b in plan.blocks]))
    parts, counters = set(), {}
    for row, t in zip(tiles, flat):
        layer, n0, r0, r1, part, cnt, nsplit, pbase = row
        assert (layer, n0, r0, r1) == (t.layer, t.slab * fm.SLAB, t.r0, t.r1)
        assert nsplit == plan.layers[t.layer].splits
        if nsplit == 1:
            assert part == -1
            continue
        assert part == pbase + t.chunk * M * fm.SLAB
        assert part not in parts and part + M * fm.SLAB <= (
            tab.ws_bytes - tab.parts_offset) // 4
        parts.add(part)
        assert counters.setdefault((t.layer, t.slab), cnt) == cnt
        assert len(NARROW) <= cnt < tab.n_sync
    assert len(set(counters.values())) == len(counters)
    assert tab.n_sync == len(NARROW) + len(counters)


def _kinds(*names):
    kind = {"b": fm.Bf16Layer, "i": fm.Int8Layer, "f": fm.Fp32Layer}
    return [kind[n](*([None] * len(kind[n]._fields))) for n in names]


@pytest.mark.parametrize("names, steps", [
    ("bbbbbbbbb", [("run", 0, 9)]),
    ("iiiiiiiib", [("run", 0, 9)]),
    ("fff", [("fp32", 0, 1), ("fp32", 1, 2), ("fp32", 2, 3)]),
    ("bbiibfb", [("run", 0, 5), ("fp32", 5, 6), ("run", 6, 7)]),
])
def test_launch_plan_mixed(names, steps):
    """Consecutive bf16 and int8 layers form one run (one launch); fp32
    layers are steps of their own: a bf16 lifter is 1 launch, and so is an
    int8 lifter (8 int8 layers and a bf16 head)."""
    assert fm.launch_plan(_kinds(*names)) == steps


def emulate_run(x, layers, slope, acts, plan):
    """The run as the kernel computes it on ``plan``: per tile the fp32 sum
    of exact products of bf16-rounded operands over its rows (zero past K),
    a split slab's partials summed in chunk order, then (int8) the column
    scales, bias and LeakyReLU; between layers only the bf16 operand of the
    next layer.  An int8 layer's operand is its fp32 input times its row
    scales, rounded to bf16 (folded where the kernel stages the run's x, by
    the producing layer otherwise), its weights read from the fragment
    layout by the kernel's byte formula (``frag_matrix``).  Returns each
    layer's fp32 output."""
    h = x.float()
    outs = []
    for l, (layer, act) in enumerate(zip(layers, acts)):
        lay = plan.layers[l]
        int8 = isinstance(layer, fm.Int8Layer)
        assert lay.int8 == int8
        K, N = fm.layer_shape(layer)
        if int8:
            wp = frag_matrix(layer.wq)[0]
            op = (h * layer.rscale).to(torch.bfloat16).float()
        else:
            pad = 16 * -(-K // 16) - K
            wp = torch.nn.functional.pad(layer.w.float(), (0, 0, 0, pad))
            op = h.to(torch.bfloat16).float()
        hp = torch.nn.functional.pad(op, (0, wp.shape[0] - K))
        part = {}
        for tiles in plan.blocks:
            for t in tiles:
                if t.layer == l:
                    c0 = t.slab * fm.SLAB
                    part[t.slab, t.chunk] = (hp[:, t.r0:t.r1]
                                             @ wp[t.r0:t.r1, c0:c0 + fm.SLAB])
        y = torch.cat([_chunk_sum(part, j, lay.splits)
                       for j in range(lay.n_slabs)], 1)[:, :N]
        if int8:
            y = y * layer.scale
        y = y + layer.b
        y = torch.where(y >= 0, y, slope * y) if act else y
        outs.append(y)
        h = y
    return outs


def _chunk_sum(part, slab, splits):
    s = part[slab, 0]
    for c in range(1, splits):
        s = s + part[slab, c]
    return s


def _check_layers(x, layers, acts, outs):
    """Each emulated layer within 1e-5 x max|out| of its plain version
    (``fused_mlp.layer_plain``) on the same input."""
    h = x
    for layer, act, got in zip(layers, acts, outs):
        ref = fm.layer_plain(h, layer, 0.1, act)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol
        h = got


def _packed(shapes, seed):
    """Packed bf16 layers of a numpy-seeded net with these padded shapes."""
    rng = np.random.default_rng(seed)
    return [fm.Bf16Layer(torch.tensor(rng.uniform(-1, 1, s) / s[0] ** 0.5,
                                      dtype=torch.bfloat16),
                         torch.tensor(rng.uniform(-0.1, 0.1, s[1]),
                                      dtype=torch.float32))
            for s in shapes]


@pytest.mark.parametrize("M", [1, 8, 16])
def test_emulated_plan_matches_plain_narrow(M):
    """The plan's emulation on a narrow net with ragged slabs and K = 70:
    each layer within 1e-5 x max|out| of ``mlp_layer_plain`` on the same
    input, the whole net equal in shape and within 1e-5 of
    ``fused_mlp_plain``, and within 1e-5 of the JAX ``apply_lifter`` in
    bf16."""
    layers = _packed(NARROW, 11)
    acts = [True, True, True, False]
    x = torch.tensor(np.random.default_rng(M).normal(size=(M, 70)),
                     dtype=torch.float32)
    plan = fm.plan_run(NARROW, M, N_BLOCKS)
    outs = emulate_run(x, layers, 0.1, acts, plan)
    h = x
    _check_layers(x, layers, acts, outs)
    net = fm.fused_mlp_plain(x, layers, 0.1, 16)
    np.testing.assert_allclose(outs[-1].numpy(), net.numpy(), atol=1e-5)
    jparams = {"layers": [{"w": jnp.asarray(w.float().numpy()).astype(
        jnp.bfloat16), "b": jnp.asarray(b.numpy())} for w, b in layers]}
    jcfg = JLifterConfig(in_dim=70, out_dim=16, widths=(48, 80, 48),
                         negative_slope=0.1)
    ref = np.asarray(apply_lifter(jparams, jnp.asarray(x.numpy()), jcfg,
                                  compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(outs[-1].numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def trained_lifter():
    """The trained 29.1 M-param bf16 lifter of ``pan_irls_bf16`` (JAX
    tree, config, port lifter) and 16 lifter inputs packed by the JAX
    package from synthetic frames (slots of 4 frames at S=4, its prior),
    the inputs the 1e-3 net tolerance was set on."""
    jparams, jcfg, prior = j_load(os.path.join(DEMO, "pan_irls_bf16",
                                               "pose_estimator"),
                                  JLifterConfig())
    lifter = weights.lifter_from_tree(
        jparams, LifterConfig(residual_prior=jcfg.residual_prior), "cpu")
    jr = j_ring(J_PANOPTIC)
    obs = []
    for f in j_generate(J_PANOPTIC, jr, 4, n_people=(3, 4), seed=5):
        fa = j_parse(f, J_PANOPTIC, 4)
        obs += [(fa.kp[:, s], fa.valid[:, s], fa.prob[:, s],
                 fa.in_view[:, s]) for s in range(4)]
    stacked = [jnp.asarray(np.stack(a)) for a in zip(*obs)]
    pack = jax.vmap(lambda k, v, p, o: j_pack(k, v, p, o, jr, SIZE,
                                               prior=prior)[0])
    x = np.array(pack(*stacked), dtype=np.float32)
    assert x.shape == (16, 1260)
    return jparams, jcfg, lifter, x


@pytest.mark.parametrize("M", [1, 8, 16])
def test_emulated_plan_matches_plain_serving(trained_lifter, M):
    """The serving plan's emulation on the trained lifter: each layer within
    1e-5 x max|out| of ``mlp_layer_plain`` on the same input; the whole net
    within 1e-3 decameters of the JAX ``apply_lifter`` in bf16."""
    jparams, jcfg, lifter, x = trained_lifter
    layers = lifter.packed_layers()
    assert fm.launch_plan(layers) == [("run", 0, 9)]
    acts = [i < 8 for i in range(9)]
    plan = fm.plan_run([tuple(w.shape) for w, _ in layers], M, N_BLOCKS)
    xt = torch.from_numpy(x[:M])
    outs = emulate_run(xt, layers, 0.1, acts, plan)
    _check_layers(xt, layers, acts, outs)
    got = outs[-1][:, :54]
    if jcfg.residual_prior:
        from mpe3d_tpu_torch.models.mlp import extract_prior
        got = got + extract_prior(xt, lifter.cfg)
    ref = np.asarray(apply_lifter(jparams, jnp.asarray(x[:M]), jcfg,
                                  compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("M", [1, 8, 16])
def test_emulated_mixed_matches_plain_narrow(M):
    """The plan's emulation on the narrow mixed net (int8 -> int8 -> bf16
    -> int8 -> bf16, ragged slabs, K = 70): each layer within 1e-5 x
    max|out| of its plain version on the same input, the whole net within
    1e-5 of ``fused_mlp_plain``, and within 1e-4 x max(1, max|out|) (the
    mixed-net tolerance of ``tests/test_torch_quant.py``) of the TPU
    whole-network kernel in interpret mode and of ``apply_lifter`` on the
    same int8 / bf16 tree."""
    from mpe3d_tpu.ops.fused_mlp import fused_mlp_forward, pack_fused_layers
    layers, jtree = _mixed_layers(NARROW_MIXED, NARROW_KINDS, 21)
    acts = [True] * 4 + [False]
    x = torch.tensor(np.random.default_rng(M).normal(size=(M, 70)),
                     dtype=torch.float32)
    assert fm.launch_plan(layers) == [("run", 0, 5)]
    plan = fm.plan_run([fm.layer_shape(layer) for layer in layers], M,
                       N_BLOCKS, NARROW_KINDS)
    outs = emulate_run(x, layers, 0.1, acts, plan)
    _check_layers(x, layers, acts, outs)
    net = fm.fused_mlp_plain(x, layers, 0.1, 16)
    np.testing.assert_allclose(outs[-1].numpy(), net.numpy(), atol=1e-5)
    flat, kinds, dims = pack_fused_layers(jtree["layers"])
    assert kinds == ("q", "q", "w", "q", "w")
    jcfg = JLifterConfig(in_dim=70, out_dim=16, widths=(48, 80, 48, 32),
                         negative_slope=0.1)
    xj = jnp.asarray(x.numpy())
    for ref in (fused_mlp_forward(xj, flat, kinds, dims, 0.1, 16,
                                  interpret=True),
                apply_lifter(jtree, xj, jcfg, compute_dtype=jnp.bfloat16)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(outs[-1].numpy(), ref,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("model", ["pan_irls", "pan_compact"])
def test_emulated_plan_matches_plain_int8_serving(trained_lifter, model):
    """The plan's emulation on the int8 demo lifters (8 int8 layers and a
    bf16 head, one run) at M=8 on the trained lifter's inputs: each layer
    within 1e-5 x max|out| of its plain version; the whole net within 1e-3
    decameters of the JAX ``apply_lifter`` on the same export."""
    x = trained_lifter[3][:8]
    jparams, jcfg, _ = j_load(os.path.join(DEMO, model, "pose_estimator"),
                              JLifterConfig())
    lifter = weights.lifter_from_tree(
        jparams, LifterConfig(widths=jcfg.widths,
                              residual_prior=jcfg.residual_prior), "cpu")
    layers = lifter.packed_layers()
    int8 = [isinstance(layer, fm.Int8Layer) for layer in layers]
    assert int8 == [True] * 8 + [False]
    assert fm.launch_plan(layers) == [("run", 0, 9)]
    acts = [i < 8 for i in range(9)]
    plan = fm.plan_run([fm.layer_shape(layer) for layer in layers], 8,
                       N_BLOCKS, int8)
    xt = torch.from_numpy(x)
    outs = emulate_run(xt, layers, 0.1, acts, plan)
    _check_layers(xt, layers, acts, outs)
    got = outs[-1][:, :54]
    if jcfg.residual_prior:
        from mpe3d_tpu_torch.models.mlp import extract_prior
        got = got + extract_prior(xt, lifter.cfg)
    ref = np.asarray(apply_lifter(jparams, jnp.asarray(x), jcfg,
                                  compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_run_entry_dispatch():
    """The run entry takes the plain version for CPU tensors (equal to
    ``run_plain``, no launch counted) and refuses other devices."""
    layers = _packed(NARROW, 3)
    x = torch.tensor(np.random.default_rng(2).normal(size=(5, 70)),
                     dtype=torch.float32)
    acts = [True, True, True, False]
    before = fm.mlp_run.launches
    torch.testing.assert_close(fm.run_layers(x, layers, 0.1, acts),
                               fm.run_plain(x, layers, 0.1, acts),
                               rtol=0, atol=0)
    assert fm.mlp_run.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fm.run_layers(x.to("meta"), layers, 0.1, acts)
    with pytest.raises(ValueError, match="serves 1..64 rows"):
        fm.plan_run(NARROW, 65, N_BLOCKS)
