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
* The bf16 lifter run (``ops/fused_mlp.py::plan_bf16_run``): every (layer,
  64-column slab, K-chunk) tile is owned by exactly one block, the chunks
  of a slab cover its rows once, the device tables lay partials, counters
  and activations out without overlap, and the launch plan groups mixed
  layer lists into runs.  A plain emulation that walks the plan (fp32
  partials of exact bf16 products, summed in chunk order as the kernel
  sums them) is held to ``fused_mlp_plain`` within 1e-5 x max|out| per
  layer, and to the JAX ``apply_lifter(..., compute_dtype=bfloat16)``
  within the net tolerances of ``tests/test_torch_pack_mlp.py`` (1e-5 on a
  narrow net, 1e-3 decameters on the 29.1 M-param trained lifter: bf16
  operand flips cascade through its 9 layers).
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

@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("shapes", [SERVING, NARROW],
                         ids=["serving", "narrow"])
def test_lifter_plan_covers_tiles(shapes, M):
    """Every (layer, slab, chunk) tile owned once; a slab's chunks cover
    its rows [0, ceil(K/16) 16) once; a block's tiles in layer order,
    at most MAX_LAYER_TILES a layer, chunks of at most KC_MAX rows; on the
    serving widths no block streams more than 1.1 x the mean bytes."""
    plan = fm.plan_bf16_run(shapes, M, N_BLOCKS)
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
    if shapes is SERVING:
        per_block = [sum((min(t.r1, shapes[t.layer][0]) - t.r0) for t in b)
                     for b in plan.blocks]
        mean = sum(K * N for K, N in shapes) / fm.SLAB / N_BLOCKS
        assert max(per_block) <= 1.1 * mean
        # the wide layers split K so that their tiles fill the grid
        assert all(lay.n_slabs * lay.splits >= 120 for lay in plan.layers[:8])


@pytest.mark.parametrize("M", [1, 8, 16])
def test_lifter_run_tables(M):
    """The device tables of a plan (built here on the CPU): layer rows chain
    activations, partial blocks and slab counters do not overlap, every
    tile row matches its plan tile, and the workspace holds them all."""
    plan = fm.plan_bf16_run(NARROW, M, 7)
    ptrs = [(1000 + 16 * i, 2000 + 16 * i) for i in range(len(NARROW))]
    acts = [True, True, True, False]
    tab = fm.run_tables(plan, ptrs, acts, "cpu")
    lay = tab.layers.tolist()
    assert [r[:5] for r in lay] == [[w, b, K, N, int(a)] for (w, b), (K, N), a
                                    in zip(ptrs, NARROW, acts)]
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
    ("bbbbbbbbb", [("bf16", 0, 9)]),
    ("iiiiiiiib", [("int8", i, i + 1) for i in range(8)] + [("bf16", 8, 9)]),
    ("fff", [("fp32", 0, 1), ("fp32", 1, 2), ("fp32", 2, 3)]),
    ("bbiibfb", [("bf16", 0, 2), ("int8", 2, 3), ("int8", 3, 4),
                 ("bf16", 4, 5), ("fp32", 5, 6), ("bf16", 6, 7)]),
])
def test_launch_plan_mixed(names, steps):
    """Consecutive bf16 layers form one run (one launch); int8 and fp32
    layers are steps of their own: a bf16 lifter is 1 launch, an int8
    lifter 8 int8 launches and a bf16 head run."""
    assert fm.launch_plan(_kinds(*names)) == steps


def emulate_run(x, layers, slope, acts, plan):
    """The run as the kernel computes it on ``plan``: per tile the fp32 sum
    of exact products of bf16-rounded operands over its rows (zero past K),
    a split slab's partials summed in chunk order, then bias and
    LeakyReLU; inter-layer activations kept as their bf16 values.  Returns
    each layer's fp32 output."""
    h = x.to(torch.bfloat16).float()
    outs = []
    for l, ((w, b), act) in enumerate(zip(layers, acts)):
        K, N = w.shape
        lay = plan.layers[l]
        pad = 16 * -(-K // 16) - K
        wp = torch.nn.functional.pad(w.float(), (0, 0, 0, pad))
        hp = torch.nn.functional.pad(h, (0, wp.shape[0] - K))
        part = {}
        for tiles in plan.blocks:
            for t in tiles:
                if t.layer == l:
                    c0 = t.slab * fm.SLAB
                    part[t.slab, t.chunk] = (hp[:, t.r0:t.r1]
                                             @ wp[t.r0:t.r1, c0:c0 + fm.SLAB])
        y = torch.cat([_chunk_sum(part, j, lay.splits)
                       for j in range(lay.n_slabs)], 1)[:, :N] + b
        y = torch.where(y >= 0, y, slope * y) if act else y
        outs.append(y)
        h = y.to(torch.bfloat16).float()
    return outs


def _chunk_sum(part, slab, splits):
    s = part[slab, 0]
    for c in range(1, splits):
        s = s + part[slab, c]
    return s


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
    plan = fm.plan_bf16_run(NARROW, M, N_BLOCKS)
    outs = emulate_run(x, layers, 0.1, acts, plan)
    h = x
    for (w, b), act, got in zip(layers, acts, outs):
        ref = fm.mlp_layer_plain(h, w, b, 0.1, act)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol
        h = got
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
    assert fm.launch_plan(layers) == [("bf16", 0, 9)]
    acts = [i < 8 for i in range(9)]
    plan = fm.plan_bf16_run([tuple(w.shape) for w, _ in layers], M, N_BLOCKS)
    xt = torch.from_numpy(x[:M])
    outs = emulate_run(xt, layers, 0.1, acts, plan)
    h = xt
    for (w, b), act, got in zip(layers, acts, outs):
        ref = fm.mlp_layer_plain(h, w, b, 0.1, act)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol
        h = got
    got = outs[-1][:, :54]
    if jcfg.residual_prior:
        from mpe3d_tpu_torch.models.mlp import extract_prior
        got = got + extract_prior(xt, lifter.cfg)
    ref = np.asarray(apply_lifter(jparams, jnp.asarray(x[:M]), jcfg,
                                  compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_run_entry_dispatch():
    """The run entry takes the plain version for CPU tensors (equal to
    ``bf16_run_plain``, no launch counted) and refuses other devices."""
    layers = _packed(NARROW, 3)
    x = torch.tensor(np.random.default_rng(2).normal(size=(5, 70)),
                     dtype=torch.float32)
    acts = [True, True, True, False]
    before = fm.mlp_bf16_run.launches
    torch.testing.assert_close(fm.bf16_run(x, layers, 0.1, acts),
                               fm.bf16_run_plain(x, layers, 0.1, acts),
                               rtol=0, atol=0)
    assert fm.mlp_bf16_run.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fm.bf16_run(x.to("meta"), layers, 0.1, acts)
    with pytest.raises(ValueError, match="serves 1..16 rows"):
        fm.plan_bf16_run(NARROW, 17, N_BLOCKS)
