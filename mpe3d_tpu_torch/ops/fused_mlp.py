"""The lifter MLP's layers: the run kernel, its tile plan and plain
version, and the walk over a packed, mixed layer list.

Replaces the TPU kernel ``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call``
(:57, ``pallas_call`` at :143; entry ``fused_mlp_forward`` :223, packing
``pack_fused_layers`` :154), both of its layer kinds: bf16 weights and int8
weights (``fused_mlp.py:80-83, 93, 126``).  Like it, the run kernel takes a
mixed network in one launch.

A packed lifter is a list of layers of three kinds:

* ``Bf16Layer``: ``acc = bf16(x) @ w_bf16`` in fp32, ``+ b``;
* ``Int8Layer``: ``((x * rscale) -> bf16 @ wq) * scale + b``, the algebra
  of ``ops/quant_matmul.py``;
* ``Fp32Layer``: ``x @ w + b`` in fp32 with ``torch.matmul`` (no kernel: the
  reference computes its fp32 lifter in XLA, outside any Pallas kernel).

Each maximal run of consecutive bf16 and int8 layers is ONE launch of the
run kernel ``mlp_run`` (``launch_plan``) for up to 64 rows: the whole
network of a bf16 or an int8 lifter; more rows (a batch of frames) take a
launch a group of 64 (``run_layers``), each streaming the weights once.
LeakyReLU follows every layer but the last.  Activations are
fp32 between layers and rounded to bf16 (round to nearest even) as
operands, as ``fused_mlp.py:114-117`` does; an int8 layer's input is first
multiplied by its row scales in fp32 (``quant_matmul.py::_fold``).

Bound on an H100 SXM for the 29.1 M-param serving lifter: 58.3 MB of bf16
weights (29.1 MB of int8 ones and a bf16 head) streamed once per frame,
17.4 us (8.7 us) at 3.35 TB/s; its 0.47 GFLOP at 8 rows is 0.5 us of the
bf16 tensor-core peak.  The CUDA version (``csrc/fused_mlp.cu``) is one
persistent cooperative launch a run: every block streams its share of every
layer's weights through a deep ring that runs ahead across layer
boundaries, on the bf16 tensor cores (int8 weights are converted to bf16 in
registers, exactly), with split-K partials summed in a fixed order and a
grid barrier between layers.  ``plan_run`` decides which block owns which
(layer, 64-column slab, K-chunk) tile, balancing weight bytes; ``run_tables``
turns a plan into the kernel's device tables, built once per packed run and
row count.  The kernel's row classes (up to 8, 16, 32, 64 rows) differ
in shared memory: past 16 rows the ring is shallower, past 32 a K-chunk is
at most 512 rows (``kc_max``, ``run_smem_bytes``).

Weights are packed once (``pack_layer``, ``pack_int8_layer``,
``pack_fp32_layer``): the output width is padded to a multiple of 16 with
zero columns, zero scales and zero bias, so padded outputs are exact zeros,
and each layer's input width K matches the previous layer's padded output
with zero rows (zero row scales for int8: the counterpart of
``models/mlp.py::prepad_quantized_lifter`` :248).  An int8 weight matrix is
stored in the kernel's fragment order (``int8_fragments``; ``int8_rows``
gives the matrix back): for each 64-column slab, its 16-row k-blocks one
after another, each k-block's 1024 bytes in the order the mma.sync A
fragments of the transposed product read them, so a ring stage is one
contiguous 16 KB copy and each lane's operand bytes are one 16-byte load.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mpe3d_tpu_torch.ops import _build, quant_matmul

COLS = 16              # output widths are padded to a multiple of this
MAX_ROWS = 64          # activation rows one launch of the run kernel serves
SLAB = 64              # output columns of a run tile
KBLOCK = 16            # rows of a k-block; K-chunks are whole k-blocks
KC_MAX = 1024          # rows of a K-chunk (the kernel stages its activations)
STAGE_BYTES = 16384    # a stage of the kernel's weight ring
RED_BYTES = 16384      # the kernel's exchange of warp sums
STATIC_SMEM = 6 * 1024  # the kernel's static shared memory, at most
SMEM_OPTIN = 227 * 1024  # shared memory a block may have on an H100
MAX_LAYER_TILES = 64   # tiles of one layer a block may own
MAX_BLOCK_TILES = 96   # tiles a block may own in a run (kept in its smem)
MAX_RUN_LAYERS = 16    # layers of one run
TILE_COST_ROWS = 32    # a tile's fixed cost in the plan, in bf16 weight rows
SPLIT_COST_ROWS = 16   # a slab's cost in the plan for each extra K-chunk
# past 16 rows, that cost for each 16 rows: one block reduces the slab's
# partials (M x 64 floats a chunk), so its passes grow with M
WIDE_SPLIT_COST_ROWS = 16
MAX_PARTIAL_FLOATS = 8192   # a slab's partials the kernel reduces in smem
FRAG_BYTES = KBLOCK * SLAB  # bytes of one int8 k-block of a slab


class Bf16Layer(NamedTuple):
    w: torch.Tensor        # [Kp, Np] bf16
    b: torch.Tensor        # [Np] fp32


class Int8Layer(NamedTuple):
    wq: torch.Tensor       # [ceil(Np / 64), ceil(Kp / 16), 1024] int8,
    #                        fragment order (``int8_fragments``)
    scale: torch.Tensor    # [Np] fp32, per output column
    rscale: torch.Tensor   # [Kp] fp32, per input row (0 in padded rows)
    b: torch.Tensor        # [Np] fp32


class Fp32Layer(NamedTuple):
    w: torch.Tensor        # [Kp, N] fp32
    b: torch.Tensor        # [N] fp32


Layer = Union[Bf16Layer, Int8Layer, Fp32Layer]


def layer_shape(layer: Layer) -> Tuple[int, int]:
    """(K, N) of a packed layer: its input width and padded output width."""
    if isinstance(layer, Int8Layer):
        return layer.rscale.shape[0], layer.b.shape[0]
    return tuple(layer.w.shape)


def _padded(t: torch.Tensor, shape, dtype) -> torch.Tensor:
    """t zero-padded at the end of each dimension to ``shape``."""
    if any(s < n for s, n in zip(shape, t.shape)):
        raise ValueError(f"layer input width {t.shape[0]} exceeds the "
                         f"previous layer's padded width {shape[0]}")
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t.to(dtype)
    return out


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


# An int8 k-block of a slab (16 rows x 64 columns) as the kernel reads it:
# byte p*512 + lane*16 + ml*8 + r*2 + h is the weight at row
# 8 rk + 2 t + h and column 32 p + 16 ml + 8 rn + g, for lane = 4 g + t and
# register r = 2 rk + rn of the m16n8k16 A fragment of m-tile 2 p + ml (the
# transposed product: weight columns are the A rows).  As dimensions:
# fragments [slab, kb, p, g, t, ml, rk, rn, h] <-> rows [kb, rk, t, h] x
# columns [slab, p, ml, rn, g].
_TO_FRAG = (4, 0, 5, 8, 2, 6, 1, 7, 3)
_TO_ROWS = (1, 6, 4, 8, 0, 2, 5, 7, 3)


def int8_fragments(w: torch.Tensor) -> torch.Tensor:
    """int8 matrix [K, N] -> [ceil(N / 64), ceil(K / 16), 1024] in the run
    kernel's fragment order, zero-padded to whole k-blocks and slabs."""
    K, N = w.shape
    kb, ns = _cdiv(K, KBLOCK), _cdiv(N, SLAB)
    rows = _padded(w, (kb * KBLOCK, ns * SLAB), torch.int8)
    return (rows.view(kb, 2, 4, 2, ns, 2, 2, 2, 8).permute(*_TO_FRAG)
            .reshape(ns, kb, FRAG_BYTES).contiguous())


def int8_rows(wq: torch.Tensor) -> torch.Tensor:
    """Inverse of ``int8_fragments``: [ceil(K / 16) 16, ceil(N / 64) 64]."""
    ns, kb, _ = wq.shape
    return (wq.view(ns, kb, 2, 8, 4, 2, 2, 2, 2).permute(*_TO_ROWS)
            .reshape(kb * KBLOCK, ns * SLAB))


def pack_layer(w: torch.Tensor, b: torch.Tensor, k_in: int) -> Bf16Layer:
    """Pad w [K, N] (bf16) / b [N] to [k_in, Np] / [Np], Np = N rounded up to
    a multiple of 16; ``k_in`` >= K is the previous layer's padded width."""
    n_p = _round_up(w.shape[1], COLS)
    return Bf16Layer(_padded(w, (k_in, n_p), torch.bfloat16),
                     _padded(b, (n_p,), torch.float32))


def pack_int8_layer(wq: torch.Tensor, scale: torch.Tensor,
                    rscale: Optional[torch.Tensor], b: torch.Tensor,
                    k_in: int) -> Int8Layer:
    """Pad an int8 layer (wq [K, N], scale [N], rscale [K] or None for
    ones, b [N]) to K = ``k_in`` rows and N rounded up to a multiple of 16:
    zero rows with zero row scales, so the padded x columns fold to exact
    zeros; zero columns with zero scales and biases.  ``wq`` is stored in
    fragment order (``int8_fragments``)."""
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    K, N = wq.shape
    n_p = _round_up(N, COLS)
    if rscale is None:
        rscale = torch.ones(K, dtype=torch.float32, device=wq.device)
    return Int8Layer(int8_fragments(_padded(wq, (k_in, n_p), torch.int8)),
                     _padded(scale, (n_p,), torch.float32),
                     _padded(rscale, (k_in,), torch.float32),
                     _padded(b, (n_p,), torch.float32))


def pack_fp32_layer(w: torch.Tensor, b: torch.Tensor, k_in: int) -> Fp32Layer:
    """Pad w [K, N] (fp32) to ``k_in`` rows with zeros."""
    return Fp32Layer(_padded(w, (k_in, w.shape[1]), torch.float32),
                     b.to(torch.float32))


def mlp_layer_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    slope: float, act: bool) -> torch.Tensor:
    """Plain version of one bf16 layer: bf16-rounded operands, fp32 products
    and sums (bf16 x bf16 products are exact in fp32)."""
    y = x.to(torch.bfloat16).float() @ w.float() + b
    return torch.where(y >= 0, y, slope * y) if act else y


def layer_plain(x: torch.Tensor, layer: Union[Bf16Layer, Int8Layer],
                slope: float, act: bool) -> torch.Tensor:
    """Plain version of one run layer of either kind (an int8 layer through
    ``quant_matmul.int8_matmul_plain`` on its row-major weights)."""
    if isinstance(layer, Int8Layer):
        N = layer.b.shape[0]
        return quant_matmul.int8_matmul_plain(
            x, int8_rows(layer.wq)[:, :N], layer.scale, layer.b,
            slope if act else None, layer.rscale)
    return mlp_layer_plain(x, layer.w, layer.b, slope, act)


def run_plain(x: torch.Tensor, layers: Sequence[Union[Bf16Layer, Int8Layer]],
              slope: float, acts: Sequence[bool]) -> torch.Tensor:
    """Plain version of a run of bf16 and int8 layers: ``layer_plain`` on
    each, LeakyReLU after layer i where ``acts[i]``."""
    h = x.to(torch.float32)
    for layer, act in zip(layers, acts):
        h = layer_plain(h, layer, slope, act)
    return h


def run_layers(x: torch.Tensor, layers: Sequence[Union[Bf16Layer, Int8Layer]],
               slope: float, acts: Sequence[bool]) -> torch.Tensor:
    """A run of consecutive bf16 and int8 layers, x [M, K0] fp32 ->
    [M, Np] fp32: the plain version for CPU tensors; for CUDA tensors the
    run kernel, one launch a group of at most 64 rows."""
    if x.device.type == "cpu":
        return run_plain(x, layers, slope, acts)
    if x.device.type != "cuda":
        raise ValueError(f"run_layers: unsupported device {x.device}")
    if x.shape[0] <= MAX_ROWS:
        return mlp_run(x, layers, slope, acts)
    return torch.cat([mlp_run(x[m:m + MAX_ROWS], layers, slope, acts)
                      for m in range(0, x.shape[0], MAX_ROWS)])


# ---- the run kernel's tile plan ----------------------------------------

def row_tiles(M: int) -> int:
    """n8 tiles of the kernel's row class for M rows: 1, 2, 4 or 8."""
    return 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8


def kc_max(M: int) -> int:
    """Rows of a K-chunk the row class of M rows stages (``Rows<NT>::KC``
    in ``csrc/fused_mlp.cu``)."""
    return KC_MAX if M <= 32 else KC_MAX // 2


def run_smem_bytes(M: int) -> int:
    """Dynamic shared memory of the row class of M rows (``Rows<NT>::
    SMEM``): the ring (10 stages up to 16 rows, else 8), the staged chunk
    (8 NT rows, at least 16, of kc_max + 8 bf16) and the warp sums."""
    nt = row_tiles(M)
    stages = 10 if nt <= 2 else 8
    return (stages * STAGE_BYTES + max(nt * 8, 16) * (kc_max(M) + 8) * 2
            + RED_BYTES)


def partial_cap(M: int) -> int:
    """Floats of slab partials one pass of the kernel's reduction holds
    (its staged chunk's space)."""
    nt = row_tiles(M)
    return max(nt * 8, 16) * (kc_max(M) + 8) * 2 // 4


def split_cost_rows(M: int) -> int:
    """A slab's cost in the plan for each extra K-chunk on M rows."""
    return SPLIT_COST_ROWS if M <= 16 else WIDE_SPLIT_COST_ROWS * M // 16


def max_splits(M: int, K: int) -> int:
    """K-chunks a layer of K rows may have on M rows: up to 16 rows as
    many as one pass reduces (8192 floats of M x 64 partials), past that 8
    (the reduction goes in passes), and at most its k-blocks."""
    return min(_cdiv(K, KBLOCK),
               MAX_PARTIAL_FLOATS // (min(M, 16) * SLAB))

class RunTile(NamedTuple):
    """Columns [n0, n0 + SLAB) x weight rows [r0, r1) of one layer: slab
    ``slab``, K-chunk ``chunk`` of the layer's ``splits``."""
    layer: int
    slab: int
    chunk: int
    r0: int
    r1: int


class RunLayer(NamedTuple):
    K: int
    N: int
    n_slabs: int
    splits: int
    int8: bool


class RunPlan(NamedTuple):
    """Which block owns which tiles: ``blocks[b]`` lists block b's tiles,
    layer by layer, chunk-major within a layer."""
    M: int
    n_blocks: int
    layers: Tuple[RunLayer, ...]
    blocks: Tuple[Tuple[RunTile, ...], ...]


def chunk_rows(K: int, splits: int, chunk: int) -> Tuple[int, int]:
    """Weight rows [r0, r1) of K-chunk ``chunk``: the layer's
    ceil(K / 16) k-blocks cut into ``splits`` near-equal runs; r1 of the
    last chunk is rounded up to a whole k-block (the kernel zero-fills rows
    past K)."""
    nkb = _cdiv(K, KBLOCK)
    return (chunk * nkb // splits * KBLOCK,
            (chunk + 1) * nkb // splits * KBLOCK)


def run_splits(K: int, N: int, M: int, n_blocks: int,
               int8: bool = False) -> int:
    """K-chunks of a layer: the split count that minimises the most weight
    bytes a block streams, each of its tiles counted with a fixed overhead,
    plus a cost for each extra chunk of a slab (its partial's round trip);
    at most ``max_splits`` chunks of at most ``kc_max`` rows; fewer splits
    on ties.  Costs are in bytes of a 64-column slab row over 64: 2 a bf16
    row, 1 an int8 row."""
    n_slabs, nkb = _cdiv(N, SLAB), _cdiv(K, KBLOCK)
    row_cost = 1 if int8 else 2
    best = None
    for s in range(1, max_splits(M, K) + 1):
        rows = _cdiv(nkb, s) * KBLOCK
        per = _cdiv(n_slabs * s, n_blocks)
        if rows > kc_max(M) or per > MAX_LAYER_TILES:
            continue
        cost = (per * (rows * row_cost + 2 * TILE_COST_ROWS)
                + 2 * (s - 1) * split_cost_rows(M))
        if best is None or cost < best[0]:
            best = (cost, s)
    if best is None:
        raise ValueError(f"no run plan for a {K} x {N} layer on {n_blocks} "
                         f"blocks")
    return best[1]


def plan_run(shapes: Sequence[Tuple[int, int]], M: int, n_blocks: int,
             int8: Optional[Sequence[bool]] = None) -> RunPlan:
    """Tile plan of a run of layers with weight shapes ``shapes`` [(K, N)]
    (``int8[i]``: layer i has int8 weights; default all bf16) on M rows and
    ``n_blocks`` blocks: per layer ``run_splits`` K-chunks of every
    64-column slab; the layer's tiles, chunk-major, cut into ``n_blocks``
    contiguous near-equal ranges, one a block."""
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the run kernel serves 1..{MAX_ROWS} rows, got {M}")
    int8 = [False] * len(shapes) if int8 is None else list(int8)
    layers, blocks = [], [[] for _ in range(n_blocks)]
    for i, ((K, N), q) in enumerate(zip(shapes, int8)):
        s = run_splits(K, N, M, n_blocks, q)
        n_slabs = _cdiv(N, SLAB)
        layers.append(RunLayer(K, N, n_slabs, s, bool(q)))
        T = n_slabs * s
        for b in range(n_blocks):
            for t in range(b * T // n_blocks, (b + 1) * T // n_blocks):
                chunk, slab = divmod(t, n_slabs)
                blocks[b].append(RunTile(i, slab, chunk,
                                         *chunk_rows(K, s, chunk)))
    if len(shapes) > MAX_RUN_LAYERS or max(map(len, blocks)) > MAX_BLOCK_TILES:
        raise ValueError(f"a run of {len(shapes)} layers on {n_blocks} blocks "
                         f"exceeds the kernel's tables ({MAX_RUN_LAYERS} "
                         f"layers, {MAX_BLOCK_TILES} tiles a block)")
    return RunPlan(M, n_blocks, tuple(layers),
                   tuple(tuple(b) for b in blocks))


class RunTables(NamedTuple):
    """The kernel's device tables of a plan and its workspace layout."""
    layers: torch.Tensor        # [L, 12] int64
    tiles: torch.Tensor         # [T, 8] int32
    block_tiles: torch.Tensor   # [n_blocks + 1] int32
    n_sync: int                 # barrier words, then one counter a slab
    acts_offset: int            # bytes: bf16 activations
    parts_offset: int           # bytes: fp32 partials
    ws_bytes: int               # 256-byte multiple; the output follows
    n_out: int                  # columns of the run's output
    any_int8: int               # 1: the run has an int8 layer


def run_tables(plan: RunPlan, ptrs: Sequence[Tuple[int, int, int, int]],
               acts: Sequence[bool], device) -> RunTables:
    """Device tables of ``plan`` for layers at (weight, bias, scale, row
    scale) addresses ``ptrs`` (0 for a bf16 layer's scales).  Layer l's
    output is bf16 [M, N_l] in the activations (its fp32 output y for the
    last layer), multiplied by the next layer's row scales first where that
    layer is int8; a split slab's partials are consecutive [M, 64] fp32
    blocks in chunk order.  A layer row: weights, bias, K, N, LeakyReLU,
    input and output offsets (bf16 elements; -1: the run's x / y), int8,
    scales, its own row scales (read where it takes the run's x), the next
    layer's row scales (0: none), 0."""
    M, L = plan.M, len(plan.layers)
    act_off, part_off, n_sync = [], [], L
    counter, a, p = {}, 0, 0
    for i, lay in enumerate(plan.layers):
        act_off.append(a if i < L - 1 else -1)
        a += M * lay.N if i < L - 1 else 0
        part_off.append(p)
        if lay.splits > 1:
            p += lay.n_slabs * lay.splits * M * SLAB
            for j in range(lay.n_slabs):
                counter[i, j] = n_sync
                n_sync += 1
    layer_rows = []
    for i, (lay, (w, b, scale, rscale), act) in enumerate(
            zip(plan.layers, ptrs, acts)):
        nxt = i + 1 < L and plan.layers[i + 1].int8
        layer_rows.append([w, b, lay.K, lay.N, int(act),
                           act_off[i - 1] if i else -1, act_off[i],
                           int(lay.int8), scale if lay.int8 else 0,
                           rscale if lay.int8 else 0,
                           ptrs[i + 1][3] if nxt else 0, 0])
    tile_rows, block_tiles = [], [0]
    for tiles in plan.blocks:
        for t in tiles:
            lay = plan.layers[t.layer]
            split = lay.splits > 1
            base = part_off[t.layer] + t.slab * lay.splits * M * SLAB
            tile_rows.append([t.layer, t.slab * SLAB, t.r0, t.r1,
                              base + t.chunk * M * SLAB if split else -1,
                              counter.get((t.layer, t.slab), 0), lay.splits,
                              base])
        block_tiles.append(len(tile_rows))
    align = lambda n: _cdiv(n, 256) * 256   # noqa: E731
    acts_offset = align(4 * n_sync)
    parts_offset = acts_offset + align(2 * a)
    return RunTables(
        torch.tensor(layer_rows, dtype=torch.int64).to(device),
        torch.tensor(tile_rows, dtype=torch.int32).to(device),
        torch.tensor(block_tiles, dtype=torch.int32).to(device),
        n_sync, acts_offset, parts_offset, align(parts_offset + 4 * p),
        plan.layers[-1].N, int(any(lay.int8 for lay in plan.layers)))


# device tables by (device, rows, layer addresses and widths); a process
# serves a few lifters, so the cache is simply emptied when it fills
_RUNS: Dict[tuple, RunTables] = {}
_MAX_RUNS = 64


def _run_blocks(device: torch.device) -> int:
    """Blocks of the persistent grid on ``device`` (one a resident slot:
    the kernel's occupancy x SMs), from the library, cached there."""
    with torch.cuda.device(device):
        n = _build.library().cdll.mlp_run_blocks()
    if n < 1:
        raise RuntimeError("mlp_run: occupancy query failed")
    return n


def _check(t: torch.Tensor, what: str, dtype, shape, device, align=4):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape) or t.data_ptr() % align):
        raise ValueError(f"mlp_run: {what} must be a contiguous, {align}-byte "
                         f"aligned {dtype} tensor of shape {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_run_layers(layers: Sequence[Union[Bf16Layer, Int8Layer]], K0: int,
                      device):
    k = K0
    for i, layer in enumerate(layers):
        N = layer.b.shape[0]
        if N % COLS:
            raise ValueError(f"mlp_run: layer {i} width {N} is not a "
                             f"multiple of {COLS}")
        if isinstance(layer, Int8Layer):
            _check(layer.wq, f"layer {i} weights", torch.int8,
                   (_cdiv(N, SLAB), _cdiv(k, KBLOCK), FRAG_BYTES), device, 16)
            _check(layer.scale, f"layer {i} scales", torch.float32, (N,),
                   device)
            _check(layer.rscale, f"layer {i} row scales", torch.float32,
                   (k,), device)
        elif isinstance(layer, Bf16Layer):
            _check(layer.w, f"layer {i} weights", torch.bfloat16, (k, N),
                   device, 16)
        else:
            raise ValueError(f"mlp_run: layer {i} is a {type(layer).__name__}")
        _check(layer.b, f"layer {i} bias", torch.float32, (N,), device)
        k = N


def mlp_run(x: torch.Tensor, layers: Sequence[Union[Bf16Layer, Int8Layer]],
            slope: float, acts: Sequence[bool]) -> torch.Tensor:
    """Launch the run kernel on CUDA tensors: x [M, K0] fp32, M <= 64.
    The layers are checked and the plan and its device tables built at the
    first call for these layers and this M, and kept; a call then checks
    only x."""
    dev = x.device
    if (x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous()
            or not 1 <= x.shape[0] <= MAX_ROWS):
        raise ValueError(f"mlp_run: x must be a contiguous float32 "
                         f"[M <= {MAX_ROWS}, K] matrix, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M = x.shape[0]
    # the layers' addresses and shapes name the tables (a layer moved or
    # replaced gets new ones)
    key = (dev.index, M, x.shape[1], *acts,
           *(v for layer in layers for t in layer
             for v in (t.data_ptr(), *t.shape)))
    run = _RUNS.get(key)
    if run is None:
        _check_run_layers(layers, x.shape[1], dev)
        int8 = [isinstance(layer, Int8Layer) for layer in layers]
        plan = plan_run([layer_shape(layer) for layer in layers], M,
                        _run_blocks(dev), int8)
        ptrs = [(layer.wq.data_ptr(), layer.b.data_ptr(),
                 layer.scale.data_ptr(), layer.rscale.data_ptr()) if q else
                (layer.w.data_ptr(), layer.b.data_ptr(), 0, 0)
                for layer, q in zip(layers, int8)]
        if len(_RUNS) >= _MAX_RUNS:
            _RUNS.clear()
        run = _RUNS[key] = run_tables(plan, ptrs, acts, dev)
    # one allocation a call: the workspace, then the output y [M, n_out]
    ws = torch.empty(run.ws_bytes + 4 * M * run.n_out, dtype=torch.uint8,
                     device=dev)
    y = ws[run.ws_bytes:].view(torch.float32).view(M, run.n_out)
    code = _build.library().cdll.mlp_run(
        x.data_ptr(), y.data_ptr(), run.layers.data_ptr(),
        run.tiles.data_ptr(), run.block_tiles.data_ptr(), ws.data_ptr(),
        run.n_sync, run.acts_offset, run.parts_offset, M, len(layers),
        run.block_tiles.numel() - 1, slope, run.any_int8,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "mlp_run")
    mlp_run.launches += 1
    return y


mlp_run.launches = 0


def fp32_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               slope: float, act: bool) -> torch.Tensor:
    """One fp32 layer (``apply_lifter`` :120-126 without compute_dtype):
    ``torch.matmul`` in fp32 (TF32 off), ``+ b``, LeakyReLU."""
    y = x @ w + b
    return torch.where(y >= 0, y, slope * y) if act else y


def launch_plan(layers: Sequence[Layer]) -> List[Tuple[str, int, int]]:
    """The steps of a packed layer list: each maximal run of consecutive
    ``Bf16Layer``s and ``Int8Layer``s is one step ("run", i, j) for layers
    [i, j) (one launch); each ``Fp32Layer`` is its own step ("fp32")."""
    return list(_steps(tuple(map(type, layers))))


@functools.lru_cache(maxsize=64)
def _steps(kinds: Tuple[type, ...]) -> Tuple[Tuple[str, int, int], ...]:
    steps: List[Tuple[str, int, int]] = []
    for i, kind in enumerate(kinds):
        name = "fp32" if issubclass(kind, Fp32Layer) else "run"
        if name == "run" and steps and steps[-1][0] == "run":
            steps[-1] = ("run", steps[-1][1], i + 1)
        else:
            steps.append((name, i, i + 1))
    return tuple(steps)


def _walk(x, layers, slope, out_dim, run_fn):
    h = x.to(torch.float32).contiguous()
    n = len(layers)
    for kind, i, j in launch_plan(layers):
        if kind == "run":
            h = run_fn(h, layers[i:j], slope,
                       [k < n - 1 for k in range(i, j)])
        else:
            h = fp32_layer(h, layers[i].w, layers[i].b, slope, i < n - 1)
    return h[:, :out_dim]


def fused_mlp_forward(x: torch.Tensor, layers: List[Layer], slope: float,
                      out_dim: int) -> torch.Tensor:
    """The whole packed MLP, x [M, K0] -> [M, out_dim] fp32: each step of
    ``launch_plan`` through its kind's entry (the run kernel on CUDA
    tensors, plain on CPU ones)."""
    return _walk(x, layers, slope, out_dim, run_layers)


def fused_mlp_plain(x: torch.Tensor, layers: List[Layer], slope: float,
                    out_dim: int) -> torch.Tensor:
    """Plain version of ``fused_mlp_forward`` on any device."""
    return _walk(x, layers, slope, out_dim, run_plain)
