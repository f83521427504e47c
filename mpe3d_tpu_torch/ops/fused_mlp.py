"""The lifter MLP's layers: the bf16 run kernel, its tile plan and plain
version, and the walk over a packed, mixed layer list.

Replaces the bf16 layer kind of the TPU kernel
``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call`` (:57, ``pallas_call`` at
:143; entry ``fused_mlp_forward`` :223, packing ``pack_fused_layers`` :154).
Its int8 layer kind (``fused_mlp.py:80-83, 93, 126``) runs in
``ops/quant_matmul.py`` (kernel ``mlp_int8_layer``).

A packed lifter is a list of layers of three kinds:

* ``Bf16Layer``: ``acc = bf16(x) @ w_bf16`` in fp32, ``+ b``; each maximal
  run of consecutive bf16 layers is ONE launch of the run kernel
  ``mlp_bf16_run`` (``launch_plan``): the whole network of a bf16 lifter,
  the head of an int8 one;
* ``Int8Layer``: ``((x * rscale) -> bf16 @ wq) * scale + b``
  (``ops/quant_matmul.py``);
* ``Fp32Layer``: ``x @ w + b`` in fp32 with ``torch.matmul`` (no kernel: the
  reference computes its fp32 lifter in XLA, outside any Pallas kernel).

LeakyReLU follows every layer but the last.  Activations stay fp32 between
layers and are rounded to bf16 (round to nearest even) as operands, as
``fused_mlp.py:114-117`` does.

Bound on an H100 SXM for the 29.1 M-param serving lifter in bf16: 58.3 MB of
weights streamed once per frame, 17.4 us at 3.35 TB/s; its 0.47 GFLOP at
8 rows is 0.5 us of the bf16 tensor-core peak.  The CUDA version
(``csrc/fused_mlp.cu``) is one persistent cooperative launch a run: every
block streams its share of every layer's weights through a deep ring that
runs ahead across layer boundaries, on the bf16 tensor cores, with split-K
partials summed in a fixed order and a grid barrier between layers.
``plan_bf16_run`` decides which block owns which (layer, 64-column slab,
K-chunk) tile; ``run_tables`` turns a plan into the kernel's device tables,
built once per packed run and row count.

Weights are packed once (``pack_layer``, ``pack_int8_layer``,
``pack_fp32_layer``): the output width is padded to the kernel's column
slab (16 for bf16, 32 for int8) with zero columns, zero scales and zero
bias, so padded outputs are exact zeros, and each layer's input width K
matches the previous layer's padded output with zero rows (zero row scales
for int8: the counterpart of ``models/mlp.py::prepad_quantized_lifter``
:248; the kernels need no other K alignment).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mpe3d_tpu_torch.ops import _build, quant_matmul

COLS = 16              # bf16 output widths are padded to a multiple of this
MAX_ROWS = 16          # activation rows the run kernel serves
SLAB = 64              # output columns of a run tile
KBLOCK = 16            # rows of a k-block; K-chunks are whole k-blocks
KC_MAX = 1024          # rows of a K-chunk (the kernel stages its activations)
MAX_LAYER_TILES = 64   # tiles of one layer a block may own
MAX_BLOCK_TILES = 96   # tiles a block may own in a run (kept in its smem)
MAX_RUN_LAYERS = 16    # layers of one run
TILE_COST_ROWS = 32    # a tile's fixed cost in the plan, in weight rows
SPLIT_COST_ROWS = 16   # a slab's cost in the plan for each extra K-chunk
MAX_PARTIAL_FLOATS = 8192   # a slab's partials the kernel reduces in smem


class Bf16Layer(NamedTuple):
    w: torch.Tensor        # [Kp, Np] bf16
    b: torch.Tensor        # [Np] fp32


class Int8Layer(NamedTuple):
    wq: torch.Tensor       # [Kp, Np] int8
    scale: torch.Tensor    # [Np] fp32, per output column
    rscale: torch.Tensor   # [Kp] fp32, per input row (0 in padded rows)
    b: torch.Tensor        # [Np] fp32


class Fp32Layer(NamedTuple):
    w: torch.Tensor        # [Kp, N] fp32
    b: torch.Tensor        # [N] fp32


Layer = Union[Bf16Layer, Int8Layer, Fp32Layer]


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
    ones, b [N]) to K = ``k_in`` rows and N rounded up to a multiple of 32:
    zero rows with zero row scales, so the padded x columns fold to exact
    zeros; zero columns with zero scales and biases."""
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    K, N = wq.shape
    n_p = _round_up(N, quant_matmul.COLS)
    if rscale is None:
        rscale = torch.ones(K, dtype=torch.float32)
    return Int8Layer(_padded(wq, (k_in, n_p), torch.int8),
                     _padded(scale, (n_p,), torch.float32),
                     _padded(rscale, (k_in,), torch.float32),
                     _padded(b, (n_p,), torch.float32))


def pack_fp32_layer(w: torch.Tensor, b: torch.Tensor, k_in: int) -> Fp32Layer:
    """Pad w [K, N] (fp32) to ``k_in`` rows with zeros."""
    return Fp32Layer(_padded(w, (k_in, w.shape[1]), torch.float32),
                     b.to(torch.float32))


def mlp_layer_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    slope: float, act: bool) -> torch.Tensor:
    """Plain version of one layer: bf16-rounded operands, fp32 products and
    sums (bf16 x bf16 products are exact in fp32)."""
    y = x.to(torch.bfloat16).float() @ w.float() + b
    return torch.where(y >= 0, y, slope * y) if act else y


def bf16_run_plain(x: torch.Tensor, layers: Sequence[Bf16Layer],
                   slope: float, acts: Sequence[bool]) -> torch.Tensor:
    """Plain version of a run of bf16 layers: ``mlp_layer_plain`` on each,
    LeakyReLU after layer i where ``acts[i]``."""
    h = x.to(torch.float32)
    for (w, b), act in zip(layers, acts):
        h = mlp_layer_plain(h, w, b, slope, act)
    return h


def bf16_run(x: torch.Tensor, layers: Sequence[Bf16Layer], slope: float,
             acts: Sequence[bool]) -> torch.Tensor:
    """A run of consecutive bf16 layers, x [M <= 16, K0] fp32 -> [M, Np]
    fp32: the plain version for CPU tensors, the run kernel (one launch)
    for CUDA tensors."""
    if x.device.type == "cpu":
        return bf16_run_plain(x, layers, slope, acts)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_run: unsupported device {x.device}")
    return mlp_bf16_run(x, layers, slope, acts)


# ---- the run kernel's tile plan ----------------------------------------

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


def run_splits(K: int, N: int, M: int, n_blocks: int) -> int:
    """K-chunks of a layer: the split count that minimises the most weight
    rows a block streams, each of its tiles counted with a fixed overhead,
    plus a cost for each extra chunk of a slab (its partial's round trip);
    at most as many chunks as the kernel reduces in shared memory (8192
    floats of M x 64 partials); fewer splits on ties."""
    n_slabs, nkb = _cdiv(N, SLAB), _cdiv(K, KBLOCK)
    best = None
    for s in range(1, min(nkb, MAX_PARTIAL_FLOATS // (M * SLAB)) + 1):
        rows = _cdiv(nkb, s) * KBLOCK
        per = _cdiv(n_slabs * s, n_blocks)
        if rows > KC_MAX or per > MAX_LAYER_TILES:
            continue
        cost = per * (rows + TILE_COST_ROWS) + (s - 1) * SPLIT_COST_ROWS
        if best is None or cost < best[0]:
            best = (cost, s)
    if best is None:
        raise ValueError(f"no run plan for a {K} x {N} layer on {n_blocks} "
                         f"blocks")
    return best[1]


def plan_bf16_run(shapes: Sequence[Tuple[int, int]], M: int,
                  n_blocks: int) -> RunPlan:
    """Tile plan of a run of layers with weight shapes ``shapes`` [(K, N)]
    on M rows and ``n_blocks`` blocks: per layer ``run_splits`` K-chunks of
    every 64-column slab; the layer's tiles, chunk-major, cut into
    ``n_blocks`` contiguous near-equal ranges, one a block."""
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"the run kernel serves 1..{MAX_ROWS} rows, got {M}")
    layers, blocks = [], [[] for _ in range(n_blocks)]
    for i, (K, N) in enumerate(shapes):
        s = run_splits(K, N, M, n_blocks)
        n_slabs = _cdiv(N, SLAB)
        layers.append(RunLayer(K, N, n_slabs, s))
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
    layers: torch.Tensor        # [L, 8] int64
    tiles: torch.Tensor         # [T, 8] int32
    block_tiles: torch.Tensor   # [n_blocks + 1] int32
    n_sync: int                 # barrier words, then one counter a slab
    acts_offset: int            # bytes: bf16 activations
    parts_offset: int           # bytes: fp32 partials
    ws_bytes: int               # 256-byte multiple; the output follows
    n_out: int                  # columns of the run's output


def run_tables(plan: RunPlan, ptrs: Sequence[Tuple[int, int]],
               acts: Sequence[bool], device) -> RunTables:
    """Device tables of ``plan`` for layers at (weight, bias) addresses
    ``ptrs``.  Layer l's output is bf16 [M, N_l] in the activations (its
    fp32 output y for the last layer); a split slab's partials are
    consecutive [M, 64] fp32 blocks in chunk order."""
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
    layer_rows = [[w, b, lay.K, lay.N, int(act),
                   act_off[i - 1] if i else -1, act_off[i], 0]
                  for i, (lay, (w, b), act)
                  in enumerate(zip(plan.layers, ptrs, acts))]
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
        plan.layers[-1].N)


# device tables by (device, rows, layer addresses and widths); a process
# serves a few lifters, so the cache is simply emptied when it fills
_RUNS: Dict[tuple, RunTables] = {}
_MAX_RUNS = 64


def _run_blocks(device: torch.device) -> int:
    """Blocks of the persistent grid on ``device`` (one a resident slot:
    the kernel's occupancy x SMs), from the library, cached there."""
    with torch.cuda.device(device):
        n = _build.library().cdll.mlp_bf16_run_blocks()
    if n < 1:
        raise RuntimeError("mlp_bf16_run: occupancy query failed")
    return n


def _check_run_layers(layers: Sequence[Bf16Layer], K0: int, device):
    k = K0
    for i, (w, b) in enumerate(layers):
        if (w.device != device or w.dtype != torch.bfloat16 or w.dim() != 2
                or not w.is_contiguous() or w.data_ptr() % 16):
            raise ValueError(f"mlp_bf16_run: layer {i} weights must be a "
                             f"contiguous, 16-byte aligned bf16 matrix on "
                             f"{device}")
        if w.shape[0] != k or w.shape[1] % COLS:
            raise ValueError(f"mlp_bf16_run: layer {i} weight shape "
                             f"{tuple(w.shape)}: K must be {k}, N a multiple "
                             f"of {COLS}")
        if (b.device != device or b.dtype != torch.float32
                or not b.is_contiguous() or tuple(b.shape) != (w.shape[1],)):
            raise ValueError(f"mlp_bf16_run: layer {i} bias must be a "
                             f"contiguous float32 [{w.shape[1]}] on {device}")
        k = w.shape[1]


def mlp_bf16_run(x: torch.Tensor, layers: Sequence[Bf16Layer], slope: float,
                 acts: Sequence[bool]) -> torch.Tensor:
    """Launch the run kernel on CUDA tensors: x [M, K0] fp32, M <= 16.
    The plan and its device tables are built at the first call for these
    layers and this M and kept; a call then checks only x."""
    dev = x.device
    if (x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous()
            or not 1 <= x.shape[0] <= MAX_ROWS):
        raise ValueError(f"mlp_bf16_run: x must be a contiguous float32 "
                         f"[M <= {MAX_ROWS}, K] matrix, got {x.dtype} "
                         f"{tuple(x.shape)}")
    M = x.shape[0]
    # the layers' addresses and shapes name the tables (a layer moved or
    # replaced gets new ones)
    key = (dev.index, M, *acts,
           *(v for w, b in layers for v in (w.data_ptr(), b.data_ptr(),
                                            *w.shape)))
    run = _RUNS.get(key)
    if run is None:
        _check_run_layers(layers, x.shape[1], dev)
        plan = plan_bf16_run([tuple(w.shape) for w, _ in layers], M,
                             _run_blocks(dev))
        ptrs = [(w.data_ptr(), b.data_ptr()) for w, b in layers]
        if len(_RUNS) >= _MAX_RUNS:
            _RUNS.clear()
        run = _RUNS[key] = run_tables(plan, ptrs, acts, dev)
    # one allocation a call: the workspace, then the output y [M, n_out]
    ws = torch.empty(run.ws_bytes + 4 * M * run.n_out, dtype=torch.uint8,
                     device=dev)
    y = ws[run.ws_bytes:].view(torch.float32).view(M, run.n_out)
    code = _build.library().cdll.mlp_bf16_run(
        x.data_ptr(), y.data_ptr(), run.layers.data_ptr(),
        run.tiles.data_ptr(), run.block_tiles.data_ptr(), ws.data_ptr(),
        run.n_sync, run.acts_offset, run.parts_offset, M, len(layers),
        run.block_tiles.numel() - 1, slope,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "mlp_bf16_run")
    mlp_bf16_run.launches += 1
    return y


mlp_bf16_run.launches = 0


def fp32_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               slope: float, act: bool) -> torch.Tensor:
    """One fp32 layer (``apply_lifter`` :120-126 without compute_dtype):
    ``torch.matmul`` in fp32 (TF32 off), ``+ b``, LeakyReLU."""
    y = x @ w + b
    return torch.where(y >= 0, y, slope * y) if act else y


def launch_plan(layers: Sequence[Layer]) -> List[Tuple[str, int, int]]:
    """The steps of a packed layer list: each maximal run of consecutive
    ``Bf16Layer``s is one step ("bf16", i, j) for layers [i, j) (one
    launch); each ``Int8Layer`` ("int8") and ``Fp32Layer`` ("fp32") is its
    own step."""
    return list(_steps(tuple(map(type, layers))))


@functools.lru_cache(maxsize=64)
def _steps(kinds: Tuple[type, ...]) -> Tuple[Tuple[str, int, int], ...]:
    steps: List[Tuple[str, int, int]] = []
    for i, kind in enumerate(kinds):
        name = ("int8" if issubclass(kind, Int8Layer) else
                "fp32" if issubclass(kind, Fp32Layer) else "bf16")
        if name == "bf16" and steps and steps[-1][0] == "bf16":
            steps[-1] = ("bf16", steps[-1][1], i + 1)
        else:
            steps.append((name, i, i + 1))
    return tuple(steps)


def _walk(x, layers, slope, out_dim, bf16_fn, int8_fn):
    h = x.to(torch.float32).contiguous()
    n = len(layers)
    for kind, i, j in launch_plan(layers):
        if kind == "bf16":
            h = bf16_fn(h, layers[i:j], slope,
                        [k < n - 1 for k in range(i, j)])
        elif kind == "int8":
            layer, act = layers[i], i < n - 1
            h = int8_fn(h, layer.wq, layer.scale, layer.b,
                        slope if act else None, layer.rscale)
        else:
            h = fp32_layer(h, layers[i].w, layers[i].b, slope, i < n - 1)
    return h[:, :out_dim]


def fused_mlp_forward(x: torch.Tensor, layers: List[Layer], slope: float,
                      out_dim: int) -> torch.Tensor:
    """The whole packed MLP, x [M, K0] -> [M, out_dim] fp32: each step of
    ``launch_plan`` through its kind's entry (kernel on CUDA tensors, plain
    on CPU ones)."""
    return _walk(x, layers, slope, out_dim, bf16_run,
                 quant_matmul.int8_weight_matmul)


def fused_mlp_plain(x: torch.Tensor, layers: List[Layer], slope: float,
                    out_dim: int) -> torch.Tensor:
    """Plain version of ``fused_mlp_forward`` on any device."""
    return _walk(x, layers, slope, out_dim, bf16_run_plain,
                 quant_matmul.int8_matmul_plain)
