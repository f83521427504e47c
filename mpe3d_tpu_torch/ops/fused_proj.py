"""The GAT layer's fused projection fc1 -> LeakyReLU -> fc2: a hand-written
CUDA kernel on the fp64 tensor cores, its tile plan and its plain version.

Replaces the TPU kernel ``mpe3d_tpu/ops/fused_proj.py::_pallas_proj`` (:48,
``pallas_call`` at :68; entry ``fused_linear_leaky_linear`` :84, plain
form ``xla_proj`` :32): ``out = leaky(x @ w1 + b1, alpha) @ w2 + b2`` for
x [N, D], w1 [D, D], w2 [D, F], fp32.  It is the projection of the
per-layer GAT form (``models/gat.py``, form ``"layer"``), one call a layer
on the concatenated head and edge rows.

The CUDA version (``csrc/fused_proj.cu`` on ``csrc/f64_mma.cuh``) runs each
product as a tiled GEMM of 64 x 64 tiles on the fp64 tensor cores, fp32
operands and fp64 sums: two CUDA launches a call (fc1 into an fp32 scratch
h, then fc2).  ``proj_plan`` chooses each GEMM's k-split, the size of the
thread-block cluster whose blocks share a tile and sum their partials
through distributed shared memory, so that a GEMM fills the card in whole
waves; bound and design in the CUDA source.  The same GEMM
(``f64_gemm`` in ``csrc/f64_mma.cuh``) runs the fc products of the stack
GAT kernel and of K1 of the tiled kernels, on the per-layer plans of
``layer_plans``.
``fused_linear_leaky_linear`` takes the plain version for CPU tensors and
launches the kernels for CUDA tensors; ``fused_linear_leaky_linear.launches``
counts the calls that launch them.
"""

from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from mpe3d_tpu_torch.ops import _build

TILE_M = TILE_N = 64   # block tile of the fp64 tensor-core GEMM
TILE_K = 32            # k of one pipeline stage; splits are whole stages
MAX_SPLITS = 8         # k-splits share a tile in one cluster (portable size)
N_SM = 132             # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 3      # resident GEMM blocks an SM (73.7 KB of smem each)
FILL_STAGES = 3        # a block's fixed cost in the plan, in k-stages

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GemmPlan(NamedTuple):
    """One GEMM of the projection: C [M, N] = A [M, K] B [K, N], tiled in
    64 x 64 tiles, k split into ``splits`` ranges of whole 32-k stages."""
    M: int
    N: int
    K: int
    splits: int

    @property
    def tiles(self) -> int:
        return _cdiv(self.M, TILE_M) * _cdiv(self.N, TILE_N)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def block_work(self) -> Iterator[Tuple[int, int, int, int]]:
        """(row0, col0, k0, k1) of each CUDA block in launch order, the
        decomposition ``f64_gemm_kernel`` (``csrc/f64_mma.cuh``) computes
        from its block index: block b is split b % splits of tile
        b // splits, tiles row-major; k-range of a split in whole stages,
        k1 clipped to K."""
        tiles_n = _cdiv(self.N, TILE_N)
        ksteps = _cdiv(self.K, TILE_K)
        for b in range(self.blocks):
            tile, split = divmod(b, self.splits)
            ks0 = split * ksteps // self.splits
            ks1 = (split + 1) * ksteps // self.splits
            yield ((tile // tiles_n) * TILE_M, (tile % tiles_n) * TILE_N,
                   ks0 * TILE_K, min(ks1 * TILE_K, self.K))


def gemm_plan(M: int, N: int, K: int, n_sm: int = N_SM) -> GemmPlan:
    """The k-split (1..MAX_SPLITS, at most one a stage) that minimises the
    GEMM's time in whole waves of BLOCKS_PER_SM blocks an SM: waves x the
    stages a block runs, each block counted with FILL_STAGES more (its
    pipeline fill and epilogue); on ties the one that keeps more of the
    n_sm SMs busy, then fewer splits.  A GEMM with fewer tiles than the
    card has SMs splits to fill them; a larger one splits only where that
    evens out its last wave."""
    tiles = _cdiv(M, TILE_M) * _cdiv(N, TILE_N)
    ksteps = _cdiv(K, TILE_K)
    slots = n_sm * BLOCKS_PER_SM
    best = min(range(1, min(ksteps, MAX_SPLITS) + 1),
               key=lambda s: (_cdiv(tiles * s, slots)
                              * (_cdiv(ksteps, s) + FILL_STAGES),
                              -min(tiles * s, n_sm), s))
    return GemmPlan(M, N, K, best)


class ProjPlan(NamedTuple):
    """Both GEMMs of one call; the call's only scratch is h [N, D] fp32
    (rows padded to a multiple of 4 floats)."""
    fc1: GemmPlan
    fc2: GemmPlan


@functools.lru_cache(maxsize=256)
def proj_plan(N: int, D: int, F: int, n_sm: int = N_SM) -> ProjPlan:
    """Tile plan of one call on x [N, D]."""
    return ProjPlan(gemm_plan(N, D, D, n_sm), gemm_plan(N, F, D, n_sm))


def layer_plans(H: int, E: int, dims, edge_const: bool,
                n_sm: int = N_SM) -> Tuple[ProjPlan, ...]:
    """Tile plans of the fc1/fc2 GEMMs of each layer of a GAT stack on H
    head and E edge rows (the stack kernel and K1 of the tiled kernels):
    H + E rows a layer, H + 1 at layer 0 under ``edge_const`` (the shared
    edge row projected once).  dims: (d_in, d, nh) a layer."""
    return tuple(proj_plan(H + (1 if edge_const and l == 0 else E), d_in,
                           nh * d, n_sm)
                 for l, (d_in, d, nh) in enumerate(dims))


def proj_plain(x: torch.Tensor, w1: torch.Tensor,
               b1: Optional[torch.Tensor], w2: torch.Tensor,
               b2: Optional[torch.Tensor], alpha: float) -> torch.Tensor:
    """Plain version (``xla_proj``): fp32 products and sums; a bias of None
    is left out."""
    h = x @ w1
    if b1 is not None:
        h = h + b1
    out = torch.where(h >= 0, h, alpha * h) @ w2
    return out if b2 is None else out + b2


def _check(tensors, shapes, device):
    for name, t, shape in zip(("x", "w1", "b1", "w2", "b2"), tensors, shapes):
        if (t.dtype is not torch.float32 or t.device != device
                or not t.is_contiguous() or t.shape != shape):
            raise ValueError(f"fused_linear_leaky_linear: {name} must be a "
                             f"contiguous float32 {tuple(shape)} tensor on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_linear_leaky_linear(x: torch.Tensor, w1: torch.Tensor,
                              b1: Optional[torch.Tensor], w2: torch.Tensor,
                              b2: Optional[torch.Tensor],
                              alpha: float) -> torch.Tensor:
    """leaky(x @ w1 + b1, alpha) @ w2 + b2 for x [N, D], w1 [D, D],
    w2 [D, F]: the plain version for CPU tensors, the CUDA kernels (one
    call, two GEMM launches) for CUDA tensors.  A bias of None (a bias-free
    matcher) is left out: the kernels get zeros, as the TPU kernel's
    wrapper pads them (``mpe3d_tpu/ops/fused_proj.py:127-132``)."""
    if x.device.type == "cpu":
        return proj_plain(x, w1, b1, w2, b2, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear_leaky_linear: unsupported device "
                         f"{x.device}")
    dev = x.device
    if x.dim() != 2 or w2.dim() != 2:
        raise ValueError("fused_linear_leaky_linear: x and w2 must be "
                         "matrices")
    N, D = x.shape
    F = w2.shape[1]
    if b1 is None:
        b1 = torch.zeros(D, dtype=torch.float32, device=dev)
    if b2 is None:
        b2 = torch.zeros(F, dtype=torch.float32, device=dev)
    if min(N, D, F) < 1:
        raise ValueError(f"fused_linear_leaky_linear: empty shapes N={N}, "
                         f"D={D}, F={F}")
    _check((x, w1, b1, w2, b2), ((N, D), (D, D), (D,), (D, F), (F,)), dev)
    plan = proj_plan(N, D, F, sm_count(dev.index))
    # one allocation a call: h [N, ldh] (rows of 16 bytes for fc2's copies),
    # then the output
    ldh = _cdiv(D, 4) * 4
    buf = torch.empty(N * (ldh + F), dtype=torch.float32, device=dev)
    out = buf[N * ldh:].view(N, F)
    code = _build.library().cdll.gat_fused_proj(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), buf.data_ptr(), ldh, N, D, F, alpha,
        plan.fc1.splits, plan.fc2.splits,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gat_fused_proj")
    fused_linear_leaky_linear.launches += 1
    return out


fused_linear_leaky_linear.launches = 0
