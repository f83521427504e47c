"""The GAT matcher stack: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mpe3d_tpu/ops/gat_kernel.py::_gat_megakernel``
(:206, ``pallas_call`` at :232; entry ``apply_matcher_pallas`` :272, body
``gat_stack_values`` :95-200): the whole alt-3 GAT stack of one frame,
inference only (no dropout, no residual).

``edge_const`` is the caller's statement that every edge row of ``x`` is
the same vector (the alt-3 edge one-hot; the pipeline states it for every
bucket); it is never inferred from the values.  Under it layer 0 projects
and scores the H head rows and the one shared edge row, and every edge
reads that row; both versions take it, and compute the same function with
it as without it.

Bound on an H100 SXM at the serving bucket (H=20 heads, E=160 pairs,
902-dim input, the 1.96 M-weight 5-layer stack) under ``edge_const``:
0.33 GFLOP (21 rows at layer 0, 180 at layers 1-4; 0.70 GFLOP with all
180 rows at layer 0) is 4.9 us at 67 TFLOP/s, the fp64 tensor-core peak,
against 2.3 us for the 7.8 MB of weights at 3.35 TB/s: compute-bound on
paper, but on the card a chain of 15 dependent launches of a few
microseconds of work each, bound by their latency.  The CUDA version
(``csrc/gat_stack.cu``) runs fc1/fc2 on the fp64 tensor cores (the GEMM
shared with K1 and the projection, ``csrc/f64_mma.cuh``), k split over
thread-block clusters by the per-layer tile plan
(``ops/fused_proj.py::layer_plans``) so that the small GEMMs fill the
card, and one launch a layer for the attention terms and the edge and head
outputs: 3 CUDA launches a layer, 15 a call, issued from one host call.
fp32 operands, fp64 sums, no TF32 (rounded operands move scores across
the decision threshold).

Where the TPU kernel gathers endpoints and scatters head sums with 0/1
incidence matmuls, both versions here index: endpoint rows by ``e1``/``e2``,
head sums over each head's list of incident edges ``inc [H, D]``.  The
summation order therefore differs from the TPU and XLA forms; the tests
hold the plain version to ``apply_matcher`` at fp32 tolerance.

``gat_stack`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``gat_stack.launches`` counts the kernel calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from mpe3d_tpu_torch.ops import _build
from mpe3d_tpu_torch.ops.fused_proj import layer_plans, proj_plain, sm_count

Dims = List[Tuple[int, int, int]]


# incident edges a head may have in the stack kernel (csrc/gat_stack.cu)
MAX_D = 64


class GatTopology(NamedTuple):
    """Index form of the alt-3 pair topology on one device.  ``inc`` is
    what the stack form reads; the tiled form (``ops/gat_tiled.py``) reads
    only ``e1``/``e2``."""

    e1: torch.Tensor    # [E] int32 head index of endpoint 1
    e2: torch.Tensor    # [E] int32 head index of endpoint 2
    n_heads: int
    inc: Optional[torch.Tensor] = None   # [H, D] int32 incident edges

    @property
    def n_pairs(self) -> int:
        return self.e1.shape[0]


def layer_views(flat: torch.Tensor, dims: Dims):
    """Per-layer (w1, b1, w2, b2, attn_l, attn_r) views of the packed
    weights: w1 [d_in, d_in], b1 [d_in], w2 [d_in, F], b2 [F],
    attn_l/attn_r [nh, d]."""
    out, off = [], 0
    for d_in, d, nh in dims:
        F = nh * d
        shapes = ((d_in, d_in), (d_in,), (d_in, F), (F,), (nh, d), (nh, d))
        views = []
        for shp in shapes:
            n = 1
            for s in shp:
                n *= s
            views.append(flat[off:off + n].view(shp))
            off += n
        out.append(tuple(views))
    if off != flat.numel():
        raise ValueError(f"packed GAT weights hold {flat.numel()} values, "
                         f"the dims need {off}")
    return out


def _leaky(v: torch.Tensor, a: float) -> torch.Tensor:
    return torch.where(v >= 0, v, a * v)


def shortcut(x: torch.Tensor, sc, nh: int, d: int) -> torch.Tensor:
    """The residual shortcut of a layer on its input rows x [N, d_in]
    (``mpe3d_tpu/models/gat.py::_residual_val`` :112): x @ wr (+ br) as
    [N, nh, d] where the layer has a projection (sc = (wr, br or None)),
    else x broadcast over the heads (sc = "identity", d_in == d)."""
    if isinstance(sc, str):
        return x[:, None, :]
    wr, br = sc
    r = x @ wr
    return (r if br is None else r + br).view(-1, nh, d)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout, torch semantics (``nn.Dropout``; the reference's
    ``mpe3d_tpu/models/gat.py::_dropout`` :125): each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the draws from
    ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def gat_stack_plain(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
                    flat: torch.Tensor, dims: Dims, alpha: float,
                    slope: float, edge_const: bool = False,
                    proj=proj_plain, bias: bool = True,
                    shortcuts=None) -> torch.Tensor:
    """Plain PyTorch version: x [H+E, in_dim], pw [E] -> logits [E], the
    packed weights ``flat`` through ``gat_layers``.  ``bias`` off: the
    packed biases (zeros) are left out of the projection."""
    layers = layer_views(flat, dims)
    if not bias:
        layers = [(w1, None, w2, None, al, ar)
                  for w1, _, w2, _, al, ar in layers]
    return gat_layers(x, pw, topo, layers, dims, alpha, slope, edge_const,
                      proj, shortcuts)


def gat_layers(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
               layers, dims: Dims, alpha: float, slope: float,
               edge_const: bool = False, proj=proj_plain, shortcuts=None,
               generator: Optional[torch.Generator] = None,
               feat_drop: float = 0.0,
               attn_drop: float = 0.0) -> torch.Tensor:
    """The GAT stack's math in plain PyTorch, differentiable: x [H+E,
    in_dim], pw [E] -> logits [E]; ``layers``: per layer (w1, b1, w2, b2,
    attn_l, attn_r), a bias None where the matcher has none.  Each layer
    projects its rows with ``proj(x, w1, b1, w2, b2, alpha)``: the plain
    fc1 -> LeakyReLU -> fc2, or the fused projection kernel
    (``ops/fused_proj.py``) in the per-layer form (``models/gat.py``).
    ``shortcuts`` (a residual matcher): per layer None or the residual
    shortcut (``shortcut``) added to its head and edge outputs.  Under
    ``edge_const`` layer 0 projects rows 0..H and gives every edge row H's
    projection.

    Training (``models/gat.py::TrainableMatcher``): the head softmax's max
    shift is a constant of the softmax, so it is detached and no gradient
    flows in it.  Dropout draws from ``generator`` (the reference's
    ``_gat_layer``, ``mpe3d_tpu/models/gat.py`` :162-165, :218-259):
    ``feat_drop`` on each layer's input rows (the shortcut reads the dropped
    rows), ``attn_drop`` on the normalised attention coefficients, summed
    without renormalising; not with ``edge_const``, since dropped edge rows
    differ."""
    H, E = topo.n_heads, topo.n_pairs
    e1, e2 = topo.e1.long(), topo.e2.long()
    inc = topo.inc.long()
    pw_inc = pw[inc]                                          # [H, D]
    live = (pw_inc > 0)[..., None]                            # [H, D, 1]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    for l, ((d_in, d, nh), (w1, b1, w2, b2, al, ar)) in enumerate(
            zip(dims, layers)):
        sc = None if shortcuts is None else shortcuts[l]
        if feat_drop > 0.0:
            x = dropout(x, feat_drop, generator)
        if edge_const and l == 0:
            z = proj(x[:H + 1], w1, b1, w2, b2, alpha)
            z = torch.cat([z[:H], z[H:].expand(E, -1)])       # [N, F]
        else:
            z = proj(x, w1, b1, w2, b2, alpha)                # [N, F]
        zr = z.view(-1, nh, d)
        a1 = (zr * al).sum(-1)                                # [N, nh]
        a2 = (zr * ar).sum(-1)
        zh, ze = zr[:H], zr[H:]
        a1h, a2h, a1e, a2e = a1[:H], a2[:H], a1[H:], a2[H:]

        # edge destinations: softmax over {self, head1, head2}
        logits = torch.stack([_leaky(a1e + a2e, alpha),
                              _leaky(a1h[e1] + a2e, alpha),
                              _leaky(a1h[e2] + a2e, alpha)], -1)
        att = torch.softmax(logits, -1)                       # [E, nh, 3]
        if attn_drop > 0.0:
            att = dropout(att, attn_drop, generator)
        out_e = (att[..., 0:1] * ze + att[..., 1:2] * zh[e1]
                 + att[..., 2:3] * zh[e2])                    # [E, nh, d]
        if sc is not None:
            r = shortcut(x, sc, nh, d)
            out_e = out_e + r[H:]
        if l == len(dims) - 1:
            return out_e.reshape(E)

        # head destinations: self + live incident edges, exact max shift
        ls = _leaky(a1h + a2h, alpha)                         # [H, nh]
        li = torch.where(live, _leaky(a1e[inc] + a2h[:, None], alpha), neg)
        m = torch.maximum(ls, li.amax(1)).detach()
        es = torch.exp(ls - m)
        xw = torch.exp(li - m[:, None]) * pw_inc[..., None]   # [H, D, nh]
        denom = es + xw.sum(1)
        if attn_drop > 0.0:
            cs = dropout(es / denom, attn_drop, generator)
            cw = dropout(xw / denom[:, None], attn_drop, generator)
            out_h = cs[..., None] * zh + (cw[..., None] * ze[inc]).sum(1)
        else:
            num = es[..., None] * zh + (xw[..., None] * ze[inc]).sum(1)
            out_h = num / denom[..., None]                    # [H, nh, d]
        if sc is not None:
            out_h = out_h + r[:H]
        x = _leaky(torch.cat([out_h.reshape(H, -1), out_e.reshape(E, -1)]),
                   slope)
    raise ValueError("empty layer list")


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"gat_stack: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gat_stack: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


@functools.lru_cache(maxsize=64)
def _host_args(H: int, E: int, dims: Tuple[Tuple[int, int, int], ...],
               edge_const: bool, n_sm: int):
    """The host arrays of ``gat_stack_forward``: dims (d_in, d, nh a layer)
    and the k-splits of each layer's fc1 and fc2 (the tile plan)."""
    plans = layer_plans(H, E, dims, edge_const, n_sm)
    splits = [v for p in plans for v in (p.fc1.splits, p.fc2.splits)]
    return ((ctypes.c_int * (3 * len(dims)))(*[v for t in dims for v in t]),
            (ctypes.c_int * len(splits))(*splits))


def gat_stack(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
              flat: torch.Tensor, dims: Dims, alpha: float,
              slope: float, edge_const: bool = False) -> torch.Tensor:
    """GAT logits [E] for x [H+E, in_dim] and pair weights pw [E]: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors.
    ``edge_const``: every edge row of x is the same vector (stated by the
    caller), so layer 0 projects the heads and one edge row."""
    if x.device.type == "cpu":
        return gat_stack_plain(x, pw, topo, flat, dims, alpha, slope,
                               edge_const)
    if x.device.type != "cuda":
        raise ValueError(f"gat_stack: unsupported device {x.device}")
    H, E = topo.n_heads, topo.n_pairs
    if topo.inc is None:
        raise ValueError("gat_stack: the topology has no incidence list")
    N, D = H + E, topo.inc.shape[1]
    if D > MAX_D:
        raise ValueError(f"gat_stack: the kernel serves heads of at most "
                         f"{MAX_D} incident edges, got {D}; serve this "
                         f"bucket through ops/gat_tiled.py")
    dev = x.device
    _check(x, "x", torch.float32, (N, dims[0][0]), dev)
    _check(pw, "pw", torch.float32, (E,), dev)
    _check(topo.e1, "e1", torch.int32, (E,), dev)
    _check(topo.e2, "e2", torch.int32, (E,), dev)
    _check(topo.inc, "inc", torch.int32, (H, D), dev)
    n_w = sum(d_in * d_in + d_in + d_in * nh * d + 3 * nh * d
              for d_in, d, nh in dims)
    _check(flat, "weights", torch.float32, (n_w,), dev)
    dims_c, splits_c = _host_args(H, E, tuple(map(tuple, dims)),
                                  bool(edge_const), sm_count(dev.index))
    # one scratch allocation: h1 [N, ldh] (16-byte rows), z, xa, xb [N, F]
    ldh = -(-max(d_in for d_in, _, _ in dims) // 4) * 4
    max_f = max(nh * d for _, d, nh in dims)
    buf = torch.empty(N * (ldh + 3 * max_f), dtype=torch.float32,
                      device=dev)
    z, xa, xb = (buf.data_ptr() + 4 * N * (ldh + i * max_f)
                 for i in range(3))
    out = torch.empty((E,), dtype=torch.float32, device=dev)
    code = _build.library().cdll.gat_stack_forward(
        x.data_ptr(), pw.data_ptr(), topo.e1.data_ptr(), topo.e2.data_ptr(),
        topo.inc.data_ptr(), flat.data_ptr(), dims_c, splits_c, len(dims), H,
        E, D, int(bool(edge_const)), alpha, slope, buf.data_ptr(), z, xa, xb,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gat_stack_forward")
    gat_stack.launches += 1
    return out


gat_stack.launches = 0
