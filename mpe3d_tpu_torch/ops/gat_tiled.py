"""The grid-tiled GAT matcher stack for crowded buckets: two hand-written
CUDA kernels per layer and their plain version.

Replaces the TPU kernels ``mpe3d_tpu/ops/gat_tiled.py::_k1_layer`` (:86,
``pallas_call`` at :194) and ``::_k2_layer`` (:225, ``pallas_call`` at
:268), with their callers ``gat_stack_tiled`` (:293) and
``apply_matcher_tiled`` (:363): the alt-3 GAT stack, inference only, for
buckets the whole-stack form (``ops/gat_kernel.py``) does not serve
(E >= 1000 pairs, heads of more than 64 incident edges, compacted pruned
edge sets).  Per layer:

* K1: the fc1 -> LeakyReLU(alpha) -> fc2 projection (heads and edges; with
  ``edge_const`` the shared edge row once, ``gat_tiled.py:310-313``), the
  attention terms, the edge-destination softmax over {self, head e1,
  head e2}, the masked head-destination logits ``l1m``/``l2m`` [E, nh] and
  the masked per-head max ``m`` [H, nh];
* K2: the exp-shifted edge weights, the head sums ``den`` [H, nh] and
  ``num`` [H, F], and the epilogue ``out_h = (es zh + num) / (es + den)``
  (XLA glue in the reference, :350-358).

The last layer (F = 1) runs K1 alone and gives the edge logits.  Both
versions gather endpoints by index and sum each head's incident edges in
ascending edge order; the TPU form's 0/1 incidence matmuls exist for Mosaic
and are not copied.  The kernels take fp32 operands and accumulate their
sums in fp64 (one rounding to fp32 per sum); the plain version computes in
fp32 as the reference does.

Bound on an H100 SXM at Panoptic S=16 (H=80, E=2560) under ``edge_const``:
K1's fc products, 4.31 GFLOP (81 rows at layer 0, 2640 at layers 1-4), are
64.3 us at 67 TFLOP/s, the fp64 tensor-core peak: compute-bound.  K1 runs
them on the fp64 tensor cores (the GEMM shared with the stack kernel and
the projection, ``csrc/f64_mma.cuh``), unsplit at layers 1-4 (42 x 7 tiles
at fc1) and with k split over thread-block clusters at layer 0 (2 row
tiles), the splits from the per-layer tile plan
(``ops/fused_proj.py::layer_plans``).  Precision and design: see
``csrc/gat_tiled.cu``.

``gat_stack_tiled`` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors; ``gat_k1_layer.launches`` and
``gat_k2_layer.launches`` count the kernel calls (one each per layer).
``edge_const`` is the caller's statement that every edge row of ``x`` is
the same vector (the alt-3 inference invariant); it is never inferred from
the values.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from mpe3d_tpu_torch.ops import _build
from mpe3d_tpu_torch.ops.fused_proj import layer_plans, sm_count
from mpe3d_tpu_torch.ops.gat_kernel import Dims, GatTopology, layer_views

MAX_NH, MAX_F = 16, 512      # the kernels' per-layer head and feature caps


def _leaky(v: torch.Tensor, a: float) -> torch.Tensor:
    return torch.where(v >= 0, v, a * v)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def k1_plain(x, pw, e1, e2, H, lw, nh, d, alpha, slope, last, edge_const):
    """K1 of one layer.  x [H+E, d_in]; e1/e2 [E] int64.  Returns the edge
    rows of the next activations [E, F] (the logits [E] on the last layer)
    and the state K2 reads: (z, a1, a2, l1m, l2m, m)."""
    w1, b1, w2, b2, al, ar = lw
    E = e1.shape[0]
    rows = x[:H + 1] if edge_const else x
    z = (_leaky(rows @ w1 + b1, alpha) @ w2 + b2).view(-1, nh, d)
    a1, a2 = (z * al).sum(-1), (z * ar).sum(-1)              # [rows, nh]
    zh, a1h, a2h = z[:H], a1[:H], a2[:H]
    if edge_const:
        ze, a1e, a2e = (t[H:].expand(E, *t.shape[1:]) for t in (z, a1, a2))
    else:
        ze, a1e, a2e = z[H:], a1[H:], a2[H:]
    logits = torch.stack([_leaky(a1e + a2e, alpha),
                          _leaky(a1h[e1] + a2e, alpha),
                          _leaky(a1h[e2] + a2e, alpha)], -1)
    att = torch.softmax(logits, -1)                           # [E, nh, 3]
    out_e = (att[..., 0:1] * ze + att[..., 1:2] * zh[e1]
             + att[..., 2:3] * zh[e2])                        # [E, nh, d]
    if last:
        return out_e.reshape(E), None
    live = (pw > 0)[:, None]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    l1m = torch.where(live, _leaky(a1e + a2h[e1], alpha), neg)
    l2m = torch.where(live, _leaky(a1e + a2h[e2], alpha), neg)
    m = _leaky(a1h + a2h, alpha)                              # [H, nh]
    for idx, lm in ((e1, l1m), (e2, l2m)):
        m = m.scatter_reduce(0, idx[:, None].expand(-1, nh), lm,
                             reduce="amax", include_self=True)
    return (_leaky(out_e.reshape(E, -1), slope),
            (z, a1, a2, l1m, l2m, m))


def k2_plain(state, pw, e1, e2, H, nh, d, alpha, slope, edge_const):
    """K2 of one layer: the head rows of the next activations [H, F]."""
    z, a1, a2, l1m, l2m, m = state
    E = e1.shape[0]
    zh = z[:H]
    ze = z[H:].expand(E, nh, d) if edge_const else z[H:]
    x1 = torch.exp(l1m - m[e1]) * pw[:, None]                 # [E, nh]
    x2 = torch.exp(l2m - m[e2]) * pw[:, None]
    den = torch.zeros_like(m).index_add_(0, e1, x1).index_add_(0, e2, x2)
    num = (torch.zeros_like(zh).index_add_(0, e1, x1[..., None] * ze)
           .index_add_(0, e2, x2[..., None] * ze))            # [H, nh, d]
    es = torch.exp(_leaky(a1[:H] + a2[:H], alpha) - m)
    out_h = (es[..., None] * zh + num) / (es + den)[..., None]
    return _leaky(out_h.reshape(H, -1), slope)


def gat_stack_tiled_plain(x: torch.Tensor, pw: torch.Tensor,
                          topo: GatTopology, flat: torch.Tensor, dims: Dims,
                          alpha: float, slope: float,
                          edge_const: bool = False) -> torch.Tensor:
    """Plain PyTorch version: x [H+E, in_dim], pw [E] -> logits [E]."""
    return _plain_stack(x, pw, topo, flat, dims, alpha, slope, edge_const,
                        None)


def _plain_stack(x, pw, topo, flat, dims, alpha, slope, edge_const, record):
    H = topo.n_heads
    e1, e2 = topo.e1.long(), topo.e2.long()
    for l, ((_, d, nh), lw) in enumerate(zip(dims, layer_views(flat, dims))):
        last = l == len(dims) - 1
        const = edge_const and l == 0
        k1_args = (x, pw, e1, e2, H, lw, nh, d, alpha, slope, last, const)
        xe, state = k1_plain(*k1_args)
        if record is not None:
            record[0].append(lambda a=k1_args: k1_plain(*a))
        if last:
            return xe
        k2_args = (state, pw, e1, e2, H, nh, d, alpha, slope, const)
        xh = k2_plain(*k2_args)
        if record is not None:
            record[1].append(lambda a=k2_args: k2_plain(*a))
        x = torch.cat([xh, xe])
    raise ValueError("empty layer list")


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"gat_stack_tiled: {name} must be a contiguous "
                         f"{dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gat_stack_tiled: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")


def gat_k1_layer(*args) -> None:
    """Launch K1 of one layer (arguments of ``gat_k1_layer`` in
    ``csrc/gat_tiled.cu``, pointers as ints, the stream last)."""
    _build.check(_build.library().cdll.gat_k1_layer(*args), "gat_k1_layer")
    gat_k1_layer.launches += 1


def gat_k2_layer(*args) -> None:
    """Launch K2 of one layer (arguments of ``gat_k2_layer``)."""
    _build.check(_build.library().cdll.gat_k2_layer(*args), "gat_k2_layer")
    gat_k2_layer.launches += 1


gat_k1_layer.launches = 0
gat_k2_layer.launches = 0

Calls = List[Callable[[], None]]


def cuda_layer_calls(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
                     flat: torch.Tensor, dims: Dims, alpha: float,
                     slope: float, edge_const: bool = False,
                     ) -> Tuple[Calls, Calls, torch.Tensor]:
    """The stack on CUDA tensors as its launches: (K1 of each layer, K2 of
    each layer but the last, the logits buffer [E]).  Running
    K1[0], K2[0], K1[1], ... in order on the current stream fills the
    logits.  Every layer writes its own activation buffer, so any launch
    can be repeated on the same inputs (for timing)."""
    H, E = topo.n_heads, topo.n_pairs
    dev = x.device
    if H < 1 or E < 1:
        raise ValueError(f"gat_stack_tiled: H={H}, E={E}")
    for _, d, nh in dims:
        if nh > MAX_NH or nh * d > MAX_F:
            raise ValueError(f"gat_stack_tiled: the kernels serve at most "
                             f"{MAX_NH} heads and {MAX_F} features a layer, "
                             f"got {nh} x {d}")
    _check(x, "x", torch.float32, (H + E, dims[0][0]), dev)
    _check(pw, "pw", torch.float32, (E,), dev)
    _check(topo.e1, "e1", torch.int32, (E,), dev)
    _check(topo.e2, "e2", torch.int32, (E,), dev)
    n_w = sum(d_in * d_in + d_in + d_in * nh * d + 3 * nh * d
              for d_in, d, nh in dims)
    _check(flat, "weights", torch.float32, (n_w,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    rows = H + E
    max_in = max(d_in for d_in, _, _ in dims)
    max_f = max(nh * d for _, d, nh in dims)
    max_nh = max(nh for _, _, nh in dims)
    h1 = torch.empty((rows, -(-max_in // 4) * 4), **f32)   # 16-byte rows
    z = torch.empty((rows, max_f), **f32)
    att = torch.empty((rows, 2 * max_nh), **f32)
    l1m = torch.empty((E, max_nh), **f32)
    l2m = torch.empty((E, max_nh), **f32)
    m = torch.empty((H, max_nh), **f32)
    out = torch.empty((E,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr()   # noqa: E731
    k1s, k2s = [], []
    # the launches read these through raw pointers: the calls keep them alive
    keep = [x, pw, topo, flat, h1, z, att, l1m, l2m, m, out]
    xin = x
    views = layer_views(flat, dims)
    plans = layer_plans(H, E, dims, edge_const, sm_count(dev.index))
    for l, ((d_in, d, nh), lw, plan) in enumerate(zip(dims, views, plans)):
        last = l == len(dims) - 1
        const = int(edge_const and l == 0)
        xout = out if last else torch.empty((rows, nh * d), **f32)
        keep.append(xout)
        k1 = (ptr(xin), *map(ptr, lw), ptr(pw), ptr(topo.e1), ptr(topo.e2),
              H, E, d_in, nh, d, const, alpha, slope, int(last),
              plan.fc1.splits, plan.fc2.splits, ptr(h1), ptr(z), ptr(att),
              ptr(l1m), ptr(l2m), ptr(m), ptr(xout), stream)
        k1s.append(lambda a=k1, _=keep: gat_k1_layer(*a))
        if not last:
            k2 = (ptr(l1m), ptr(l2m), ptr(pw), ptr(topo.e1), ptr(topo.e2),
                  ptr(z), ptr(att), ptr(m), H, E, nh, d, const, alpha, slope,
                  ptr(xout), stream)
            k2s.append(lambda a=k2, _=keep: gat_k2_layer(*a))
        xin = xout
    return k1s, k2s, out


def plain_layer_calls(x, pw, topo, flat, dims, alpha, slope,
                      edge_const=False) -> Tuple[Calls, Calls]:
    """The plain version of each K1 and K2 call of the stack, bound to the
    inputs they get in one run (for timing)."""
    record: Tuple[Calls, Calls] = ([], [])
    _plain_stack(x, pw, topo, flat, dims, alpha, slope, edge_const, record)
    return record


def gat_stack_tiled(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
                    flat: torch.Tensor, dims: Dims, alpha: float,
                    slope: float, edge_const: bool = False) -> torch.Tensor:
    """GAT logits [E] for x [H+E, in_dim] and pair weights pw [E]: the plain
    version for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type == "cpu":
        return gat_stack_tiled_plain(x, pw, topo, flat, dims, alpha, slope,
                                     edge_const)
    if x.device.type != "cuda":
        raise ValueError(f"gat_stack_tiled: unsupported device {x.device}")
    k1s, k2s, out = cuda_layer_calls(x, pw, topo, flat, dims, alpha, slope,
                                     edge_const)
    for i, k1 in enumerate(k1s):
        k1()
        if i < len(k2s):
            k2s[i]()
    return out
