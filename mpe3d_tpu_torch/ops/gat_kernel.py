"""The GAT matcher stack: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``mpe3d_tpu/ops/gat_kernel.py::_gat_megakernel``
(:206, ``pallas_call`` at :232; entry ``apply_matcher_pallas`` :272, body
``gat_stack_values`` :95-200): the whole alt-3 GAT stack of one frame,
inference only (no dropout, no residual).

Bound on an H100 SXM at the serving bucket (H=20 heads, E=160 pairs,
902-dim input, the 1.96 M-weight 5-layer stack): 0.70 GFLOP of fp32 FMA
(180 rows x 2 x 1.96 M weights) is 10.5 us at the 67 TFLOP/s
non-tensor-core peak, against 2.3 us for the 7.8 MB of weights at
3.35 TB/s: compute-bound.  The CUDA version (``csrc/gat_stack.cu``) is the
simple, right first form: a tiled GEMM of fp32 operands with fp64 sums and
a fused bias + LeakyReLU epilogue for fc1/fc2 and three small attention
kernels per layer (attention terms and head sums also in fp64), 24
launches from one host call; no tensor cores and no TF32, because rounded
operands move scores across the decision threshold.

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
from typing import List, NamedTuple, Optional, Tuple

import torch

from mpe3d_tpu_torch.ops import _build
from mpe3d_tpu_torch.ops.fused_proj import proj_plain

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


def gat_stack_plain(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
                    flat: torch.Tensor, dims: Dims, alpha: float,
                    slope: float, proj=proj_plain) -> torch.Tensor:
    """Plain PyTorch version: x [H+E, in_dim], pw [E] -> logits [E].  Each
    layer projects all rows with ``proj(x, w1, b1, w2, b2, alpha)``: the
    plain fc1 -> LeakyReLU -> fc2, or the fused projection kernel
    (``ops/fused_proj.py``) in the per-layer form (``models/gat.py``)."""
    H, E = topo.n_heads, topo.n_pairs
    e1, e2 = topo.e1.long(), topo.e2.long()
    inc = topo.inc.long()
    pw_inc = pw[inc]                                          # [H, D]
    live = (pw_inc > 0)[..., None]                            # [H, D, 1]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    layers = layer_views(flat, dims)
    for l, ((d_in, d, nh), (w1, b1, w2, b2, al, ar)) in enumerate(
            zip(dims, layers)):
        z = proj(x, w1, b1, w2, b2, alpha)                    # [N, F]
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
        out_e = (att[..., 0:1] * ze + att[..., 1:2] * zh[e1]
                 + att[..., 2:3] * zh[e2])                    # [E, nh, d]
        if l == len(dims) - 1:
            return out_e.reshape(E)

        # head destinations: self + live incident edges, exact max shift
        ls = _leaky(a1h + a2h, alpha)                         # [H, nh]
        li = torch.where(live, _leaky(a1e[inc] + a2h[:, None], alpha), neg)
        m = torch.maximum(ls, li.amax(1))
        es = torch.exp(ls - m)
        xw = torch.exp(li - m[:, None]) * pw_inc[..., None]   # [H, D, nh]
        denom = es + xw.sum(1)
        num = es[..., None] * zh + (xw[..., None] * ze[inc]).sum(1)
        out_h = num / denom[..., None]                        # [H, nh, d]
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


def gat_stack(x: torch.Tensor, pw: torch.Tensor, topo: GatTopology,
              flat: torch.Tensor, dims: Dims, alpha: float,
              slope: float) -> torch.Tensor:
    """GAT logits [E] for x [H+E, in_dim] and pair weights pw [E]: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return gat_stack_plain(x, pw, topo, flat, dims, alpha, slope)
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
    max_in = max(d_in for d_in, _, _ in dims)
    max_f = max(nh * d for _, d, nh in dims)
    max_nh = max(nh for _, _, nh in dims)
    h1 = torch.empty((N, max_in), dtype=torch.float32, device=dev)
    z = torch.empty((N, max_f), dtype=torch.float32, device=dev)
    xa = torch.empty_like(z)
    xb = torch.empty_like(z)
    att = torch.empty((N, 2 * max_nh), dtype=torch.float32, device=dev)
    out = torch.empty((E,), dtype=torch.float32, device=dev)
    dims_c = (ctypes.c_int * (3 * len(dims)))(*[v for t in dims for v in t])
    lib = _build.library().cdll
    code = lib.gat_stack_forward(
        x.data_ptr(), pw.data_ptr(), topo.e1.data_ptr(), topo.e2.data_ptr(),
        topo.inc.data_ptr(), flat.data_ptr(), dims_c, len(dims), H, E, D,
        alpha, slope, h1.data_ptr(), z.data_ptr(), att.data_ptr(),
        xa.data_ptr(), xb.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gat_stack_forward")
    gat_stack.launches += 1
    return out


gat_stack.launches = 0
