"""The GAT layer's fused projection fc1 -> LeakyReLU -> fc2: a hand-written
CUDA kernel and its plain version.

Replaces the TPU kernel ``mpe3d_tpu/ops/fused_proj.py::_pallas_proj`` (:48,
``pallas_call`` at :68; entry ``fused_linear_leaky_linear`` :84, plain
form ``xla_proj`` :32): ``out = leaky(x @ w1 + b1, alpha) @ w2 + b2`` for
x [N, D], w1 [D, D], w2 [D, F], fp32.  It is the projection of the
per-layer GAT form (``models/gat.py``, form ``"layer"``), one call a layer
on the concatenated head and edge rows.

The CUDA version (``csrc/fused_proj.cu``) runs both products in one launch
with the intermediate in shared memory, fp32 operands and fp64 sums; bound
and design there.  ``fused_linear_leaky_linear`` takes the plain version
for CPU tensors and launches the kernel for CUDA tensors;
``fused_linear_leaky_linear.launches`` counts the kernel calls.
"""

from __future__ import annotations

import torch

from mpe3d_tpu_torch.ops import _build

MAX_D = 1024     # input width the kernel stages in shared memory


def proj_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """Plain version (``xla_proj``): fp32 products and sums."""
    h = x @ w1 + b1
    return torch.where(h >= 0, h, alpha * h) @ w2 + b2


def _check(t: torch.Tensor, name: str, shape, device):
    if (t.device != device or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"fused_linear_leaky_linear: {name} must be a "
                         f"contiguous float32 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_linear_leaky_linear: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")


def fused_linear_leaky_linear(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor, alpha: float) -> torch.Tensor:
    """leaky(x @ w1 + b1, alpha) @ w2 + b2 for x [N, D], w1 [D, D],
    w2 [D, F]: the plain version for CPU tensors, the CUDA kernel (one
    launch) for CUDA tensors."""
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
    if N < 1 or not 1 <= D <= MAX_D:
        raise ValueError(f"fused_linear_leaky_linear: N={N} rows, D={D} "
                         f"(the kernel takes 1..{MAX_D})")
    for t, name, shape in ((x, "x", (N, D)), (w1, "w1", (D, D)),
                           (b1, "b1", (D,)), (w2, "w2", (D, F)),
                           (b2, "b2", (F,))):
        _check(t, name, shape, dev)
    out = torch.empty((N, F), dtype=torch.float32, device=dev)
    code = _build.library().cdll.gat_fused_proj(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), N, D, F, alpha,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gat_fused_proj")
    fused_linear_leaky_linear.launches += 1
    return out


fused_linear_leaky_linear.launches = 0
