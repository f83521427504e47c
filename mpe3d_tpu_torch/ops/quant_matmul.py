"""int8 weight-only layers of the lifter: a hand-written CUDA kernel and its
plain version.

Replaces the TPU kernels ``mpe3d_tpu/ops/quant_matmul.py::
_pallas_int8_matmul`` (:73, ``pallas_call`` at :94; entry
``int8_weight_matmul`` :109) and the int8 layer kind of
``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call`` (:80-83, :93, :126), which
compute the same layer:

    out = ((x * rscale) -> bf16 @ wq -> bf16, fp32 sums) * scale + b

then LeakyReLU(alpha) when ``alpha`` is given.  ``wq`` [K, N] is int8
(int8 -> bf16 is exact for |q| <= 127), ``scale`` [N] the per-output-column
scale applied after the sums, ``rscale`` [K] the per-input-row scale of the
two-sided quantisation (``models/mlp.py::quantize_lifter_weights``), folded
into the fp32 activation before its bf16 rounding.  A ``wq`` with more rows
than x has columns (K padded at packing) reads the extra x columns as
exact zeros.

Bound, numerics and design of the CUDA version: ``csrc/int8_mlp.cu``.  It
takes any row count (16-row tiles), N a multiple of 32 (``COLS``) and any K.

``int8_weight_matmul`` takes the plain version for CPU tensors and launches
the kernel (``mlp_int8_layer``) for CUDA tensors; ``mlp_int8_layer.launches``
counts the kernel calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpe3d_tpu_torch.ops import _build

COLS = 32        # output-column slab of one CUDA block


def _fold(x: torch.Tensor, K: int,
          rscale: Optional[torch.Tensor]) -> torch.Tensor:
    """x [M, Kx] fp32 times rscale [Kx] (fp32), zero-padded to K >= Kx
    columns."""
    x = x.to(torch.float32)
    if rscale is not None:
        x = x * rscale.to(torch.float32)
    if K < x.shape[-1]:
        raise ValueError(f"int8 layer: x has {x.shape[-1]} columns, wq "
                         f"only {K} rows")
    return torch.nn.functional.pad(x, (0, K - x.shape[-1]))


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      b: Optional[torch.Tensor] = None,
                      alpha: Optional[float] = None,
                      rscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version (``xla_int8_matmul`` :44): the bf16-rounded folded
    activation times the exact fp32 value of each int8 weight, fp32 sums;
    then ``* scale``, ``+ b`` and the LeakyReLU as separate roundings."""
    xb = _fold(x, wq.shape[0], rscale).to(torch.bfloat16).to(torch.float32)
    out = (xb @ wq.to(torch.float32)) * scale
    if b is not None:
        out = out + b
    if alpha is not None:
        out = torch.where(out > 0, out, alpha * out)
    return out


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"mlp_int8_layer: {name} must be a contiguous "
                         f"{dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mlp_int8_layer: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")


def mlp_int8_layer(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   b: Optional[torch.Tensor], alpha: Optional[float],
                   rscale: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [M, K] fp32, wq [K, N] int8 with
    N a multiple of 32, scale [N], b [N] or None, rscale [K] or None."""
    dev = x.device
    if x.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"mlp_int8_layer: x {tuple(x.shape)} and wq "
                         f"{tuple(wq.shape)} must be matrices")
    M, K = x.shape
    N = wq.shape[1]
    if M < 1 or N < COLS or N % COLS:
        raise ValueError(f"mlp_int8_layer: M={M} rows, N={N} columns (N "
                         f"must be a positive multiple of {COLS})")
    _check(x, "x", torch.float32, (M, K), dev)
    _check(wq, "wq", torch.int8, (K, N), dev)
    _check(scale, "scale", torch.float32, (N,), dev)
    if b is not None:
        _check(b, "b", torch.float32, (N,), dev)
    if rscale is not None:
        _check(rscale, "rscale", torch.float32, (K,), dev)
    if wq.data_ptr() % 8:
        raise ValueError("mlp_int8_layer: wq must be 8-byte aligned")
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    code = _build.library().cdll.mlp_int8_layer(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), ptr(rscale), ptr(b),
        y.data_ptr(), M, K, N, 0.0 if alpha is None else alpha,
        int(alpha is not None), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "mlp_int8_layer")
    mlp_int8_layer.launches += 1
    return y


mlp_int8_layer.launches = 0


def int8_weight_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       alpha: Optional[float] = None,
                       rscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = leaky(((x * rscale) @ wq) * scale + b, alpha) for x [M, K] and
    wq [K, N] int8 (LeakyReLU only when ``alpha`` is given): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale, b, alpha, rscale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: unsupported device {x.device}")
    return mlp_int8_layer(x, wq, scale, b, alpha, rscale)
