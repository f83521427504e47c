"""int8 weight-only layers of the lifter: the entry that runs one on the
card, and its plain version.

Replaces the TPU kernel ``mpe3d_tpu/ops/quant_matmul.py::
_pallas_int8_matmul`` (:73, ``pallas_call`` at :94; entry
``int8_weight_matmul`` :109), which computes the int8 layer kind of
``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call`` (:80-83, :93, :126) alone:

    out = ((x * rscale) -> bf16 @ wq -> bf16, fp32 sums) * scale + b

then LeakyReLU(alpha) when ``alpha`` is given.  ``wq`` [K, N] is int8
(int8 -> bf16 is exact for |q| <= 127), ``scale`` [N] the per-output-column
scale applied after the sums, ``rscale`` [K] the per-input-row scale of the
two-sided quantisation (``models/mlp.py::quantize_lifter_weights``), folded
into the fp32 activation before its bf16 rounding.  A ``wq`` with more rows
than x has columns (K padded at packing) reads the extra x columns as
exact zeros.

On the card the layer is a run of one int8 layer of the lifter's run kernel
(``ops/fused_mlp.py::mlp_run``, ``csrc/fused_mlp.cu``), one launch for each
group of at most 64 rows, each streaming the weights once (the TPU kernel
holds all M rows in one block): ``int8_weight_matmul`` packs ``wq`` into
the kernel's fragment order at each call, ``int8_layer_matmul`` takes a layer
packed once (``fused_mlp.pack_int8_layer``).  Both take the plain version
for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch


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


def int8_layer_matmul(x: torch.Tensor, layer, alpha: Optional[float],
                      ) -> torch.Tensor:
    """One packed int8 layer (``fused_mlp.Int8Layer``) on x [M, K] for any
    M, [M, Np] fp32: its plain version for CPU tensors; for CUDA tensors
    one launch of the run kernel for each group of at most 64 rows."""
    from mpe3d_tpu_torch.ops import fused_mlp
    act = alpha is not None
    slope = alpha if act else 0.0
    if x.device.type == "cpu":
        return fused_mlp.layer_plain(x, layer, slope, act)
    if x.device.type != "cuda":
        raise ValueError(f"int8_layer_matmul: unsupported device {x.device}")
    x = x.to(torch.float32).contiguous()
    rows = fused_mlp.MAX_ROWS
    return torch.cat([fused_mlp.mlp_run(x[m:m + rows], [layer], slope, [act])
                      for m in range(0, x.shape[0], rows)])


def int8_weight_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       alpha: Optional[float] = None,
                       rscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = leaky(((x * rscale) @ wq) * scale + b, alpha) for x [M, K] and
    wq [>= K, N] int8 (LeakyReLU only when ``alpha`` is given): the plain
    version for CPU tensors; for CUDA tensors the layer packed for the run
    kernel (the weight rows past K, which meet only zeros, left out; a
    missing bias as zeros) and ``int8_layer_matmul``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale, b, alpha, rscale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul: unsupported device {x.device}")
    from mpe3d_tpu_torch.ops import fused_mlp
    K, N = x.shape[1], wq.shape[1]
    if wq.dim() != 2 or wq.shape[0] < K:
        raise ValueError(f"int8_weight_matmul: x has {K} columns, wq is "
                         f"{tuple(wq.shape)}")
    if b is None:
        b = torch.zeros(N, dtype=torch.float32, device=x.device)
    layer = fused_mlp.pack_int8_layer(wq[:K], scale, rscale, b, K)
    return int8_layer_matmul(x, layer, alpha)[:, :N]
