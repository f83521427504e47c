"""The lifter MLP's bf16 layers: a hand-written CUDA kernel and its plain
version.

Replaces the bf16 layer kind of the TPU kernel
``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call`` (:57, ``pallas_call`` at
:143; entry ``fused_mlp_forward`` :223, packing ``pack_fused_layers`` :154).
The int8 layer kind (``fused_mlp.py:80-83, 93, 126``) serves the int8 demo
lifters and is not ported yet.

Per layer: ``acc = bf16(x) @ w_bf16`` in fp32, ``+ b``, LeakyReLU on all but
the last layer.  Activations stay fp32 between layers and are rounded to
bf16 (round to nearest even) as operands, as ``fused_mlp.py:114-117`` does.

Bound on an H100 SXM for the 29.1 M-param serving lifter: 58.3 MB of bf16
weights streamed once per frame, 17.4 us at 3.35 TB/s; its 0.47 GFLOP at
8 rows is 0.5 us of the bf16 tensor-core peak.  The CUDA version
(``csrc/fused_mlp.cu``) reads every weight byte once with coalesced 16-byte
loads, 16 output columns per block, and is launched once per layer
(9 launches per frame).

Weights are packed once (``pack_layer``): the output width is padded to a
multiple of 16 with zero columns and zero bias, so padded outputs are exact
zeros, and each layer's input width matches the previous padded output.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from mpe3d_tpu_torch.ops import _build

COLS = 16        # output-column slab of one CUDA block
MAX_ROWS = 16    # activation rows the kernel serves

Layer = Tuple[torch.Tensor, torch.Tensor]    # (w [Kp, Np] bf16, b [Np] fp32)


def pack_layer(w: torch.Tensor, b: torch.Tensor, k_in: int) -> Layer:
    """Pad w [K, N] (bf16) / b [N] to [k_in, Np] / [Np], Np = N rounded up to
    a multiple of 16; ``k_in`` >= K is the previous layer's padded width."""
    K, N = w.shape
    n_p = -(-N // COLS) * COLS
    if k_in < K:
        raise ValueError(f"layer input width {K} exceeds the previous "
                         f"layer's padded width {k_in}")
    wp = torch.zeros((k_in, n_p), dtype=torch.bfloat16, device=w.device)
    wp[:K, :N] = w.to(torch.bfloat16)
    bp = torch.zeros((n_p,), dtype=torch.float32, device=b.device)
    bp[:N] = b.to(torch.float32)
    return wp, bp


def mlp_layer_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    slope: float, act: bool) -> torch.Tensor:
    """Plain version of one layer: bf16-rounded operands, fp32 products and
    sums (bf16 x bf16 products are exact in fp32)."""
    y = x.to(torch.bfloat16).float() @ w.float() + b
    return torch.where(y >= 0, y, slope * y) if act else y


def mlp_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              slope: float, act: bool) -> torch.Tensor:
    """One layer, x [M <= 16, Kp] fp32 -> [M, Np] fp32: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return mlp_layer_plain(x, w, b, slope, act)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_layer: unsupported device {x.device}")
    M, K = x.shape
    if not (1 <= M <= MAX_ROWS):
        raise ValueError(f"mlp_layer serves 1..{MAX_ROWS} rows, got {M}")
    if w.dim() != 2 or w.shape[0] != K or w.shape[1] % COLS:
        raise ValueError(f"mlp_layer: weight shape {tuple(w.shape)} does not "
                         f"fit x {tuple(x.shape)} (N must be a multiple of "
                         f"{COLS})")
    N = w.shape[1]
    for t, name, dtype in ((x, "x", torch.float32), (w, "w", torch.bfloat16),
                           (b, "b", torch.float32)):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"mlp_layer: {name} must be a contiguous {dtype} "
                             f"tensor on {x.device}")
    if b.shape != (N,):
        raise ValueError(f"mlp_layer: bias shape {tuple(b.shape)} != ({N},)")
    if w.data_ptr() % 16:
        raise ValueError("mlp_layer: weights must be 16-byte aligned")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    code = _build.library().cdll.mlp_bf16_layer(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, K, N,
        slope, int(act), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "mlp_bf16_layer")
    mlp_layer.launches += 1
    return y


mlp_layer.launches = 0


def fused_mlp_forward(x: torch.Tensor, layers: List[Layer], slope: float,
                      out_dim: int) -> torch.Tensor:
    """The whole packed MLP: x [M, K0] -> [M, out_dim] fp32."""
    h = x.to(torch.float32).contiguous()
    for i, (w, b) in enumerate(layers):
        h = mlp_layer(h, w, b, slope, act=i < len(layers) - 1)
    return h[:, :out_dim]
