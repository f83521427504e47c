"""The lifter MLP's layers: the bf16 layer kernel, its plain version, and
the walk over a packed, mixed layer list.

Replaces the bf16 layer kind of the TPU kernel
``mpe3d_tpu/ops/fused_mlp.py::_fused_mlp_call`` (:57, ``pallas_call`` at
:143; entry ``fused_mlp_forward`` :223, packing ``pack_fused_layers`` :154).
Its int8 layer kind (``fused_mlp.py:80-83, 93, 126``) runs in
``ops/quant_matmul.py`` (kernel ``mlp_int8_layer``).

A packed lifter is a list of layers of three kinds:

* ``Bf16Layer``: ``acc = bf16(x) @ w_bf16`` in fp32, ``+ b`` (the kernel
  ``mlp_bf16_layer`` below);
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
(``csrc/fused_mlp.cu``) reads every weight byte once with coalesced 16-byte
loads, 16 output columns per block, and is launched once per layer
(9 launches per frame).

Weights are packed once (``pack_layer``, ``pack_int8_layer``,
``pack_fp32_layer``): the output width is padded to the kernel's column
slab (16 for bf16, 32 for int8) with zero columns, zero scales and zero
bias, so padded outputs are exact zeros, and each layer's input width K
matches the previous layer's padded output with zero rows (zero row scales
for int8: the counterpart of ``models/mlp.py::prepad_quantized_lifter``
:248; the kernels need no other K alignment).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch

from mpe3d_tpu_torch.ops import _build, quant_matmul

COLS = 16        # output-column slab of one CUDA block
MAX_ROWS = 16    # activation rows the kernel serves


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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


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


def fp32_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               slope: float, act: bool) -> torch.Tensor:
    """One fp32 layer (``apply_lifter`` :120-126 without compute_dtype):
    ``torch.matmul`` in fp32 (TF32 off), ``+ b``, LeakyReLU."""
    y = x @ w + b
    return torch.where(y >= 0, y, slope * y) if act else y


def _walk(x, layers, slope, out_dim, bf16_fn, int8_fn):
    h = x.to(torch.float32).contiguous()
    for i, layer in enumerate(layers):
        act = i < len(layers) - 1
        if isinstance(layer, Int8Layer):
            h = int8_fn(h, layer.wq, layer.scale, layer.b,
                        slope if act else None, layer.rscale)
        elif isinstance(layer, Fp32Layer):
            h = fp32_layer(h, layer.w, layer.b, slope, act)
        else:
            h = bf16_fn(h, layer[0], layer[1], slope, act)
    return h[:, :out_dim]


def fused_mlp_forward(x: torch.Tensor, layers: List[Layer], slope: float,
                      out_dim: int) -> torch.Tensor:
    """The whole packed MLP, x [M, K0] -> [M, out_dim] fp32: each layer
    through its kind's entry (kernel on CUDA tensors, plain on CPU ones)."""
    return _walk(x, layers, slope, out_dim, mlp_layer,
                 quant_matmul.int8_weight_matmul)


def fused_mlp_plain(x: torch.Tensor, layers: List[Layer], slope: float,
                    out_dim: int) -> torch.Tensor:
    """Plain version of ``fused_mlp_forward`` on any device."""
    return _walk(x, layers, slope, out_dim, mlp_layer_plain,
                 quant_matmul.int8_matmul_plain)
