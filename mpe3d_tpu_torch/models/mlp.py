"""The pose lifter MLP as an ``nn.Module`` (bf16 serving path).

Port of ``mpe3d_tpu/models/mlp.py::apply_lifter`` (:77-131) with
``compute_dtype=bfloat16`` and bf16-stored weights: bf16 operands, fp32
accumulation, LeakyReLU(negative_slope) between layers, output 18 joints x 3
in decameters.  With ``residual_prior`` the net predicts a correction to
the triangulated prior packed into its input (``extract_prior``, :59).

The layers run in ``ops/fused_mlp.py::mlp_layer``: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from mpe3d_tpu_torch.config import LifterConfig
from mpe3d_tpu_torch.ops.fused_mlp import fused_mlp_forward, pack_layer

NUMBERS_PER_JOINT = 14


def extract_prior(x: torch.Tensor, cfg: LifterConfig) -> torch.Tensor:
    """Triangulated-prior fields 11:14 of camera block 0 of a packed input,
    as an [..., out_dim] vector (decameters)."""
    J = cfg.out_dim // 3
    C = cfg.in_dim // (J * NUMBERS_PER_JOINT)
    if C * J * NUMBERS_PER_JOINT != cfg.in_dim:
        raise ValueError(f"in_dim {cfg.in_dim} is not C x {J} x 14")
    blocks = x.reshape(*x.shape[:-1], C, J, NUMBERS_PER_JOINT)
    return blocks[..., 0, :, 11:14].reshape(*x.shape[:-1], cfg.out_dim)


class Lifter(nn.Module):
    """Lifter MLP.  ``layers``: per layer (w [K, N] bf16, b [N] fp32), the
    JAX package's layout; stored padded for the kernel (``pack_layer``)."""

    def __init__(self, cfg: LifterConfig,
                 layers: List[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims()
        if len(layers) != len(dims):
            raise ValueError(f"{len(layers)} layers, config has {len(dims)}")
        k_in = cfg.in_dim
        for i, ((w, b), (d_in, d_out)) in enumerate(zip(layers, dims)):
            if tuple(w.shape) != (d_in, d_out) or tuple(b.shape) != (d_out,):
                raise ValueError(f"lifter layer {i}: w {tuple(w.shape)}, "
                                 f"b {tuple(b.shape)}, expected "
                                 f"({d_in}, {d_out})")
            wp, bp = pack_layer(w, b, k_in)
            self.register_buffer(f"w{i}", wp)
            self.register_buffer(f"b{i}", bp)
            k_in = wp.shape[1]
        self.n_layers = len(dims)

    def packed_layers(self):
        return [(getattr(self, f"w{i}"), getattr(self, f"b{i}"))
                for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [M, in_dim] packed inputs (fp32) -> [M, out_dim] decameters."""
        h = fused_mlp_forward(x, self.packed_layers(),
                              self.cfg.negative_slope, self.cfg.out_dim)
        if self.cfg.residual_prior:
            h = h + extract_prior(x, self.cfg)
        return h
