"""The pose lifter MLP as an ``nn.Module``, and its weight trees.

Port of ``mpe3d_tpu/models/mlp.py``: ``apply_lifter`` (:77-131), whose
layers run here in one of three kinds per layer (``ops/fused_mlp.py``):

* bf16 weights, bf16 operands, fp32 sums (``compute_dtype=bfloat16``,
  :121-126);
* int8 weights ``wq`` with fp32 ``scale`` / ``rscale`` (the per-layer int8
  path, :113-118, ``ops/quant_matmul.py``);
* fp32 weights and sums (the path without ``compute_dtype``, :120-126):
  ``torch.matmul``.

On CUDA each run of consecutive bf16 and int8 layers is one launch of the
``mlp_run`` kernel: the whole network of a bf16 lifter, and of an int8 one
(its int8 layers and its bf16 head), as the TPU's ``_fused_mlp_call``.

``TrainableLifter`` is the training form: fp32 ``nn.Parameter`` weights,
the ``"layers"`` chain of ``apply_lifter`` (:109-127) in plain
``torch.matmul`` and autograd, optionally with bf16 operands
(``compute_dtype``, :119-126).

LeakyReLU(negative_slope) between layers, output 18 joints x 3 in
decameters.  With ``residual_prior`` the net predicts a correction to the
triangulated prior packed into its input (``extract_prior``, :59).

Weight trees are ``{"layers": [...]}`` of torch tensors in the JAX
package's layout: a plain layer ``{"w" [K, N], "b" [N]}``, a quantised one
``{"wq" [K, N] int8, "scale" [N], "rscale" [K] (optional), "b" [N]}``.
``quantize_lifter_weights``, ``dequantize_lifter_weights``,
``cast_lifter_weights`` and ``lifter_is_quantized`` are their JAX
counterparts (:161-275) and give the same numbers bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpe3d_tpu_torch.config import LifterConfig
from mpe3d_tpu_torch.ops.fused_mlp import (Fp32Layer, Int8Layer,
                                           fused_mlp_forward, mlp_run,
                                           pack_fp32_layer, pack_int8_layer,
                                           pack_layer)
from mpe3d_tpu_torch.utils import trace

NUMBERS_PER_JOINT = 14

Tree = Dict[str, Any]


def extract_prior(x: torch.Tensor, cfg: LifterConfig) -> torch.Tensor:
    """Triangulated-prior fields 11:14 of camera block 0 of a packed input,
    as an [..., out_dim] vector (decameters)."""
    J = cfg.out_dim // 3
    C = cfg.in_dim // (J * NUMBERS_PER_JOINT)
    if C * J * NUMBERS_PER_JOINT != cfg.in_dim:
        raise ValueError(f"in_dim {cfg.in_dim} is not C x {J} x 14")
    blocks = x.reshape(*x.shape[:-1], C, J, NUMBERS_PER_JOINT)
    return blocks[..., 0, :, 11:14].reshape(*x.shape[:-1], cfg.out_dim)


def cast_lifter_weights(tree: Tree, dtype: torch.dtype) -> Tree:
    """Copy of a plain tree with the weight matrices in ``dtype`` (biases
    stay fp32: they add into the fp32 accumulator)."""
    return {"layers": [{"w": layer["w"].to(dtype), "b": layer["b"]}
                       for layer in tree["layers"]]}


def quantize_lifter_weights(tree: Tree, keep_last_fp: bool = True,
                            row_scale: bool = True) -> Tree:
    """Two-sided symmetric int8 quantisation of the weight matrices:
    ``w ~ rscale[:, None] * (wq * scale[None, :])``, ``rscale[k] =
    max|w[k, :]|`` (with ``row_scale``), ``scale[j] = max|w'[:, j]| / 127``
    of the row-normalised ``w'``, ``wq = clip(round(w' / scale), -127,
    127)`` (round half to even).  Weights are upcast to fp32 first (bf16
    trees exactly).  Layers already quantised, and the output head with
    ``keep_last_fp``, are kept as they are."""
    layers = tree["layers"]
    out = []
    for i, layer in enumerate(layers):
        if "wq" in layer or (keep_last_fp and i == len(layers) - 1):
            out.append(dict(layer))
            continue
        w = layer["w"].to(torch.float32)
        q = {}
        if row_scale:
            q["rscale"] = torch.clamp(w.abs().amax(dim=1), min=1e-12)
            w = w / q["rscale"][:, None]
        scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
        q["wq"] = torch.clamp(torch.round(w / scale), -127, 127).to(
            torch.int8)
        q["scale"] = scale
        q["b"] = layer["b"].to(torch.float32)
        out.append(q)
    return {"layers": out}


def dequantize_lifter_weights(tree: Tree) -> Tree:
    """The fp32 tree a quantised tree effectively serves:
    ``w = (wq * scale[None, :]) * rscale[:, None]``."""
    out = []
    for layer in tree["layers"]:
        if "wq" not in layer:
            out.append(dict(layer))
            continue
        w = layer["wq"].to(torch.float32) * layer["scale"][None, :]
        if "rscale" in layer:
            w = w * layer["rscale"][:, None]
        out.append({"w": w, "b": layer["b"].to(torch.float32)})
    return {"layers": out}


def lifter_is_quantized(tree: Tree) -> bool:
    """True if any layer carries int8 weights (key ``wq``): such trees have
    no fp32 master and serve only through the int8 path."""
    return any("wq" in layer for layer in tree["layers"])


class Lifter(nn.Module):
    """Lifter MLP.  ``layers``: per layer a dict of torch tensors in the JAX
    package's layout: ``{"w", "b"}`` with bf16 or fp32 ``w``, or
    ``{"wq", "scale", "rscale", "b"}`` (int8 ``wq``).  Each is stored packed
    for its kernel (``ops/fused_mlp.py``).  ``serve_dtype`` is "int8" when a
    layer is int8, else "fp32" when a layer is fp32, else "bf16"."""

    def __init__(self, cfg: LifterConfig, layers: List[Dict[str, Any]]):
        super().__init__()
        self.cfg = cfg
        dims = cfg.layer_dims()
        if len(layers) != len(dims):
            raise ValueError(f"{len(layers)} layers, config has {len(dims)}")
        k_in = cfg.in_dim
        self.kinds: List[type] = []
        for i, (layer, (d_in, d_out)) in enumerate(zip(layers, dims)):
            w = layer["wq"] if "wq" in layer else layer["w"]
            if (tuple(w.shape) != (d_in, d_out)
                    or tuple(layer["b"].shape) != (d_out,)):
                raise ValueError(f"lifter layer {i}: w {tuple(w.shape)}, "
                                 f"b {tuple(layer['b'].shape)}, expected "
                                 f"({d_in}, {d_out})")
            if "wq" in layer:
                packed = pack_int8_layer(w, layer["scale"],
                                         layer.get("rscale"), layer["b"],
                                         k_in)
            elif w.dtype == torch.bfloat16:
                packed = pack_layer(w, layer["b"], k_in)
            elif w.dtype == torch.float32:
                packed = pack_fp32_layer(w, layer["b"], k_in)
            else:
                raise ValueError(f"lifter layer {i}: weights of {w.dtype}")
            for name, t in zip(packed._fields, packed):
                self.register_buffer(f"{name}{i}", t)
            self.kinds.append(type(packed))
            k_in = packed.b.shape[0]
        self.n_layers = len(dims)
        self._packed = None
        self.serve_dtype = ("int8" if Int8Layer in self.kinds else
                            "fp32" if Fp32Layer in self.kinds else "bf16")

    def packed_layers(self):
        """The packed layers (``Bf16Layer``, ``Int8Layer``, ``Fp32Layer``),
        built once (a frame's worth of host time) and again only after the
        buffers move (``_apply``: ``.to()``, ``.cuda()``, ...)."""
        if self._packed is None:
            self._packed = [
                kind(*(getattr(self, f"{name}{i}") for name in kind._fields))
                for i, kind in enumerate(self.kinds)]
        return self._packed

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [M, in_dim] packed inputs (fp32) -> [M, out_dim] decameters.
        Counts the M rows under ``lifter.rows`` and the run kernel's
        launches under ``lifter.launches`` (``utils/trace.py``; none on the
        CPU, where the plain version runs)."""
        trace.count("lifter.rows", x.shape[0])
        before = mlp_run.launches
        h = fused_mlp_forward(x, self.packed_layers(),
                              self.cfg.negative_slope, self.cfg.out_dim)
        if mlp_run.launches != before:
            trace.count("lifter.launches", mlp_run.launches - before)
        if self.cfg.residual_prior:
            h = h + extract_prior(x, self.cfg)
        return h



class TrainableLifter(nn.Module):
    """The lifter for training: fp32 master weights ``w{i}`` [K, N] and
    ``b{i}`` [N] as parameters (the JAX layout, so trees convert both ways,
    ``weights.trainable_lifter_from_tree`` / ``weights.lifter_tree``).

    ``compute_dtype="bf16"`` rounds each matmul's operands to bf16 and sums
    in fp32 (the products of two bf16 values are exact in fp32), as
    ``apply_lifter(compute_dtype=bfloat16)`` does with
    ``preferred_element_type=float32``; None keeps fp32 operands."""

    COMPUTE_DTYPES = (None, "fp32", "float32", "bf16", "bfloat16")

    def __init__(self, cfg: LifterConfig, layers: List[Dict[str, Any]],
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if compute_dtype not in self.COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{self.COMPUTE_DTYPES}, got {compute_dtype!r}")
        dims = cfg.layer_dims()
        if len(layers) != len(dims):
            raise ValueError(f"{len(layers)} layers, config has {len(dims)}")
        self.cfg = cfg
        self.bf16 = compute_dtype in ("bf16", "bfloat16")
        for i, (layer, (d_in, d_out)) in enumerate(zip(layers, dims)):
            w = torch.as_tensor(layer["w"], dtype=torch.float32)
            b = torch.as_tensor(layer["b"], dtype=torch.float32)
            if tuple(w.shape) != (d_in, d_out) or tuple(b.shape) != (d_out,):
                raise ValueError(f"lifter layer {i}: w {tuple(w.shape)}, b "
                                 f"{tuple(b.shape)}, expected ({d_in}, "
                                 f"{d_out})")
            self.register_parameter(f"w{i}", nn.Parameter(w.clone()))
            self.register_parameter(f"b{i}", nn.Parameter(b.clone()))
        self.n_layers = len(dims)

    def layer_params(self) -> List[nn.Parameter]:
        """The parameters in the JAX tree's flatten order: each layer's
        ``b`` then ``w``."""
        out = []
        for i in range(self.n_layers):
            out += [getattr(self, f"b{i}"), getattr(self, f"w{i}")]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., in_dim] fp32 -> [..., out_dim] decameters."""
        h = x
        for i in range(self.n_layers):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            if self.bf16:
                h = torch.matmul(h.to(torch.bfloat16).float(),
                                 w.to(torch.bfloat16).float()) + b
            else:
                h = torch.matmul(h, w) + b
            if i < self.n_layers - 1:
                h = F.leaky_relu(h, self.cfg.negative_slope)
        if self.cfg.residual_prior:
            h = h + extract_prior(x, self.cfg)
        return h
