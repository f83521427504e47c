"""Device meshes over ``torch.distributed``: data and tensor parallelism.

Port of ``mpe3d_tpu/parallel/mesh.py``.  The JAX package lays a (data,
model) mesh over the devices of one program and lets XLA insert the
collectives; here a mesh is a (data, model) grid of either

* **ranks** of a ``torch.distributed`` world (``torchrun``, or spawned
  processes), one device a rank: every rank builds the same grid, keeps its
  coordinates and its device, and holds the process group of its grid
  column (``data_group``: the ranks that share its model slice, over which
  gradients are averaged) and of its grid row (``model_group``: the ranks
  that hold the slices of one model, over which tensor-parallel layers
  reduce); or
* **local devices** of this process, without process groups: what
  ``PoseEstimationPipeline.infer_batch(mesh=...)`` splits frames over.

``make_mesh(n_data, n_model, devices)`` checks its arguments as the JAX
function does (``mesh.py:23-45``).  ``lifter_tp_shardings`` is the JAX
tensor-parallel layout of the lifter (Megatron's alternation: even layers
column-parallel, the weight split on its output axis and the bias with it;
odd layers row-parallel, the weight split on its input axis, the bias
whole; the last layer, and a layer whose split axis does not divide by the
model axis, whole), and ``TensorParallel`` runs the lifter's forward on the
slices: a row-parallel layer sums its partial outputs over the model group
in the forward pass, a column-parallel layer its input's partial gradients
in the backward pass (``torch.autograd.Function``), and an activation is
gathered or sliced where the next layer wants it whole or split.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# a collective that waits longer than this fails instead of stalling
PROCESS_GROUP_TIMEOUT_S = 600.0


def init_distributed(device: str = "cuda",
                     timeout_s: float = PROCESS_GROUP_TIMEOUT_S) -> bool:
    """Join the ``torch.distributed`` world that ``torchrun`` describes in
    the environment (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for a CUDA ``device``, gloo for the CPU, with a
    timeout on every collective.  Returns False (and does nothing) outside
    such a world; True when this process is (now) a rank of it."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for a CUDA ``device`` (one
    card a rank, as ``torchrun --nproc-per-node`` lays them out), else the
    CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device("cpu")


class Mesh:
    """A (data, model) grid (module header).  ``shape``: {"data": n_data,
    "model": n_model}; ``devices``: the grid's devices (a rank mesh: its
    ranks) as an [n_data, n_model] object array; on a rank mesh also
    ``rank``, ``coords`` (this rank's (data, model) index), ``device``, and
    ``data_group`` / ``model_group``."""

    def __init__(self, devices: np.ndarray, distributed: bool,
                 device: Optional[torch.device] = None):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}
        self.distributed = distributed
        self.device = device
        self.rank, self.coords = None, None
        self.data_group = self.model_group = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    def local_devices(self) -> List[torch.device]:
        """The devices of a local mesh, data axis first."""
        if self.distributed:
            raise ValueError("a mesh of ranks has no local device list")
        return list(self.devices.ravel())

    def __repr__(self) -> str:
        kind = "ranks" if self.distributed else "devices"
        return (f"Mesh({self.n_data}x{self.n_model} {kind}, "
                f"{self.devices.ravel().tolist()})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """A (data, model) mesh.  ``devices`` None: the ranks of the
    ``torch.distributed`` world where one is initialised (this rank's
    ``device``, default ``local_rank_device()``), else every card of this
    process (the CPU where there is none); a list: those local devices.
    ``n_data`` defaults to all of them over ``n_model``.  Under a world,
    every rank must call this in the same order (the groups are made
    collectively)."""
    world = devices is None and dist.is_available() and dist.is_initialized()
    if world:
        members: List = list(range(dist.get_world_size()))
    elif devices is not None:
        members = [torch.device(d) for d in devices]
    elif torch.cuda.is_available():
        members = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        members = [torch.device("cpu")]
    if n_model < 1 or n_model > len(members):
        raise ValueError(f"n_model={n_model} needs 1..{len(members)} "
                         f"devices (have {len(members)})")
    if n_data is None:
        n_data = len(members) // n_model
    if n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model} is empty for "
                         f"{len(members)} devices")
    if n_data * n_model > len(members):
        raise ValueError(f"mesh {n_data}x{n_model} needs "
                         f"{n_data * n_model} devices (have {len(members)})")
    if n_data * n_model < len(members):
        print(f"[mpe3d_torch] mesh {n_data}x{n_model} uses "
              f"{n_data * n_model} of {len(members)} devices",
              file=sys.stderr)
    grid = np.empty((n_data, n_model), dtype=object)
    for i, m in enumerate(members[:n_data * n_model]):
        grid[i // n_model, i % n_model] = m
    if not world:
        return Mesh(grid, distributed=False)
    if device is None:
        device = local_rank_device("cuda" if torch.cuda.is_available()
                                   else "cpu")
    mesh = Mesh(grid, distributed=True, device=torch.device(device))
    mesh.rank = dist.get_rank()
    # every group is made on every rank, in one order (new_group is
    # collective); a rank outside the grid keeps none
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if mesh.rank in grid[:, m]:
            mesh.data_group = g
    for d in range(n_data):
        g = dist.new_group([int(r) for r in grid[d, :]])
        if mesh.rank in grid[d, :]:
            mesh.model_group = g
    if mesh.rank < n_data * n_model:
        mesh.coords = divmod(mesh.rank, n_model)
    return mesh


def training_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a trainer runs over: None for no mesh or a one-device
    local mesh; a mesh of several local devices raises (the port trains one
    process a device: start the ranks with ``torchrun``)."""
    if mesh is None or mesh.size == 1 and not mesh.distributed:
        return None
    if not mesh.distributed:
        raise ValueError(
            f"{mesh}: data- and tensor-parallel training runs one process a "
            f"device; start the ranks under torchrun (or torch.distributed) "
            f"and pass make_mesh() of their world")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh}")
    return mesh


def data_block(mesh: Optional[Mesh], n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of ``n`` batch rows (n a
    multiple of the data axis), as the JAX data sharding lays a batch over
    the data axis; the whole batch without a rank mesh."""
    if mesh is None or not mesh.distributed or mesh.n_data == 1:
        return 0, n
    per = n // mesh.n_data
    d = mesh.coords[0]
    return d * per, (d + 1) * per


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the leading axis with zeros to a multiple (so it shards evenly);
    returns (padded, real_count)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.zeros((rem, *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad], axis=0), n


def sum_over(group, size: int, tensors: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """The tensors summed over ``group`` (``size`` ranks) in one
    collective: flattened into one buffer, all-reduced, split again; as
    they are for a group of one."""
    if size <= 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def from_rank0(mesh: Optional[Mesh], values: Sequence[float],
               device) -> List[float]:
    """``values`` as rank 0 has them, on every rank (one broadcast over
    the world): decisions that change which collectives run (stop, save)
    are taken on rank 0 alone."""
    if mesh is None or not mesh.distributed or dist.get_world_size() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


# ---------------------------------------------------------------------------
# tensor parallelism of the lifter
# ---------------------------------------------------------------------------

COL = {"w": (None, "model"), "b": ("model",)}
ROW = {"w": ("model", None), "b": ()}
WHOLE = {"w": (), "b": ()}


def lifter_tp_shardings(mesh: Mesh, params) -> Dict:
    """The lifter's tensor-parallel layout over the mesh's model axis: per
    layer, a partition spec of ``w`` and ``b`` (``COL``, ``ROW`` or
    ``WHOLE``; module header).  With ``n_model == 1`` every layer is
    whole."""
    m = mesh.n_model
    layers = []
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        d_in, d_out = tuple(layer["w"].shape)
        col = i % 2 == 0
        if m == 1 or i == n - 1 or (col and d_out % m) \
                or (not col and d_in % m):
            layers.append(WHOLE)
        elif col:
            layers.append(COL)
        else:
            layers.append(ROW)
    return {"layers": layers}


def shard(t: torch.Tensor, spec, n: int, j: int) -> torch.Tensor:
    """Slice ``j`` of ``n`` of ``t`` along the axis ``spec`` names
    "model" (a copy); the whole tensor for a spec without it."""
    if "model" not in spec:
        return t.clone()
    axis = spec.index("model")
    size = t.shape[axis] // n
    return t.narrow(axis, j * size, size).clone()


def _gather_last(x: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Feature slices joined along the last axis; backward: this rank's
    slice of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, group, n, j):
        ctx.width, ctx.j = x.shape[-1], j
        return _gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.j * w:(ctx.j + 1) * w].contiguous(), None, None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's slice of a whole activation along the last axis;
    backward: the slices' gradients joined."""

    @staticmethod
    def forward(ctx, x, group, n, j):
        ctx.group, ctx.n = group, n
        w = x.shape[-1] // n
        return x[..., j * w:(j + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group, ctx.n), None, None, None


class TensorParallel:
    """The lifter's forward on this rank's slices (module header).
    ``specs``: ``lifter_tp_shardings(mesh, ...)["layers"]``."""

    def __init__(self, mesh: Mesh, specs: List[Dict]):
        self.mesh, self.specs = mesh, specs
        self.n, self.j = mesh.n_model, mesh.coords[1]
        self.group = mesh.model_group

    def shard_layer(self, i: int, w: torch.Tensor, b: torch.Tensor):
        s = self.specs[i]
        return (shard(w, s["w"], self.n, self.j),
                shard(b, s["b"], self.n, self.j))

    def is_sharded(self, i: int, key: str) -> bool:
        return "model" in self.specs[i][key]

    def gather_leaf(self, i: int, key: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of layer ``i`` (collective over the model
        group)."""
        spec = self.specs[i][key]
        if "model" not in spec:
            return t
        axis = spec.index("model")
        parts = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group)
        return torch.cat(parts, dim=axis)

    def forward(self, ws: List[torch.Tensor], bs: List[torch.Tensor],
                x: torch.Tensor, slope: float, bf16: bool) -> torch.Tensor:
        """The hidden stack and head on slices ``ws`` / ``bs``; x whole."""
        h, split = x, False
        for i, (w, b) in enumerate(zip(ws, bs)):
            kind = self.specs[i]
            if kind is ROW:
                if not split:
                    h = _ScatterToModel.apply(h, self.group, self.n, self.j)
            else:
                if split:
                    h = _GatherFromModel.apply(h, self.group, self.n, self.j)
                if kind is COL:
                    h = _CopyToModel.apply(h, self.group)
            if bf16:
                y = torch.matmul(h.to(torch.bfloat16).float(),
                                 w.to(torch.bfloat16).float())
            else:
                y = torch.matmul(h, w)
            if kind is ROW:
                y = _ReduceFromModel.apply(y, self.group)
            h = y + b
            split = kind is COL
            if i < len(ws) - 1:
                h = F.leaky_relu(h, slope)
        if split:
            h = _GatherFromModel.apply(h, self.group, self.n, self.j)
        return h
