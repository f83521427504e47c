"""Self-supervised lifter training, on one device or over a mesh.

Port of ``mpe3d_tpu/train/lifter.py`` (:36-342), the reference trainer
(pose_estimator/train_pose_estimator.py:120-282): Adam (lr 1e-4) after a
clip of the gradients' global norm to 10, the reprojection loss of
``lifting/loss.py`` (no 3D labels), a dev-set evaluation every
``eval_every`` epochs, early stopping after ``patience`` evaluations
without improvement.

* The forward and backward are plain ``torch.matmul`` and autograd on the
  ``TrainableLifter`` (fp32 master weights; bf16 operands with
  ``compute_dtype="bf16"``), as the JAX trainer runs ``apply_lifter``'s
  ``jnp.dot`` chain outside any Pallas kernel.  TF32 is off.
* The optimizer (``Adam``, shared with the matcher trainer) is optax's
  ``chain(clip_by_global_norm, adam)`` written out: the gradients are
  scaled by ``max_norm / g_norm`` (as ``(g / g_norm) * max_norm``) only
  when ``g_norm >= max_norm``, then Adam's moments, bias corrections and
  ``mu_hat / (sqrt(nu_hat) + eps)``.  Its state is (count, mu, nu) in the
  order optax flattens it, so checkpoints carry it between the packages
  (``checkpoint.py``).
* An epoch takes ``n // batch_size`` full batches of a permutation drawn
  on the device from a seeded ``torch.Generator`` (``arange`` with
  ``shuffle=False``) and drops the tail; the dataset is uploaded once.
  The dev loss is the size-weighted mean over batches, the tail included.
* ``ema_decay`` > 0: a Polyak average of the trained variables, seeded
  from them and updated after each step, is what is evaluated, stopped on
  and saved.  The best copy stays on the device; the final best is saved
  in a ``finally`` block, also when training is interrupted.
* ``optimise_matrices``: the rig's fields join the trained variables (the
  loss reads ``T_wc``, ``K`` and ``dist``), and ``result.rig`` is the
  refined rig.

* ``checkpoint_backend="orbax"``: the saves during training are
  ``wait=False`` saves of the tracked best (the saver thread writes them
  while training goes on); the final best is saved and every pending save
  waited for at the end (JAX :290-340).

A fresh run initialises from ``weights.random_lifter_tree(cfg, seed)``,
numpy draws of ``init_lifter``'s family (not ``jax.random``'s numbers),
with a zero head for ``residual_prior``; pass ``params`` (a JAX-layout
tree) to start from given weights.

``mesh`` (``parallel/mesh.py::make_mesh`` over the ranks of a
``torch.distributed`` world, JAX :156-216):

* the batch is ``max(batch_size // n_dev * n_dev, n_dev)`` rows, n_dev the
  mesh's size, and a host batch is cut to a multiple of n_dev (JAX's
  rounding); every rank holds the whole dataset, draws the same
  permutation from the same seed and takes its contiguous block of each
  batch along the data axis, dividing its block's loss sum by the whole
  batch's denominator (``lifting/loss.py::loss_denominator``);
* the gradients are summed over the data group in one collective a step,
  before the clip, so clip and Adam see the whole batch's gradient, and
  every rank of a data group takes the same step (the losses are summed
  once an epoch);
  the EMA and the dev loss (blocks of each dev batch, summed once an
  evaluation) are the same on every rank;
* the stop and save decisions (``stop_flag``, patience, the save rule) are
  taken on rank 0 and broadcast, so no rank reaches a collective that
  another skips; rank 0 alone writes checkpoints and logs;
* ``n_model`` > 1: tensor parallelism (``lifter_tp_shardings``): each
  rank holds its column or row slice of each layer, and its Adam state
  of the slice; the forward runs ``parallel/mesh.py::TensorParallel``; the
  clip's global norm adds each sliced leaf's squares once over the model
  group; an optimizer state given to resume is dropped with JAX's message
  (:181-183), and the checkpoints and ``result`` hold the whole tree,
  gathered from the slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from mpe3d_tpu_torch.checkpoint import (flatten_tree, save_checkpoint,
                                        wait_for_async_saves)
from mpe3d_tpu_torch.config import LifterConfig, LifterTrainConfig, RigConfig
from mpe3d_tpu_torch.geometry.camera import CameraRig
from mpe3d_tpu_torch.lifting.loss import (LOSS_KINDS, loss_denominator,
                                          reprojection_loss)
from mpe3d_tpu_torch.models.mlp import extract_prior
from mpe3d_tpu_torch.parallel.mesh import (TensorParallel, data_block,
                                           from_rank0, lifter_tp_shardings,
                                           sum_over, training_mesh)
from mpe3d_tpu_torch.weights import (random_lifter_tree,
                                     trainable_lifter_from_tree)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class LifterTrainResult:
    params: Optional[Dict]
    history: List[Dict] = field(default_factory=list)
    best_val_loss: float = float("inf")
    epochs_run: int = 0
    # the refined calibration under optimise_matrices: the lifter
    # co-adapted to it, so inference must use this rig
    rig: Optional[CameraRig] = None
    # the optimizer's (count, mu, nu) at the end, in optax's leaf order
    opt_state: Optional[tuple] = None


def init_lifter_tree(cfg: LifterConfig, seed: int) -> Dict:
    """A fresh run's weights: ``random_lifter_tree`` with the head zeroed
    for ``residual_prior`` (training starts at the prior)."""
    tree = random_lifter_tree(cfg, seed)
    if cfg.residual_prior:
        head = tree["layers"][-1]
        head["w"] = np.zeros_like(head["w"])
        head["b"] = np.zeros_like(head["b"])
    return tree


class Adam:
    """optax's Adam on a list of tensors: ``adam(lr)`` after
    ``clip_by_global_norm(max_norm)`` (the lifter trainer's chain; no clip
    with ``max_norm`` None), or ``adamw(lr, weight_decay)`` (the matcher
    trainer's: the decay ``weight_decay * p`` is added to Adam's step
    before the learning rate scales it, decoupled from the gradient).
    ``leaves``: a previous state, as its leaves or a (count, mu, nu) tree;
    ``state()`` is its (count, mu, nu), the leaves optax's state of either
    chain has, in that order.  ``norm_sq``: the clip's squared global norm
    of a gradient list (default: the sum of their squares)."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 max_norm: Optional[float] = None, leaves=None,
                 weight_decay: float = 0.0,
                 norm_sq: Optional[Callable] = None):
        self.params, self.lr, self.max_norm = params, lr, max_norm
        self.weight_decay = weight_decay
        # the gradients' squared global norm (tensor parallelism sums the
        # sliced leaves' squares over the model group)
        self.norm_sq = norm_sq or (lambda gs: sum(torch.sum(g * g)
                                                  for g in gs))
        n = len(params)
        if leaves is None:
            self.count = 0
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
            return
        leaves = flatten_tree(leaves)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                             f"expected {1 + 2 * n} (count, mu, nu of "
                             f"{n} trained variables)")
        self.count = int(leaves[0])
        as_t = [torch.tensor(np.asarray(a, np.float32),
                             device=params[0].device) for a in leaves[1:]]
        for a, p in zip(as_t, params + params):
            if a.shape != p.shape:
                raise ValueError(f"optimizer leaf {tuple(a.shape)} does not "
                                 f"match its variable {tuple(p.shape)}")
        self.mu, self.nu = as_t[:n], as_t[n:]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm is not None:
            g_norm = torch.sqrt(self.norm_sq(grads))
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        self.count += 1
        c1 = 1.0 - ADAM_B1 ** self.count
        c2 = 1.0 - ADAM_B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
            v.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
            u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(-self.lr * u)

    def state(self):
        return (np.asarray(self.count, np.int32),
                [m.cpu().numpy() for m in self.mu],
                [v.cpu().numpy() for v in self.nu])




def train_lifter(net_train: np.ndarray, err_train: np.ndarray,
                 net_dev: np.ndarray, err_dev: np.ndarray,
                 rig_config: RigConfig, rig: CameraRig,
                 cfg: Optional[LifterConfig] = None,
                 tcfg: Optional[LifterTrainConfig] = None,
                 mesh=None, checkpoint_path: Optional[str] = None,
                 params: Optional[Dict] = None, opt_state=None,
                 log: Callable[[str], None] = print,
                 stop_flag: Optional[Callable[[], bool]] = None,
                 extra_meta: Optional[Dict] = None,
                 device="cuda") -> LifterTrainResult:
    """Train with dev-set early stopping (module header).

    net/err arrays: the packed dataset (``train/lifter_data.py``), the
    whole of it on every rank.  ``params`` / ``opt_state``: a previous leg
    to resume (a JAX-layout tree; optimizer leaves or a (count, mu, nu)
    tree, ``checkpoint.read_optimizer_leaves``).  ``extra_meta``: keys
    merged into the checkpoint meta (the dataset's ``prior``, which
    inference must use).  ``mesh``: a ``make_mesh()`` of the ranks of a
    ``torch.distributed`` world, ``device`` this rank's device."""
    cfg = cfg or LifterConfig(in_dim=rig_config.lifter_input_dim,
                              out_dim=rig_config.n_joints * 3)
    tcfg = tcfg or LifterTrainConfig()
    if tcfg.loss not in LOSS_KINDS:
        raise ValueError(f"loss must be one of {LOSS_KINDS}, got "
                         f"{tcfg.loss!r}")
    if tcfg.checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend: "
                         f"{tcfg.checkpoint_backend!r}")
    mesh = training_mesh(mesh)
    n_dev = mesh.size if mesh is not None else 1
    dp = mesh is not None and mesh.n_data > 1
    rank0 = mesh is None or mesh.rank == 0
    if not rank0:
        log = lambda message: None          # noqa: E731 -- rank 0 logs
    device = torch.device(device)
    J = rig_config.n_joints
    model = trainable_lifter_from_tree(
        params if params is not None else init_lifter_tree(cfg, tcfg.seed),
        cfg, device, tcfg.compute_dtype)
    names = [f"{k}{i}" for i in range(model.n_layers) for k in ("b", "w")]
    n_model = len(names)
    tp = None
    if mesh is not None and mesh.n_model > 1:
        specs = lifter_tp_shardings(mesh, {"layers": [
            {"w": getattr(model, f"w{i}")} for i in range(model.n_layers)]})
        tp = TensorParallel(mesh, specs["layers"])
        variables = []
        for i in range(model.n_layers):
            w, b = tp.shard_layer(i, getattr(model, f"w{i}").detach(),
                                  getattr(model, f"b{i}").detach())
            variables += [b.requires_grad_(True), w.requires_grad_(True)]
        if opt_state is not None:
            log("[train_lifter] opt_state resume ignored under tensor "
                "parallelism (optimizer re-initialised)")
            opt_state = None
    else:
        variables = model.layer_params()
    rig_t = CameraRig(*(torch.as_tensor(np.asarray(a, np.float32),
                                        device=device) for a in rig))
    if tcfg.optimise_matrices:
        rig_t = CameraRig(*(t.clone().requires_grad_(True) for t in rig_t))
        variables = variables + list(rig_t)

    def leaf_key(i):
        return i // 2, ("b" if i % 2 == 0 else "w")

    norm_sq = None
    if tp is not None:
        sliced = [i < n_model and tp.is_sharded(*leaf_key(i))
                  for i in range(len(variables))]

        def norm_sq(gs):
            part = sum((torch.sum(g * g) for g, s in zip(gs, sliced) if s),
                       torch.zeros((), device=device))
            whole = sum((torch.sum(g * g) for g, s in zip(gs, sliced)
                         if not s), torch.zeros((), device=device))
            return sum_over(mesh.model_group, mesh.n_model, [part])[0] + whole
    opt = Adam(variables, tcfg.lr, tcfg.grad_clip_norm, opt_state,
               norm_sq=norm_sq)

    def forward(tensors, net):
        if tp is None:
            return functional_call(model, dict(zip(names, tensors[:n_model])),
                                   (net,))
        h = tp.forward(tensors[1:n_model:2], tensors[0:n_model:2], net,
                       cfg.negative_slope, model.bf16)
        return h + extract_prior(net, cfg) if cfg.residual_prior else h

    def loss_of(tensors, net, err, denom=None):
        r = CameraRig(*tensors[n_model:]) if tcfg.optimise_matrices \
            else rig_t
        return reprojection_loss(forward(tensors, net), err, r, J,
                                 kind=tcfg.loss,
                                 huber_delta=tcfg.huber_delta, denom=denom)

    ema = ([v.detach().clone() for v in variables]
           if tcfg.ema_decay > 0 else None)

    net_t = torch.as_tensor(np.asarray(net_train, np.float32), device=device)
    err_t = torch.as_tensor(np.asarray(err_train, np.float32), device=device)
    net_d = torch.as_tensor(np.asarray(net_dev, np.float32), device=device)
    err_d = torch.as_tensor(np.asarray(err_dev, np.float32), device=device)
    C = rig_t.n_cameras

    def block_loss(tensors, net_all, err_all, idx):
        """This rank's part of the loss of the batch ``idx``: its block's
        sum over the whole batch's denominator (the whole loss without
        data parallelism)."""
        if not dp:
            return loss_of(tensors, net_all[idx], err_all[idx])
        lo, hi = data_block(mesh, len(idx))
        denom = loss_denominator(err_all[idx], C, J, tcfg.loss)
        mine = idx[lo:hi]
        return loss_of(tensors, net_all[mine], err_all[mine], denom)

    def train_step(idx) -> torch.Tensor:
        loss = block_loss(variables, net_t, err_t, idx)
        grads = torch.autograd.grad(loss, variables, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(variables, grads)]
        if dp:
            grads = sum_over(mesh.data_group, mesh.n_data, grads)
        opt.step(grads)
        if ema is not None:
            d = tcfg.ema_decay
            with torch.no_grad():
                for e, v in zip(ema, variables):
                    e.mul_(d).add_(v * (1.0 - d))
        return loss.detach()

    def data_sum(t: torch.Tensor) -> torch.Tensor:
        return (sum_over(mesh.data_group, mesh.n_data, [t])[0] if dp
                else t)

    bs = max(tcfg.batch_size // n_dev * n_dev, n_dev)
    n = len(net_t)
    k_batches = n // bs
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed + 1)
    rng = np.random.default_rng(tcfg.seed)
    dev_order = (np.random.default_rng(0).permutation(len(net_d))
                 if tcfg.shuffle else np.arange(len(net_d)))
    dev_idx = torch.as_tensor(dev_order, device=device)

    def evaluate(eval_vars) -> float:
        vsum, vn = torch.zeros((), device=device), 0
        with torch.no_grad():
            for i in range(0, len(net_d), bs):
                idx = dev_idx[i:i + bs]
                idx = idx[:len(idx) // n_dev * n_dev]
                if len(idx) == 0:
                    continue
                vsum = vsum + block_loss(eval_vars, net_d, err_d,
                                         idx) * len(idx)
                vn += len(idx)
        return float(data_sum(vsum)) / max(vn, 1)

    def whole(tensors) -> List[torch.Tensor]:
        """The variables' whole tensors (gathered from the slices under
        tensor parallelism: collective)."""
        if tp is None:
            return [t.detach() for t in tensors]
        return [tp.gather_leaf(*leaf_key(i), t.detach()) if i < n_model
                else t.detach() for i, t in enumerate(tensors)]

    def model_tree(full, host: bool):
        ts = [t.cpu().numpy().copy() if host else t for t in full[:n_model]]
        return {"layers": [{"b": ts[i], "w": ts[i + 1]}
                           for i in range(0, n_model, 2)]}

    result = LifterTrainResult(params=None)
    best, patience = float("inf"), 0
    best_copy, best_meta, last_saved = None, {}, float("inf")
    t0 = time.time()
    try:
        for epoch in range(tcfg.epochs):
            stop = stop_flag() if (stop_flag and rank0) else False
            if from_rank0(mesh, [stop], device)[0]:
                break
            if tcfg.scan_epoch and k_batches > 0:
                perm = (torch.randperm(n, generator=gen, device=device)
                        if tcfg.shuffle else
                        torch.arange(n, device=device))[:k_batches * bs]
                losses = [train_step(idx)
                          for idx in perm.view(k_batches, bs)]
                train_loss = float(data_sum(torch.stack(losses)).mean())
            else:
                order = (rng.permutation(n) if tcfg.shuffle
                         else np.arange(n))
                losses, sizes = [], []
                for i in range(0, n, bs):
                    sel = order[i:i + bs]
                    sel = sel[:len(sel) // n_dev * n_dev]
                    if len(sel) == 0:
                        continue
                    losses.append(train_step(torch.as_tensor(sel,
                                                             device=device)))
                    sizes.append(len(sel))
                host = (data_sum(torch.stack(losses)).cpu().numpy()
                        if losses else [])
                train_loss = (sum(float(l) * b for l, b in zip(host, sizes))
                              / max(sum(sizes), 1))
            if tcfg.loss == "per_term":
                mae_per_coord = (train_loss / 2.0) ** 0.5
            elif tcfg.loss == "huber":
                mae_per_coord = train_loss ** 0.5
            else:
                mae_per_coord = ((train_loss ** 0.5)
                                 / rig_config.n_cameras / J / 2)

            if epoch % tcfg.eval_every == 0:
                eval_vars = ema if ema is not None else variables
                val_loss = evaluate(eval_vars)
                result.history.append({"epoch": epoch,
                                       "train_loss": train_loss,
                                       "val_loss": val_loss,
                                       "mae_per_coord": mae_per_coord,
                                       "elapsed_s": time.time() - t0})
                log(f"epoch {epoch:5d} | loss {train_loss:.5f} | "
                    f"val {val_loss:.5f} | mae/coord {mae_per_coord:.5f} | "
                    f"patience {patience}")
                improved = val_loss < best
                save = improved and (
                    val_loss <= last_saved * (1.0 - tcfg.save_rel_improve))
                give_up = not improved and patience + 1 >= tcfg.patience
                improved, save, give_up = (bool(v) for v in from_rank0(
                    mesh, [improved, save, give_up], device))
                if improved:
                    best, patience = val_loss, 0
                    result.best_val_loss = best
                    best_copy = [v.detach().clone() for v in eval_vars]
                    best_meta = {"epoch": epoch, "val_loss": val_loss,
                                 "train_loss": train_loss,
                                 "lifter_config": cfg, "train_config": tcfg,
                                 **(extra_meta or {})}
                    if save:
                        last_saved = val_loss
                        full = whole(best_copy)
                        if tcfg.checkpoint_backend == "orbax":
                            # the device tensors go to the saver thread,
                            # which copies them to the host
                            if checkpoint_path and rank0:
                                save_checkpoint(checkpoint_path,
                                                model_tree(full, False),
                                                meta=best_meta,
                                                backend="orbax", wait=False)
                        else:
                            result.params = model_tree(full, True)
                            if checkpoint_path and rank0:
                                save_checkpoint(checkpoint_path,
                                                result.params, meta=best_meta)
                else:
                    patience += 1
                    if give_up:
                        result.epochs_run = epoch + 1
                        break
            result.epochs_run = epoch + 1
    finally:
        if best_copy is not None:
            full = whole(best_copy)
            if best < last_saved or result.params is None:
                result.params = model_tree(full, True)
            if tcfg.optimise_matrices:
                result.rig = CameraRig(*(t.cpu().numpy()
                                         for t in full[n_model:]))
            if best < last_saved and checkpoint_path and rank0:
                save_checkpoint(checkpoint_path, result.params,
                                meta=best_meta,
                                backend=tcfg.checkpoint_backend)
        elif result.params is None:
            result.params = model_tree(whole(variables), True)
        if rank0:
            wait_for_async_saves()      # the saves during training commit
    count, mu, nu = opt.state()
    if tp is not None:
        mu = [t.cpu().numpy() for t in whole([torch.from_numpy(m).to(device)
                                              for m in mu])]
        nu = [t.cpu().numpy() for t in whole([torch.from_numpy(v).to(device)
                                              for v in nu])]
    result.opt_state = (count, mu, nu)
    return result
