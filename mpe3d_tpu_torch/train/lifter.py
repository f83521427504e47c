"""Self-supervised lifter training on one device.

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

A fresh run initialises from ``weights.random_lifter_tree(cfg, seed)``,
numpy draws of ``init_lifter``'s family (not ``jax.random``'s numbers),
with a zero head for ``residual_prior``; pass ``params`` (a JAX-layout
tree) to start from given weights.  Tensor-parallel meshes and orbax
checkpoints are refused (ROADMAP.md section 1, item 8).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from mpe3d_tpu_torch.checkpoint import (ORBAX_REFUSED, flatten_tree,
                                        save_checkpoint)
from mpe3d_tpu_torch.config import LifterConfig, LifterTrainConfig, RigConfig
from mpe3d_tpu_torch.geometry.camera import CameraRig
from mpe3d_tpu_torch.lifting.loss import LOSS_KINDS, reprojection_loss
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
    chain has, in that order."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 max_norm: Optional[float] = None, leaves=None,
                 weight_decay: float = 0.0):
        self.params, self.lr, self.max_norm = params, lr, max_norm
        self.weight_decay = weight_decay
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
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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

    net/err arrays: the packed dataset (``train/lifter_data.py``).
    ``params`` / ``opt_state``: a previous leg to resume (a JAX-layout
    tree; optimizer leaves or a (count, mu, nu) tree, ``checkpoint.
    read_optimizer_leaves``).  ``extra_meta``: keys merged into the
    checkpoint meta (the dataset's ``prior``, which inference must use).
    ``mesh`` (the JAX package's device mesh) is refused."""
    cfg = cfg or LifterConfig(in_dim=rig_config.lifter_input_dim,
                              out_dim=rig_config.n_joints * 3)
    tcfg = tcfg or LifterTrainConfig()
    if mesh is not None:
        raise NotImplementedError(
            "train_lifter(mesh=...): data- and tensor-parallel meshes are "
            "not in the PyTorch port (ROADMAP.md section 1, item 8: "
            "parallel/mesh.py -> DDP); it trains on one device")
    if tcfg.checkpoint_backend == "orbax":
        raise NotImplementedError(ORBAX_REFUSED)
    if tcfg.loss not in LOSS_KINDS:
        raise ValueError(f"loss must be one of {LOSS_KINDS}, got "
                         f"{tcfg.loss!r}")
    device = torch.device(device)
    J = rig_config.n_joints
    model = trainable_lifter_from_tree(
        params if params is not None else init_lifter_tree(cfg, tcfg.seed),
        cfg, device, tcfg.compute_dtype)
    names = [f"{k}{i}" for i in range(model.n_layers) for k in ("b", "w")]
    variables = model.layer_params()
    rig_t = CameraRig(*(torch.as_tensor(np.asarray(a, np.float32),
                                        device=device) for a in rig))
    if tcfg.optimise_matrices:
        rig_t = CameraRig(*(t.clone().requires_grad_(True) for t in rig_t))
        variables = variables + list(rig_t)
    n_model = len(names)
    opt = Adam(variables, tcfg.lr, tcfg.grad_clip_norm, opt_state)

    def loss_of(tensors, net, err):
        out = functional_call(model, dict(zip(names, tensors[:n_model])),
                              (net,))
        r = CameraRig(*tensors[n_model:]) if tcfg.optimise_matrices \
            else rig_t
        return reprojection_loss(out, err, r, J, kind=tcfg.loss,
                                 huber_delta=tcfg.huber_delta)

    ema = ([v.detach().clone() for v in variables]
           if tcfg.ema_decay > 0 else None)

    def train_step(net, err) -> torch.Tensor:
        loss = loss_of(variables, net, err)
        grads = torch.autograd.grad(loss, variables, allow_unused=True)
        opt.step([torch.zeros_like(v) if g is None else g
                  for v, g in zip(variables, grads)])
        if ema is not None:
            d = tcfg.ema_decay
            with torch.no_grad():
                for e, v in zip(ema, variables):
                    e.mul_(d).add_(v * (1.0 - d))
        return loss.detach()

    net_t = torch.as_tensor(np.asarray(net_train, np.float32), device=device)
    err_t = torch.as_tensor(np.asarray(err_train, np.float32), device=device)
    net_d = torch.as_tensor(np.asarray(net_dev, np.float32), device=device)
    err_d = torch.as_tensor(np.asarray(err_dev, np.float32), device=device)
    bs = max(tcfg.batch_size, 1)
    n = len(net_t)
    k_batches = n // bs
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed + 1)
    rng = np.random.default_rng(tcfg.seed)
    dev_order = (np.random.default_rng(0).permutation(len(net_d))
                 if tcfg.shuffle else np.arange(len(net_d)))
    dev_idx = torch.as_tensor(dev_order, device=device)

    result = LifterTrainResult(params=None)
    best, patience = float("inf"), 0
    best_copy, best_meta, last_saved = None, {}, float("inf")
    t0 = time.time()

    def pull(tensors):
        """The lifter tree of the variables' model part, on the host."""
        host = [t.detach().cpu().numpy().copy() for t in tensors[:n_model]]
        return {"layers": [{"b": host[i], "w": host[i + 1]}
                           for i in range(0, n_model, 2)]}

    try:
        for epoch in range(tcfg.epochs):
            if stop_flag and stop_flag():
                break
            if tcfg.scan_epoch and k_batches > 0:
                perm = (torch.randperm(n, generator=gen, device=device)
                        if tcfg.shuffle else
                        torch.arange(n, device=device))[:k_batches * bs]
                losses = [train_step(net_t[idx], err_t[idx])
                          for idx in perm.view(k_batches, bs)]
                train_loss = float(torch.stack(losses).mean())
            else:
                order = (rng.permutation(n) if tcfg.shuffle
                         else np.arange(n))
                losses, sizes = [], []
                for i in range(0, n, bs):
                    idx = torch.as_tensor(order[i:i + bs], device=device)
                    losses.append(train_step(net_t[idx], err_t[idx]))
                    sizes.append(len(idx))
                host = torch.stack(losses).cpu().numpy() if losses else []
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
                vsum, vn = torch.zeros((), device=device), 0
                with torch.no_grad():
                    for i in range(0, len(net_d), bs):
                        idx = dev_idx[i:i + bs]
                        vsum = vsum + loss_of(eval_vars, net_d[idx],
                                              err_d[idx]) * len(idx)
                        vn += len(idx)
                val_loss = float(vsum) / max(vn, 1)
                result.history.append({"epoch": epoch,
                                       "train_loss": train_loss,
                                       "val_loss": val_loss,
                                       "mae_per_coord": mae_per_coord,
                                       "elapsed_s": time.time() - t0})
                log(f"epoch {epoch:5d} | loss {train_loss:.5f} | "
                    f"val {val_loss:.5f} | mae/coord {mae_per_coord:.5f} | "
                    f"patience {patience}")
                if val_loss < best:
                    best, patience = val_loss, 0
                    result.best_val_loss = best
                    best_copy = [v.detach().clone() for v in eval_vars]
                    best_meta = {"epoch": epoch, "val_loss": val_loss,
                                 "train_loss": train_loss,
                                 "lifter_config": cfg, "train_config": tcfg,
                                 **(extra_meta or {})}
                    if val_loss <= last_saved * (1.0 - tcfg.save_rel_improve):
                        last_saved = val_loss
                        result.params = pull(best_copy)
                        if checkpoint_path:
                            save_checkpoint(checkpoint_path, result.params,
                                            meta=best_meta)
                else:
                    patience += 1
                    if patience >= tcfg.patience:
                        result.epochs_run = epoch + 1
                        break
            result.epochs_run = epoch + 1
    finally:
        if best_copy is not None:
            if best < last_saved or result.params is None:
                result.params = pull(best_copy)
            if tcfg.optimise_matrices:
                result.rig = CameraRig(*(t.detach().cpu().numpy()
                                         for t in best_copy[n_model:]))
            if best < last_saved and checkpoint_path:
                save_checkpoint(checkpoint_path, result.params,
                                meta=best_meta)
        elif result.params is None:
            result.params = pull(variables)
    result.opt_state = opt.state()
    return result
