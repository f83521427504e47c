"""Matcher (GAT) training, on one device or data-parallel over a mesh.

Port of ``mpe3d_tpu/train/matcher.py`` (:38-425), the reference trainer
(skeleton_matching/train_skeleton_matching.py:31-58, 158-251): AdamW
(lr 1e-4, weight decay 1e-20), batches of 15 scenes, MSE on the sigmoid
scores of the edge nodes (BCE with ``use_bce``), a dev-set evaluation every
``eval_every`` epochs, early stopping after ``patience`` evaluations
without improvement.  No 3D labels: the scenes are composites of
single-person recordings (``train/matcher_data.py``, or synthesised on the
device by ``train/matcher_synth.py``).

* The forward and backward are plain PyTorch and autograd on the
  ``TrainableMatcher`` (fp32, TF32 off), as the JAX trainer runs the XLA
  GAT with ``use_pallas_matcher`` off: the serving kernels have no
  backward and need none.  A batch is one graph, the disjoint union of its
  scenes' graphs (``models/gat.py::union_topology``; the alt-1 graph's
  ``matching/alt1.py::alt1_union``), so a step is one forward over every
  scene, no loop over scenes.
* The loss (``matcher_loss``, JAX :125-144): per edge node MSE or
  ``bce_per_element`` on the scores, weighted by the pair multiplicity
  (duplicated edge nodes count twice), summed over the batch and divided
  by the weight sum (at least 1).  Under ``prune_dist`` the weight, in the
  loss and in the head softmax, is zeroed for pairs whose mean ray distance
  on the matching cameras exceeds it; pairs with no shared joint (>= 999 m)
  stay, as in serving.
* The optimizer is optax's ``adamw`` written out (``train/lifter.py::
  Adam``, JAX :251), its state (count, mu, nu) in optax's leaf order, so a
  checkpoint of either package resumes in the other.
* ``scan_epoch`` (the default): the scenes are uploaded once, an epoch
  takes ``n // batch_size`` full batches of a permutation drawn on the
  device from a ``torch.Generator`` seeded ``seed + 1`` (not
  ``jax.random``'s order) and drops the tail; the dev set is padded to
  whole batches by repeats at zero weight and its loss is the mean of the
  per-batch losses (JAX :290-317).  Without it, batches of
  ``np.random.default_rng(seed).permutation``, the tail kept (the JAX
  package's order exactly), and dev batches of ``default_rng(0)``'s.
  The train loss is the mean of the per-batch losses either way.
* Dropout (``cfg.feat_drop`` / ``attn_drop``) draws from the same
  generator, in train steps only.
* ``synth_bank`` (a ``train/matcher_synth.py::SceneBank``): uploaded
  once, and every batch is synthesised on the device; ``train_scenes`` may
  be None, an epoch takes ``tcfg.limit`` scenes in full batches.  Requires
  ``scan_epoch``.
* The best parameters (on an improved dev loss) are kept, and written with
  the optimizer state and the meta ``{epoch, val_loss, matcher_config,
  train_config, n_slots}`` to a checkpoint of ``tcfg.checkpoint_backend``
  (``checkpoint.py``; an orbax save on the saver thread, waited for at
  the end).

A fresh run initialises from ``weights.random_matcher_tree(cfg, seed)``:
numpy draws of ``init_matcher``'s family, not ``jax.random``'s numbers.

``mesh`` (a ``make_mesh()`` of the ranks of a ``torch.distributed``
world, JAX :242-375): the batch is ``max(batch_size // n_dev * n_dev,
n_dev)`` scenes; every rank draws (or synthesises on its device) the same
whole batch from the same generator and scores its contiguous block along
the data axis, dividing by the whole batch's weight sum, so the blocks'
losses add up to the batch's; a host batch short of a multiple of n_dev is
padded with repeats at zero weight (JAX :317-333).  The gradients are
summed over the data group in one collective a step; dropout masks come
from a generator of each data rank.  The stop and save decisions are
rank 0's, broadcast; rank 0 alone logs and saves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import save_checkpoint, wait_for_async_saves
from mpe3d_tpu_torch.config import (MatcherConfig, MatcherTrainConfig,
                                    RigConfig)
from mpe3d_tpu_torch.geometry.camera import CameraRig
from mpe3d_tpu_torch.matching.alt1 import (alt1_graph, alt1_node_features,
                                           alt1_union, apply_matcher_alt1,
                                           build_alt1_topology)
from mpe3d_tpu_torch.matching.features import (PairTopology,
                                               edge_node_features,
                                               head_features,
                                               pair_ray_distances)
from mpe3d_tpu_torch.models.gat import gat_topology, union_topology
from mpe3d_tpu_torch.parallel.mesh import (data_block, from_rank0, sum_over,
                                           training_mesh)
from mpe3d_tpu_torch.train.lifter import Adam
from mpe3d_tpu_torch.train.matcher_data import MatcherScenes
from mpe3d_tpu_torch.weights import (matcher_tree, random_matcher_tree,
                                     trainable_matcher_from_tree)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

@dataclass
class MatcherTrainResult:
    params: Optional[Dict]
    history: List[Dict] = field(default_factory=list)
    best_val_loss: float = float("inf")
    epochs_run: int = 0
    # the optimizer's (count, mu, nu) at the end, in optax's leaf order
    opt_state: Optional[tuple] = None


def bce_per_element(scores: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """``nn.BCELoss`` on sigmoid scores, per element, the log clamped at
    -100 (reference: train_skeleton_matching.py:32-38).  The score is
    floored at 1e-37 BEFORE the log: a score saturated to exactly 0 or 1
    (fp32 sigmoid at |logit| above about 16.6) would otherwise take the log
    of 0, whose gradient 0 x inf is NaN.  The floor is a normal fp32
    number, since a flushed (zero) floor would tie with the saturated score
    and let the log's infinity back through."""
    tiny = 1e-37
    log_s = torch.clamp(torch.log(torch.clamp(scores, min=tiny)), min=-100.0)
    log_c = torch.clamp(torch.log(torch.clamp(1.0 - scores, min=tiny)),
                        min=-100.0)
    return -(labels * log_s + (1.0 - labels) * log_c)


def matcher_loss(scores: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor, use_bce: bool = False,
                 denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's loss: per-element MSE (or BCE) weighted by the pair
    multiplicities, over the weight sum (at least 1), or over ``denom``
    (a data-parallel rank's block: the whole batch's)."""
    per = (bce_per_element(scores, labels) if use_bce
           else (scores - labels) ** 2)
    if denom is None:
        denom = torch.clamp(torch.sum(weight), min=1.0)
    return torch.sum(per * weight) / denom


class MatcherObjective:
    """Scores and loss of a batch of scenes [B, C, S, ...] on the matching
    sub-rig ``match_rig`` (tensors on ``device``), for the rig's graph
    alternative, as ``make_matcher_step``'s ``loss_fn`` (JAX :78-144)."""

    def __init__(self, match_rig: CameraRig, rig_config: RigConfig,
                 topo: PairTopology, cfg: MatcherConfig, device,
                 use_bce: bool = False, prune_dist: float = 0.0):
        self.rig = match_rig.to(device)
        self.rig_config, self.topo, self.cfg = rig_config, topo, cfg
        self.device, self.use_bce = torch.device(device), use_bce
        self.prune_dist = prune_dist
        self.img = (float(rig_config.image_width),
                    float(rig_config.image_height))
        self.alt = rig_config.graph_alternative
        self._graphs = {}
        if self.alt == "1":
            self.graph = alt1_graph(build_alt1_topology(
                topo, rig_config.n_joints, rig_config.joint_format),
                self.device)
        else:
            self.graph = gat_topology(topo, self.device, "stack")

    def _union(self, B: int):
        """(union graph, edge rows) of B scenes, cached by B."""
        if B not in self._graphs:
            E = self.topo.n_pairs
            if self.alt == "1":
                self._graphs[B] = (alt1_union(self.graph, B),
                                   edge_node_features(E, self.cfg.in_dim,
                                                      device=self.device))
            else:
                self._graphs[B] = (union_topology(self.graph, B, E),
                                   edge_node_features(B * E, self.cfg.in_dim,
                                                      device=self.device))
        return self._graphs[B]

    def pruned_weight(self, kp, valid, observed, weight):
        """The pair weights with the pairs past ``prune_dist`` zeroed."""
        d = pair_ray_distances(kp, valid * observed.to(kp.dtype), self.rig,
                               self.topo)
        keep = (d <= self.prune_dist) | (d >= 999.0)
        return weight * keep.to(weight.dtype)

    def scores(self, model, kp, valid, prob, observed, present, weight,
               generator=None) -> torch.Tensor:
        """Sigmoid scores [B, E] of the batch's scenes; ``weight`` [B, E]
        is the pair weight of the head softmax (0 = absent pair)."""
        B, E = kp.shape[0], self.topo.n_pairs
        graph, efeats = self._union(B)
        if self.alt == "1":
            feats, live = torch.func.vmap(
                lambda *a: alt1_node_features(*a, self.img,
                                              self.rig_config.joint_format)
            )(kp, valid, prob, observed, present)
            x_all = torch.cat([feats, efeats.expand(B, -1, -1)], 1)
            return apply_matcher_alt1(
                model, x_all.reshape(-1, x_all.shape[-1]), live,
                (weight > 0).to(kp.dtype), graph,
                pair_softmax_weight=weight,
                generator=generator).view(B, E)
        hfeats, _ = head_features(kp, valid, prob, observed, present,
                                  self.rig, self.img, alt=self.alt)
        x_all = torch.cat([hfeats.reshape(-1, hfeats.shape[-1]), efeats])
        return torch.sigmoid(model(x_all, weight.reshape(-1), graph,
                                   generator)).view(B, E)

    def loss(self, model, batch, generator=None,
             block: Optional[tuple] = None) -> torch.Tensor:
        """The loss of one batch (kp, valid, prob, observed, present,
        labels, weight); ``block`` (lo, hi): the part of it that the scenes
        [lo, hi) add, over the whole batch's weight sum."""
        kp, valid, prob, observed, present, labels, weight = batch
        if self.prune_dist > 0.0:
            weight = self.pruned_weight(kp, valid, observed, weight)
        denom = None
        if block is not None:
            denom = torch.clamp(torch.sum(weight), min=1.0)
            kp, valid, prob, observed, present, labels, weight = (
                t[block[0]:block[1]] for t in (kp, valid, prob, observed,
                                               present, labels, weight))
        scores = self.scores(model, kp, valid, prob, observed, present,
                             weight, generator)
        return matcher_loss(scores, labels, weight, self.use_bce, denom)


def scene_tensors(scenes: MatcherScenes, device, idx=None):
    """The 7 batch tensors of ``scenes`` (rows ``idx``) on ``device``."""
    s = scenes if idx is None else scenes.select(idx)
    return tuple(torch.as_tensor(np.asarray(a), device=device) for a in (
        s.kp, s.valid, s.prob, s.observed, s.present, s.labels,
        s.pair_weight))


def train_matcher(train_scenes: Optional[MatcherScenes],
                  dev_scenes: MatcherScenes,
                  rig_config: RigConfig, rig: CameraRig, topo: PairTopology,
                  cfg: Optional[MatcherConfig] = None,
                  tcfg: Optional[MatcherTrainConfig] = None,
                  mesh=None, checkpoint_path: Optional[str] = None,
                  params: Optional[Dict] = None, opt_state=None,
                  synth_bank=None,
                  log: Callable[[str], None] = print,
                  device="cuda") -> MatcherTrainResult:
    """Train with dev-set early stopping (module header).

    ``rig``: the FULL rig (numpy or tensors); the matching sub-rig is taken
    here.  ``params`` / ``opt_state``: a previous leg to resume (a
    JAX-layout tree; optimizer leaves or a (count, mu, nu) tree,
    ``checkpoint.read_optimizer_leaves``).  ``mesh``: a ``make_mesh()`` of
    the ranks of a ``torch.distributed`` world, ``device`` this rank's
    device."""
    cfg = cfg or MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    tcfg = tcfg or MatcherTrainConfig()
    if tcfg.checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend: "
                         f"{tcfg.checkpoint_backend!r}")
    if synth_bank is not None and not tcfg.scan_epoch:
        raise ValueError("synth_bank requires tcfg.scan_epoch")
    mesh = training_mesh(mesh)
    n_dev = mesh.size if mesh is not None else 1
    dp = mesh is not None and mesh.n_data > 1
    rank0 = mesh is None or mesh.rank == 0
    if not rank0:
        log = lambda message: None          # noqa: E731 -- rank 0 logs
    device = torch.device(device)
    obj = MatcherObjective(rig.select(rig_config.matching_camera_indices()),
                           rig_config, topo, cfg, device,
                           tcfg.use_bce, tcfg.prune_dist)
    model = trainable_matcher_from_tree(
        params if params is not None else random_matcher_tree(cfg, tcfg.seed),
        cfg, device)
    variables = model.tree_params()
    opt = Adam(variables, tcfg.lr, None, opt_state,
               weight_decay=tcfg.weight_decay)
    dropout_on = cfg.feat_drop > 0.0 or cfg.attn_drop > 0.0
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed + 1)
    drop_gen = gen
    if dp:      # the permutation stays shared; each block its own masks
        drop_gen = torch.Generator(device=device)
        drop_gen.manual_seed(tcfg.seed + 1 + 1000003 * (mesh.coords[0] + 1))

    def block_loss(batch, generator=None) -> torch.Tensor:
        if not dp:
            return obj.loss(model, batch, generator)
        return obj.loss(model, batch, generator,
                        block=data_block(mesh, len(batch[0])))

    def step(batch) -> torch.Tensor:
        loss = block_loss(batch, drop_gen if dropout_on else None)
        grads = list(torch.autograd.grad(loss, variables))
        if dp:
            grads = sum_over(mesh.data_group, mesh.n_data, grads)
        opt.step(grads)
        return loss.detach()

    def data_mean(losses) -> float:
        if not losses:
            return 0.0
        t = torch.stack(losses)
        if dp:
            t = sum_over(mesh.data_group, mesh.n_data, [t])[0]
        return float(t.mean())

    bs = max(tcfg.batch_size // n_dev * n_dev, n_dev)
    if synth_bank is not None:
        from mpe3d_tpu_torch.train.matcher_synth import synth_scenes
        k_batches = max(tcfg.limit // bs, 1)
        bank_t = synth_bank.tensors(device, topo)
        n = 0
    else:
        n = len(train_scenes)
        k_batches = n // bs
    if synth_bank is None and tcfg.scan_epoch and k_batches > 0:
        train_t = scene_tensors(train_scenes, device)
    # the dev set on the device, padded to whole batches by zero-weight
    # repeats, so each dev batch is a full one
    dev_t, k_dev = None, 0
    if tcfg.scan_epoch and len(dev_scenes) > 0:
        k_dev = -(-len(dev_scenes) // bs)
        dev_t = scene_tensors(dev_scenes, device, np.resize(
            np.arange(len(dev_scenes)), k_dev * bs))
        w = dev_t[6].clone()
        w[len(dev_scenes):] = 0.0
        dev_t = dev_t[:6] + (w,)

    def host_batches(scenes: MatcherScenes, rng: np.random.Generator):
        order = rng.permutation(len(scenes))
        for i in range(0, len(order), bs):
            sel = order[i:i + bs]
            need = (-len(sel)) % n_dev
            if not need:
                yield scene_tensors(scenes, device, sel)
                continue
            # padded to a multiple of the mesh by repeats at zero weight
            extra = order[:need] if len(order) >= need else sel[:need]
            b = scene_tensors(scenes, device, np.concatenate([sel, extra]))
            w = b[6].clone()
            w[len(sel):] = 0.0
            yield b[:6] + (w,)

    def evaluate() -> float:
        with torch.no_grad():
            if dev_t is not None:
                losses = [block_loss(tuple(t[i * bs:(i + 1) * bs]
                                           for t in dev_t))
                          for i in range(k_dev)]
            else:
                losses = [block_loss(b) for b in
                          host_batches(dev_scenes, np.random.default_rng(0))]
        return data_mean(losses)

    result = MatcherTrainResult(params=None)
    rng = np.random.default_rng(tcfg.seed)
    best, patience = float("inf"), 0
    t0 = time.time()
    try:
        for epoch in range(tcfg.epochs):
            if synth_bank is not None:
                losses = [step(synth_scenes(bank_t, gen, bs))
                          for _ in range(k_batches)]
            elif tcfg.scan_epoch and k_batches > 0:
                perm = torch.randperm(n, generator=gen, device=device)
                losses = [step(tuple(t[idx] for t in train_t))
                          for idx in perm[:k_batches * bs].view(k_batches,
                                                                bs)]
            else:
                losses = [step(b) for b in host_batches(train_scenes, rng)]
            train_loss = data_mean(losses)

            if epoch % tcfg.eval_every == 0:
                val_loss = evaluate()
                result.history.append({"epoch": epoch,
                                       "train_loss": train_loss,
                                       "val_loss": val_loss,
                                       "elapsed_s": time.time() - t0})
                log(f"epoch {epoch:5d} | loss {train_loss:.6f} | "
                    f"val {val_loss:.6f} | patience {patience}")
                improved = val_loss < best
                give_up = not improved and patience + 1 >= tcfg.patience
                improved, give_up = (bool(v) for v in from_rank0(
                    mesh, [improved, give_up], device))
                if improved:
                    best, patience = val_loss, 0
                    result.params = matcher_tree(model)
                    result.best_val_loss = best
                    if checkpoint_path and rank0:
                        save_checkpoint(checkpoint_path, result.params,
                                        opt_state=opt.state(),
                                        meta={"epoch": epoch,
                                              "val_loss": val_loss,
                                              "matcher_config": cfg,
                                              "train_config": tcfg,
                                              "n_slots": topo.n_slots},
                                        backend=tcfg.checkpoint_backend,
                                        wait=False)
                else:
                    patience += 1
                    if give_up:
                        result.epochs_run = epoch + 1   # the epoch did run
                        break
            result.epochs_run = epoch + 1
        if not result.history:
            result.params = matcher_tree(model)
    finally:
        if rank0:
            wait_for_async_saves()      # a failed save must not pass
    result.opt_state = opt.state()
    return result
