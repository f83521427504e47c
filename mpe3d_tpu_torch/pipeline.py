"""End-to-end multi-person 3D pose estimation, one frame at a time.

Port of the fused serving path of ``mpe3d_tpu/pipeline.py``
(``PoseEstimationPipeline.infer_fused`` :1215, program body ``_fused_impl``
:804-892): alt-3 features -> GAT pair scores -> greedy decode on the device
-> per-person gather -> lifter input with its triangulated prior -> MLP
lifter -> poses in metres plus the reprojection quality column.

The serving path is resolved per slot bucket, as a pure function of the
bucket's sizes and the configuration (``serving_path``), where the JAX
package probes its kernels per bucket (``pipeline.py:59-164``):

* the matcher form: ``"stack"`` (``ops/gat_kernel.py``, the whole stack in
  one call) for small buckets, ``"tiled"`` (``ops/gat_tiled.py``, two
  kernels a layer) when the bucket has E >= 1000 pairs (where the
  reference retires its megakernel, ``pipeline.py:80-93``), heads of more
  than 64 incident edges (the stack kernel's cap), or pair pruning on;
* the frame path (``_run_frame``, the counterpart of
  ``ops/frame_kernel.py::build_frame_program``: its "full" variant with the
  stack form, its "split" variant with the tiled form, :965-1103): the GAT,
  one decode + gather + pack kernel (``ops/frame_kernel.py``) and the lifter
  kernel, issued on one stream with no host synchronisation between the
  upload and the download.  Under pair pruning (``pair_prune_dist`` > 0)
  the split path scores and decodes only the compacted candidate pairs and
  scatters the scores back (pruned pairs exactly 0);
* else the eager path (``_run``, the branch without the whole-frame
  kernel): the same GAT form and lifter kernel around a decode loop and
  packing in PyTorch, all pairs (no pruning), as the reference falls back
  to its two-stage program.  With ``use_layer_matcher`` (the reference's
  ``use_pallas_matcher=False``, :354-373) the eager path's GAT takes the
  per-layer form ``"layer"`` instead: one fused projection kernel a layer
  (``ops/fused_proj.py``) and the attention in PyTorch, as the reference's
  XLA program runs ``_gat_layer``; the frame path keeps its own GAT.

The lifter serves in the dtype its weights were loaded for
(``weights.lifter_from_tree``, ``from_checkpoint(serve_dtype=...)``, as
``mpe3d_tpu/pipeline.py:412-456`` resolves it): bf16 by default, int8 for
int8-stored exports or on request, fp32 on request (then the eager path,
as the reference's frame kernel serves only bf16 and int8 lifters).

On a CUDA device the kernels run; on the CPU their plain versions.

Streaming (``mpe3d_tpu/pipeline.py:1161-1213``): ``submit_fused`` issues a
frame's work and its download, asynchronously, into pinned host memory that
the ticket owns, and records a CUDA event; ``collect_fused`` waits on that
event alone.  ``infer_stream`` keeps ``depth`` frames in flight over the
two.  Submits from several threads (the TCP server's clients) are
serialised by a lock around the launch sequence: the kernels' cached
scratch (``ops/gat_tiled.py::_stack_plan``) and plan caches are shared by
every call of a signature, and ctypes releases the GIL inside a launch.
``reload_weights`` swaps the matcher and lifter under the same lock.

The GAT is true fp32: TF32 is switched off for matmuls and convolutions at
import, because rounded operands change decodes (RESULTS.md:1265-1271,
1369-1377).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                        load_matcher_checkpoint)
from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig, MatcherConfig,
                                    RigConfig)
from mpe3d_tpu_torch.data.frames import FrameArrays
from mpe3d_tpu_torch.geometry.camera import CameraRig, project_points
from mpe3d_tpu_torch.lifting.pack import pack_lifter_input
from mpe3d_tpu_torch.matching.decode_device import (
    decode_pairs, decode_person_proposals_device)
from mpe3d_tpu_torch.matching.features import (PairTopology, build_topology,
                                               edge_node_features,
                                               head_features,
                                               pair_mask_from_present,
                                               prune_pair_candidates)
from mpe3d_tpu_torch.models.gat import Matcher, gat_topology
from mpe3d_tpu_torch.models.mlp import Lifter, lifter_is_quantized
from mpe3d_tpu_torch.ops.frame_kernel import (cam_consts, cam_to_world,
                                              frame_decode_pack,
                                              frame_kernel_fits,
                                              frame_kernel_supported)
from mpe3d_tpu_torch.ops.gat_kernel import MAX_D, GatTopology
from mpe3d_tpu_torch.weights import lifter_from_tree, matcher_from_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class PipelineOutput(NamedTuple):
    poses: np.ndarray        # [P, J, 3] metres, world frame
    persons: np.ndarray      # [P, C_match] slot per matching camera (-1 = none)
    scores: np.ndarray       # [E] matcher pair scores (bucketed)
    n_heads: int
    quality: np.ndarray      # [P] mean reprojection residual (px), -1 = none


def pose_quality_px(poses_m: torch.Tensor, kp: torch.Tensor,
                    valid: torch.Tensor, observed: torch.Tensor,
                    rig: CameraRig) -> torch.Tensor:
    """Per-person masked mean reprojection residual in pixels
    (reference pipeline.py:229).  poses_m [P, J, 3]; kp [P, Cu, J, 2];
    valid/observed [P, Cu, J].  -1 for persons with no valid observation."""
    pix = project_points(poses_m[:, None], rig.T_wc[None, :, None],
                         rig.K[None, :, None], rig.dist[None, :, None],
                         min_depth=1e-4)                     # [P, Cu, J, 2]
    mf = ((valid > 0) & observed).to(torch.float32)
    d = torch.linalg.norm(torch.clamp(kp - pix, -1e5, 1e5), dim=-1)
    tot = torch.sum(mf, (1, 2))
    q = torch.sum(d * mf, (1, 2)) / torch.clamp(tot, min=1.0)
    return torch.where(tot > 0, q, torch.full_like(q, -1.0))


# pairs from which the tiled matcher serves (the reference retires its
# whole-stack kernel there, mpe3d_tpu/pipeline.py:80-93)
TILED_MIN_PAIRS = 1000


def prune_cap(n_pairs: int, cap: int) -> int:
    """Compacted pair count under pruning: ``cap``, or 0 for auto
    max(256, E // 2), at most E (``ops/frame_kernel.py:970-977``)."""
    return min(cap if cap > 0 else max(256, n_pairs // 2), n_pairs)


def resolve_serving_path(n_cameras: int, slots: int, *, prune: bool,
                         cap: int = 0, frame_ok: bool = True,
                         layer: bool = False) -> Tuple[str, bool]:
    """(matcher form, frame path on) of a slot bucket of ``n_cameras``
    matching cameras and ``slots`` slots.  The frame path is on when the
    configuration allows it (``frame_ok``) and the bucket fits
    ``frame_decode_pack`` with the pairs its decode gets (the compacted
    ``cap`` under pruning).  The form is "layer" on the eager path when
    ``layer`` is asked for; else "tiled" when the bucket has
    E >= TILED_MIN_PAIRS pairs, a head degree D = (C-1)*S above the stack
    kernel's MAX_D, or pruning on; else "stack"."""
    E = n_cameras * (n_cameras - 1) // 2 * slots * slots
    D = (n_cameras - 1) * slots
    E_dec = prune_cap(E, cap) if prune else E
    frame = frame_ok and frame_kernel_fits(E_dec, n_cameras, slots)
    if layer and not frame:
        return "layer", frame
    form = ("tiled" if E >= TILED_MIN_PAIRS or D > MAX_D or prune
            else "stack")
    return form, frame


class _Bucket(NamedTuple):
    """Per-slot-bucket state on the device."""

    topo: PairTopology
    gtopo: GatTopology       # index tensors for the matcher form
    efeats: torch.Tensor     # [E, in_dim] edge-node features
    pairs: torch.Tensor      # [E, 4] int32 decode pairs
    form: str                # "stack", "tiled" or "layer"
    dtopo: PairTopology      # the topology's arrays as device tensors


# the pipeline's lifter dtype -> the serve_dtype of weights.lifter_from_tree
_TREE_DTYPE = {"bf16": None, "fp32": "fp32", "int8": "int8"}


def _slot_view(a: np.ndarray, S: int) -> np.ndarray:
    """Restrict a per-frame buffer [C, slots, ...] to S slots: slice, or
    zero-pad (absent slots) when the frame has fewer."""
    a = np.asarray(a)
    if a.shape[1] >= S:
        return a[:, :S]
    pad = np.zeros((a.shape[0], S - a.shape[1]) + a.shape[2:], a.dtype)
    return np.concatenate([a, pad], axis=1)


class PoseEstimationPipeline:
    """Frame -> poses with the learned lifter, on ``device``.

    ``use_frame_kernel``: None ("auto") serves a bucket through the frame
    path on a CUDA device when ``frame_kernel_supported`` holds and the
    bucket fits the kernel, through the eager path otherwise; True forces
    the frame path (raises if the configuration or a bucket is unsupported;
    on the CPU it runs the plain versions); False keeps the eager path.

    ``pair_prune_dist`` (metres, 0 = off) and ``pair_prune_cap`` (0 = auto):
    geometric candidate-pair pruning on the frame path
    (``mpe3d_tpu/pipeline.py:321-336``): pairs whose mean ray distance
    exceeds the distance score exactly 0, and the GAT and the decode run on
    the ``prune_cap`` best-ranked pairs.  Opt-in: pruned edges leave the
    head softmax, so surviving scores move.

    ``use_layer_matcher``: the eager path's GAT runs in the per-layer form
    (module header); ``serving_path(S)`` reports it.

    The lifter's dtype is the one it was built for (``Lifter.serve_dtype``,
    also ``self.serve_dtype``); ``from_checkpoint`` takes ``serve_dtype``."""

    def __init__(self, rig_config: RigConfig, rig: CameraRig,
                 matcher: Matcher, lifter: Lifter,
                 slot_buckets: Tuple[int, ...] = (2, 4, 10),
                 person_buckets: Tuple[int, ...] = (4, 8, 16),
                 threshold: float = 0.5, decode_top_k: int = 64,
                 lifter_prior: str = "mean",
                 prior_gate_px: Optional[float] = None,
                 use_frame_kernel: Optional[bool] = None,
                 pair_prune_dist: float = 0.0, pair_prune_cap: int = 0,
                 use_layer_matcher: bool = False, device="cuda"):
        if rig_config.graph_alternative != "3":
            raise NotImplementedError("only the alt-3 matcher graph is ported")
        if pair_prune_dist < 0:
            raise ValueError(f"pair_prune_dist must be >= 0 (metres), got "
                             f"{pair_prune_dist!r}")
        self.pair_prune_dist = float(pair_prune_dist)
        self.pair_prune_cap = int(pair_prune_cap)
        self.rig_config = rig_config
        self.device = torch.device(device)
        self.matcher = matcher.to(self.device)
        self.lifter = lifter.to(self.device)
        self.slot_buckets = slot_buckets
        self.person_buckets = person_buckets
        self.threshold = threshold
        self.decode_top_k = decode_top_k
        self.lifter_prior = lifter_prior
        self.prior_gate_px = prior_gate_px
        self.use_frame_kernel = use_frame_kernel
        self.use_layer_matcher = bool(use_layer_matcher)
        self.serve_dtype = self.lifter.serve_dtype
        self.match_idx = rig_config.matching_camera_indices()
        self.used_idx = rig_config.used_camera_indices()
        self.match_rig = rig.select(self.match_idx).to(self.device)
        self.used_rig = rig.select(self.used_idx).to(self.device)
        self.image_size = (float(rig_config.image_width),
                           float(rig_config.image_height))
        match_names = [rig_config.camera_names[i] for i in self.match_idx]
        used_names = [rig_config.camera_names[i] for i in self.used_idx]
        # used camera -> row of the decoded persons (-1: not a matching one)
        self._used_pos = torch.tensor(
            [match_names.index(c) if c in match_names else -1
             for c in used_names], dtype=torch.long, device=self.device)
        self._used_pos32 = self._used_pos.to(torch.int32)
        self._cams = cam_consts(self.used_rig).to(self.device)
        self._cam_world = cam_to_world(self.used_rig).to(self.device)
        self._match_sel = torch.tensor(self.match_idx, device=self.device)
        self._used_sel = torch.tensor(self.used_idx, device=self.device)
        self._topos: Dict[int, _Bucket] = {}
        # serialises submits (their launches share cached scratch) and the
        # weight swap of reload_weights
        self._submit_lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, models_dir: str, rig: CameraRig,
                        rig_config: RigConfig = PANOPTIC, device="cuda",
                        serve_dtype: Optional[str] = None,
                        **kwargs) -> "PoseEstimationPipeline":
        """Matcher ``skeleton_matching`` and lifter ``pose_estimator`` from
        a models directory; architecture, ``residual_prior`` and the packing
        ``prior`` come from the checkpoint meta.  The lifter serves in
        ``serve_dtype`` (``weights.lifter_from_tree``: int8 exports always
        in int8)."""
        mtree, mcfg = load_matcher_checkpoint(
            os.path.join(models_dir, "skeleton_matching"),
            MatcherConfig(in_dim=rig_config.matcher_feature_dim))
        ltree, lcfg, prior = load_lifter_checkpoint(
            os.path.join(models_dir, "pose_estimator"),
            LifterConfig(in_dim=rig_config.lifter_input_dim,
                         out_dim=rig_config.n_joints * 3))
        return cls(rig_config, rig, matcher_from_tree(mtree, mcfg, device),
                   lifter_from_tree(ltree, lcfg, device, serve_dtype),
                   lifter_prior=prior,
                   device=device, **kwargs)

    def _bucket(self, n: int) -> int:
        for b in self.slot_buckets:
            if n <= b:
                return b
        return self.slot_buckets[-1]

    def _person_bucket(self, n: int) -> int:
        for b in self.person_buckets:
            if n <= b:
                return b
        return self.person_buckets[-1]

    def _p_max(self, S: int) -> int:
        """Decode person-slot cap for a slot bucket."""
        return min(self.person_buckets[-1],
                   max(len(self.match_idx) * S
                       // max(self.rig_config.min_number_of_views, 1), 1))

    def topology(self, slots: int) -> PairTopology:
        return self._bucket_state(slots)[0]

    def _bucket_state(self, slots: int) -> _Bucket:
        """The device state of a bucket (``_Bucket``)."""
        if slots not in self._topos:
            topo = build_topology(len(self.match_idx), slots)
            form = resolve_serving_path(
                topo.n_cameras, slots, prune=self.pair_prune_dist > 0,
                cap=self.pair_prune_cap, frame_ok=self.frame_path_on(),
                layer=self.use_layer_matcher)[0]
            as_t = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=torch.int32, device=self.device)
            self._topos[slots] = _Bucket(
                topo, gat_topology(topo, self.device, form),
                edge_node_features(topo.n_pairs,
                                   self.rig_config.matcher_feature_dim,
                                   device=self.device),
                as_t(decode_pairs(topo)), form,
                PairTopology(topo.n_cameras, slots, as_t(topo.e1),
                             as_t(topo.e2), as_t(topo.cam1),
                             as_t(topo.cam2)))
        return self._topos[slots]

    def serving_path(self, slots: int) -> Tuple[str, bool]:
        """(matcher form, frame path on) for the slot bucket ``slots``: a
        pure function of the bucket's sizes and the configuration
        (``resolve_serving_path``).  Raises when ``use_frame_kernel=True``
        and the frame path does not serve the bucket."""
        form, frame = resolve_serving_path(
            len(self.match_idx), slots, prune=self.pair_prune_dist > 0,
            cap=self.pair_prune_cap, frame_ok=self.frame_path_on(),
            layer=self.use_layer_matcher)
        if self.use_frame_kernel is True and not frame:
            raise ValueError(f"use_frame_kernel=True, but the frame path "
                             f"does not serve the S={slots} bucket (it "
                             f"exceeds the limits of frame_decode_pack)")
        return form, frame

    def frame_path_on(self) -> bool:
        """Whether the configuration (on this device) lets ``submit_fused``
        serve through the frame path; each bucket must also fit it
        (``serving_path``)."""
        if self.use_frame_kernel is False:
            return False
        supported = frame_kernel_supported(self)
        if self.use_frame_kernel is True:
            if not supported:
                raise ValueError("use_frame_kernel=True, but the frame path "
                                 "does not serve this configuration")
            return True
        return supported and self.device.type == "cuda"

    def _frame_tensors(self, frame: FrameArrays):
        """Bucket the frame and move its five buffers to the device in one
        copy: packed into one (pinned, on a CUDA device) host buffer,
        uploaded with ``non_blocking=True``, viewed back on the device."""
        S = self._bucket(max(1, int(frame.present.sum(axis=1).max())))
        host = [np.ascontiguousarray(_slot_view(a, S), dtype=dt)
                for a, dt in ((frame.kp, np.float32),
                              (frame.valid, np.float32),
                              (frame.prob, np.float32),
                              (frame.in_view, np.bool_),
                              (frame.present, np.bool_))]
        buf = torch.empty(sum(a.nbytes for a in host), dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        flat, off = buf.numpy(), 0
        for a in host:      # fp32 buffers first: every offset stays aligned
            flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            off += a.nbytes
        dev, args, off = buf.to(self.device, non_blocking=True), [], 0
        for a in host:
            dt = torch.float32 if a.dtype == np.float32 else torch.bool
            args.append(dev[off:off + a.nbytes].view(dt).view(a.shape))
            off += a.nbytes
        return S, args

    def _match_inputs(self, S: int, kp, valid, prob, observed, present):
        """GAT node features [H+E, in_dim] and pair mask [E]."""
        b = self._bucket_state(S)
        ms = self._match_sel
        hfeats, _ = head_features(kp[ms], valid[ms], prob[ms], observed[ms],
                                  present[ms], self.match_rig,
                                  self.image_size)
        pmask = pair_mask_from_present(present[ms], b.gtopo.e1, b.gtopo.e2)
        return torch.cat([hfeats, b.efeats], 0), pmask

    def _person_obs(self, persons, kp, valid, prob, observed):
        """Each decoded person's observations in the used cameras:
        kp [P, Cu, J, 2], valid/prob/observed [P, Cu, J]."""
        up = self._used_pos
        slot_u = torch.where(up[None, :] >= 0,
                             persons[:, torch.clamp(up, min=0)],
                             torch.full_like(persons[:, :1], -1))  # [P, Cu]
        take = torch.clamp(slot_u, min=0)
        has = slot_u >= 0
        cams = torch.arange(len(self.used_idx), device=self.device)[None, :]
        us = self._used_sel
        return (kp[us][cams, take] * has[..., None, None],
                valid[us][cams, take] * has[..., None],
                prob[us][cams, take] * has[..., None],
                observed[us][cams, take] & has[..., None])

    def _scores(self, b: _Bucket, x, pw, gtopo):
        """Matcher scores through the bucket's form; the edge rows of x are
        the shared alt-3 edge one-hot, so the stack and tiled forms project
        it once."""
        return torch.sigmoid(self.matcher(x, pw, gtopo, b.form,
                                          edge_const=True)) * pw

    @torch.inference_mode()
    def _run(self, S: int, kp, valid, prob, observed, present):
        b = self._bucket_state(S)
        topo, gtopo = b.topo, b.gtopo
        p_max = self._p_max(S)
        x_all, pmask = self._match_inputs(S, kp, valid, prob, observed,
                                          present)
        scores = self._scores(b, x_all, pmask, gtopo)
        persons, person_mask = decode_person_proposals_device(
            scores, pmask, topo, self.rig_config.min_number_of_views,
            self.threshold, p_max, top_k=self.decode_top_k)
        pkp, pval, pprob, pobs = self._person_obs(persons, kp, valid, prob,
                                                  observed)
        nets, _ = pack_lifter_input(pkp, pval, pprob, pobs, self.used_rig,
                                    self.image_size, prior=self.lifter_prior,
                                    prior_gate_px=self.prior_gate_px)
        out = self.lifter(nets)
        poses = out.reshape(p_max, self.rig_config.n_joints, 3) * 10.0
        quality = pose_quality_px(poses, pkp, pval, pobs, self.used_rig)
        poses = poses * person_mask[:, None, None]
        return ((poses, persons.to(torch.int32), person_mask, scores,
                 quality), (x_all, pmask, gtopo, nets))

    def _frame_decode_args(self, S: int, scores, pmask, kp, valid, prob,
                           observed, pairs=None):
        """(positional, keyword) arguments of ``frame_decode_pack``; its
        pairs are the bucket's or, under pruning, the compacted ones."""
        b = self._bucket_state(S)
        pairs = b.pairs if pairs is None else pairs
        us = self._used_sel
        args = (scores, pmask, pairs, self._used_pos32, kp[us], valid[us],
                prob[us], observed[us], self._cams, self._cam_world)
        E, top_k = b.topo.n_pairs, self.decode_top_k
        k_cap = min(top_k, E) if top_k else E
        kw = dict(n_cameras=b.topo.n_cameras, threshold=self.threshold,
                  min_views=self.rig_config.min_number_of_views,
                  k_cap=min(k_cap, scores.shape[0]), P=self._p_max(S),
                  prior=self.lifter_prior, gate_px=self.prior_gate_px,
                  image_size=self.image_size)
        return args, kw

    def _gat_inputs(self, S: int, kp, valid, prob, observed, present):
        """What the frame path gives the GAT: (node features, pair weights,
        topology tensors, decode pairs, compaction indices or None).  Under
        pruning the gate and compaction (``frame_kernel.py:1003-1044``):
        the heads and the first ``cap`` edge rows (all edge rows are the
        same one-hot), the kept pairs' weights and endpoints."""
        b = self._bucket_state(S)
        x_all, pmask = self._match_inputs(S, kp, valid, prob, observed,
                                          present)
        if self.pair_prune_dist <= 0:
            return x_all, pmask, b.gtopo, b.pairs, None
        ms = self._match_sel
        cap = prune_cap(b.topo.n_pairs, self.pair_prune_cap)
        idx, w = prune_pair_candidates(
            kp[ms], valid[ms] * observed[ms].to(kp.dtype), self.match_rig,
            b.dtopo, pmask, self.pair_prune_dist, cap)
        H = b.topo.n_heads
        gtopo = GatTopology(b.gtopo.e1[idx], b.gtopo.e2[idx], H)
        return x_all[:H + cap], w, gtopo, b.pairs[idx], idx

    @torch.inference_mode()
    def _run_frame(self, S: int, kp, valid, prob, observed, present):
        """The frame path: features, (under pruning: the gate and
        compaction,) the GAT, the decode + gather + pack kernel, the lifter
        kernel and the epilogue, with no host synchronisation
        (``frame_kernel.py:883-1103``).  Pruned scores are scattered back
        to the bucket's pairs, pruned ones exactly 0 (:1098-1102)."""
        b = self._bucket_state(S)
        x, pw, gtopo, pairs, idx = self._gat_inputs(S, kp, valid, prob,
                                                    observed, present)
        scores = self._scores(b, x, pw, gtopo)
        args, kw = self._frame_decode_args(S, scores, pw, kp, valid, prob,
                                           observed, pairs)
        f = frame_decode_pack(*args, **kw)
        # the residual prior (fields 11-13 of camera block 0) is added in
        # Lifter.forward
        poses = self.lifter(f.net).reshape(kw["P"], -1, 3) * 10.0
        quality = pose_quality_px(poses, f.kp, f.valid, f.observed,
                                  self.used_rig)
        poses = poses * f.person_mask[:, None, None]
        if idx is not None:
            scores = torch.zeros(b.topo.n_pairs, dtype=scores.dtype,
                                 device=scores.device).index_copy(0, idx,
                                                                  scores)
        return (poses, f.persons, f.person_mask, scores, quality), (args, kw)

    def stage_inputs(self, frame: FrameArrays):
        """The inputs the frame gives the kernels on the eager path: (GAT
        node features, pair weights, topology tensors, lifter input rows).
        For checks and measurements of the kernels alone."""
        S, args = self._frame_tensors(frame)
        return self._run(S, *args)[1]

    def frame_stage_inputs(self, frame: FrameArrays):
        """(positional arguments, keyword arguments) the frame path gives
        ``frame_decode_pack`` for this frame."""
        S, args = self._frame_tensors(frame)
        return self._run_frame(S, *args)[1]

    @torch.inference_mode()
    def gat_stage_inputs(self, frame: FrameArrays):
        """(node features, pair weights, topology tensors, matcher form)
        the frame path gives the GAT for this frame (compacted under
        pruning).  For checks and measurements of the kernels alone."""
        S, args = self._frame_tensors(frame)
        x, pw, gtopo, _, _ = self._gat_inputs(S, *args)
        return x, pw, gtopo, self._bucket_state(S).form

    def _on_device(self):
        """This pipeline's device as the current CUDA device (the calling
        thread's own may be another); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _download(self, out):
        """Start the copy of a frame's five outputs to the host: on a CUDA
        device into one pinned buffer that the ticket owns (in flight
        tickets never share one), each copy ``non_blocking``, then a CUDA
        event that :meth:`collect_fused` waits on.  Returns (host tensors,
        event or None)."""
        if self.device.type != "cuda":
            return out, None
        sizes = [-(-t.numel() * t.element_size() // 16) * 16 for t in out]
        buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
        host, off = [], 0
        for t, n in zip(out, sizes):
            v = buf[off:off + t.numel() * t.element_size()].view(
                t.dtype).view(t.shape)
            v.copy_(t, non_blocking=True)
            host.append(v)
            off += n
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def submit_fused(self, frame: FrameArrays):
        """Start one frame on the device and its download to the host,
        without waiting for either; returns a ticket for
        :meth:`collect_fused`.  Thread-safe: submits are serialised (host
        time only, the launches are asynchronous)."""
        with self._submit_lock, torch.inference_mode(), self._on_device():
            S, args = self._frame_tensors(frame)
            run = self._run_frame if self.serving_path(S)[1] else self._run
            return (frame,) + self._download(run(S, *args)[0])

    def collect_fused(self, ticket) -> PipelineOutput:
        """Wait for a ticket's download and crop to the real persons (int32
        slots, as the reference's decode gives them)."""
        frame, host, done = ticket
        if done is not None:
            done.synchronize()
        poses, persons, person_mask, scores, quality = (t.numpy()
                                                        for t in host)
        n = int(person_mask.sum())
        return PipelineOutput(poses[:n], persons[:n].astype(np.int32),
                              scores, int(frame.present.sum()), quality[:n])

    def infer_fused(self, frame: FrameArrays) -> PipelineOutput:
        """Full-frame inference."""
        return self.collect_fused(self.submit_fused(frame))

    def infer_stream(self, frames: Iterable[FrameArrays],
                     depth: int = 3) -> Iterator[PipelineOutput]:
        """Pipelined inference: keeps ``depth`` frames in flight (frame
        i + depth - 1 is submitted before frame i is collected), so the
        host's work on the next frames overlaps the device's on earlier
        ones.  Yields the outputs in frame order."""
        pending = []
        for frame in frames:
            pending.append(self.submit_fused(frame))
            if len(pending) >= depth:
                yield self.collect_fused(pending.pop(0))
        while pending:
            yield self.collect_fused(pending.pop(0))

    def warmup(self, slots: Optional[int] = None,
               persons: Optional[int] = None, fused: bool = True) -> None:
        """Run one all-present frame of zeros through ``submit_fused`` for
        every slot bucket (or ``slots`` alone): the first call of a bucket
        builds its device state, the kernels' plans and tables and, on the
        card, the kernel library.  The reference's staged path (its
        ``persons`` buckets and ``fused=False``) is not ported (ROADMAP.md
        section 1, item 6) and raises."""
        if persons is not None or not fused:
            raise NotImplementedError(
                "warmup(persons=..., fused=False) warms the staged path, "
                "which is not ported (ROADMAP.md section 1, item 6)")
        C, J = self.rig_config.n_cameras, self.rig_config.n_joints
        for S in ([slots] if slots else self.slot_buckets):
            self.infer_fused(FrameArrays(
                np.zeros((C, S, J, 2), np.float32),
                np.zeros((C, S, J), np.float32),
                np.zeros((C, S, J), np.float32), np.zeros((C, S, J), bool),
                np.ones((C, S), bool), np.zeros(C)))

    def reload_weights(self, matcher_tree=None, lifter_tree=None) -> None:
        """Swap the serving weights for trees in the JAX package's layout
        (``weights.py``; ``checkpoint.py`` reads them from npz files)
        without rebuilding the pipeline (``mpe3d_tpu/pipeline.py:1063-
        1160``, without its multi-device part).

        The new weights get the construction's serving transform (the
        lifter in this pipeline's ``serve_dtype``: int8 quantised, bf16
        cast or fp32) and must have the current architecture: a shape
        mismatch, or an int8 tree for a pipeline that does not serve int8,
        raises ValueError with the serving weights untouched.  Everything
        is built and checked first; then the matcher and lifter are swapped
        together under the submit lock, so each frame sees old or new
        weights, never a mix.  Frames submitted earlier keep reading the
        old tensors: every launch is on one stream, so the caching
        allocator hands their memory to a later allocation only in stream
        order, after those launches.  The lifter's run tables are keyed by
        weight addresses (``ops/fused_mlp.py::mlp_run``) and hold only
        addresses and shapes, and the tiled GAT's cached plans
        (``ops/gat_tiled.py::_stack_plan``) no weight address, so neither
        serves stale weights."""
        matcher, lifter = self.matcher, self.lifter
        if matcher_tree is not None:
            matcher = matcher_from_tree(matcher_tree, self.matcher.cfg,
                                        self.device)
        if lifter_tree is not None:
            if (lifter_is_quantized(lifter_tree)
                    and self.serve_dtype != "int8"):
                raise ValueError(
                    f"reload_weights: the lifter tree is an int8 export, "
                    f"but this pipeline serves {self.serve_dtype} (restart "
                    f"on the int8 checkpoint, or reload a fp32/bf16 one)")
            lifter = lifter_from_tree(lifter_tree, self.lifter.cfg,
                                      self.device,
                                      _TREE_DTYPE[self.serve_dtype])
            old = [(n, t.shape, t.dtype) for n, t in
                   self.lifter.named_buffers()]
            new = [(n, t.shape, t.dtype) for n, t in lifter.named_buffers()]
            if new != old or lifter.serve_dtype != self.serve_dtype:
                raise ValueError(f"reload_weights: lifter shape mismatch "
                                 f"({new} vs current {old})")
        with self._submit_lock:
            self.matcher, self.lifter = matcher, lifter
