"""End-to-end multi-person 3D pose estimation: one frame, a batch of frames,
or the staged debug path.

Port of ``mpe3d_tpu/pipeline.py``: the fused serving path
(``PoseEstimationPipeline.infer_fused`` :1215, program body ``_fused_impl``
:804-892): matcher features of the rig's graph alternative -> GAT pair
scores (``_score_core`` :585-645) -> greedy decode on the device
-> per-person gather -> the 3D backend -> poses in metres plus the
reprojection quality column.  The 3D backend is the MLP lifter (the lifter
input with its triangulated prior, ``backend="mlp"``) or the classical
triangulation (``backend="triangulation"``: ``triangulate_median_filtered``
or, with ``tri_variant="irls"``, ``triangulate_irls``; plain PyTorch, as
the reference's are plain JAX).

The serving path is resolved per slot bucket, as a pure function of the
bucket's sizes and the configuration (``serving_path``), where the JAX
package probes its kernels per bucket (``pipeline.py:59-164``):

* the matcher form: ``"stack"`` (``ops/gat_kernel.py``, the whole stack in
  one call) for small buckets, ``"tiled"`` (``ops/gat_tiled.py``, two
  kernels a layer) when the bucket has E >= 1000 pairs (where the
  reference retires its megakernel, ``pipeline.py:80-93``), heads of more
  than 64 incident edges (the stack kernel's cap), or pair pruning on;
  ``"layer"`` for a residual matcher (the reference serves it through its
  XLA per-layer program, :343-345); ``"alt1"`` on the alt-1 graph
  (``matching/alt1.py``: a joint-node graph, plain PyTorch as the
  reference's is XLA);
* the frame path (``_run_frames``, the counterpart of
  ``ops/frame_kernel.py::build_frame_program``: its "full" variant with the
  stack form, its "split" variant with the tiled form, :965-1103): the GAT,
  one decode + gather + pack kernel (``ops/frame_kernel.py``) and the lifter
  kernel, issued on one stream with no host synchronisation between the
  upload and the download.  Under pair pruning (``pair_prune_dist`` > 0)
  the split path scores and decodes only the compacted candidate pairs and
  scatters the scores back (pruned pairs exactly 0);
* else the eager path (``_run``, the branch without the whole-frame
  kernel): the same GAT form and 3D backend around a decode loop and
  packing in PyTorch, all pairs (no pruning), as the reference falls back
  to its two-stage program.  With ``use_layer_matcher`` (the reference's
  ``use_pallas_matcher=False``, :354-373) the eager path's GAT takes the
  per-layer form ``"layer"`` instead: one fused projection kernel a layer
  (``ops/fused_proj.py``) and the attention in PyTorch, as the reference's
  XLA program runs ``_gat_layer``; the frame path keeps its own GAT.
  The triangulation backend, the geometric rerank / rescue of the
  decode (``geo_rerank``, ``geo_rescue``: ``_geo_decode_scores``), the
  alt-1 and alt-2 graphs and residual matchers serve only here, as the
  reference's frame kernel excludes them (``frame_kernel_supported``).

The batch path (``infer_batch`` / ``submit_batch`` / ``collect_batch``,
reference :898-1012, its offline and micro-batched throughput mode) runs B
frames of one slot bucket as one ticket.  Where the bucket's frame path is
on, each chunk of at most ``batch_plan`` frames is one run of the frame
path's body (``_run_frames``, a served frame is its one-frame case): the B
frames' features in batched tensor ops, ONE GAT call on the disjoint union of their
graphs (heads of frame b offset by b*H, edges by b*E: a GAT layer mixes a
head only with its own incident edges, so the union computes each frame's
scores), the decode + gather + pack kernel over a grid of the B frames, the
lifter kernel on the B*P rows (a launch a group of 64 rows), the quality
column; then one download for all chunks.  Otherwise (the eager path's
configurations: the CPU unless ``use_frame_kernel=True``, geo rerank or
rescue, the triangulation backend, an fp32 lifter) the chunk is the eager
body frame by frame, as ``batch_plan`` reports.  The batch scores all
pairs: pair pruning, like the reference's batch program, does not apply.

The staged path (reference :1220-1370: ``match``, ``match_decode``,
``host_decode_scores``, ``gather_person_obs``, ``lift``, ``__call__``) is
the reference's debug path: the matcher's scores to the host, the host
decode (``matching/decode.py``; or the device decode with
``decode_on_device``), the 3D backend on the person bucket's rows; a rig
with one matching camera takes every present skeleton as a person
(``single_camera_bypass``).  Its slot bucket counts the matching cameras'
skeletons only, as the reference's does.

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
import sys
import threading
from typing import (Dict, Iterable, Iterator, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                        load_matcher_checkpoint)
from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig, MatcherConfig,
                                    RigConfig)
from mpe3d_tpu_torch.data.frames import FrameArrays
from mpe3d_tpu_torch.geometry.camera import CameraRig, project_points
from mpe3d_tpu_torch.geometry.triangulate import (triangulate_irls,
                                                  triangulate_median_filtered)
from mpe3d_tpu_torch.lifting.pack import pack_lifter_input
from mpe3d_tpu_torch.matching.alt1 import (Alt1Graph, alt1_graph,
                                           alt1_node_features,
                                           apply_matcher_alt1,
                                           build_alt1_topology)
from mpe3d_tpu_torch.matching.decode import (decode_person_proposals,
                                             single_camera_bypass)
from mpe3d_tpu_torch.matching.decode_device import (
    decode_pairs, decode_person_proposals_device)
from mpe3d_tpu_torch.matching.features import (PairTopology, build_topology,
                                               edge_node_features,
                                               head_features,
                                               pair_mask_from_present,
                                               pair_ray_distances,
                                               prune_pair_candidates)
from mpe3d_tpu_torch.models.gat import (Matcher, gat_topology,
                                        union_topology)
from mpe3d_tpu_torch.models.mlp import Lifter, lifter_is_quantized
from mpe3d_tpu_torch.ops.frame_kernel import (cam_consts, cam_to_world,
                                              frame_decode_pack,
                                              frame_kernel_fits,
                                              frame_kernel_supported)
from mpe3d_tpu_torch.ops.gat_kernel import MAX_D, GatTopology
from mpe3d_tpu_torch.ops.gat_tiled import MAX_HEADS, MAX_PAIRS
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
                    rig: CameraRig,
                    joint_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-person masked mean reprojection residual in pixels
    (reference pipeline.py:229).  poses_m [P, J, 3]; kp [P, Cu, J, 2];
    valid/observed [P, Cu, J]; joint_ok [P, J] (the triangulation backend's
    reconstructed joints: the others are zero-filled and do not count).
    -1 for persons with no valid observation."""
    pix = project_points(poses_m[:, None], rig.T_wc[None, :, None],
                         rig.K[None, :, None], rig.dist[None, :, None],
                         min_depth=1e-4)                     # [P, Cu, J, 2]
    m = (valid > 0) & observed
    if joint_ok is not None:
        m = m & joint_ok[:, None, :]
    mf = m.to(torch.float32)
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
                         layer: bool = False,
                         alt1: bool = False) -> Tuple[str, bool]:
    """(matcher form, frame path on) of a slot bucket of ``n_cameras``
    matching cameras and ``slots`` slots.  The frame path is on when the
    configuration allows it (``frame_ok``) and the bucket fits
    ``frame_decode_pack`` with the pairs its decode gets (the compacted
    ``cap`` under pruning).  The form is "alt1" on the alt-1 graph
    (``alt1``, never on the frame path); "layer" on the eager path when
    ``layer`` is asked for (or the matcher is residual); else "tiled" when
    the bucket has E >= TILED_MIN_PAIRS pairs, a head degree
    D = (C-1)*S above the stack kernel's MAX_D, or pruning on; else
    "stack"."""
    E = n_cameras * (n_cameras - 1) // 2 * slots * slots
    D = (n_cameras - 1) * slots
    E_dec = prune_cap(E, cap) if prune else E
    frame = frame_ok and frame_kernel_fits(E_dec, n_cameras, slots)
    if alt1:
        return "alt1", False
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
    form: str                # "stack", "tiled", "layer" or "alt1"
    dtopo: PairTopology      # the topology's arrays as device tensors
    alt1: Optional[Alt1Graph] = None   # the alt-1 graph's edge list


class BatchPlan(NamedTuple):
    """How ``submit_batch`` runs the frames of one slot bucket: each chunk
    (its frame count, in order) is one body of the batch path (``union``:
    the union GAT and the decode kernel over the chunk's frames) or, where
    the bucket's frame path is off, the eager body frame by frame."""

    union: bool
    chunks: Tuple[int, ...]


BACKENDS = ("mlp", "triangulation")
GRAPH_ALTERNATIVES = ("1", "2", "3")
TRI_VARIANTS = ("median", "irls")
PRIORS = ("mean", "median", "irls")
# the frame buffers a submit uploads, with their dtypes (fp32 ones first:
# every offset of the packed upload stays aligned)
_BUFFERS = (("kp", np.float32), ("valid", np.float32), ("prob", np.float32),
            ("in_view", np.bool_), ("present", np.bool_))

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
    """Frame -> poses, on ``device``.

    ``backend``: "mlp" (the learned lifter; ``lifter`` required) or
    "triangulation" (``tri_variant`` "median", the reference's median
    filter, or "irls"; ``lifter`` may be None).

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

    ``geo_rerank`` (0 = off) orders the decode by score - geo_rerank *
    clip(d / geo_scale, 0, 1), d the pair's mean ray distance in metres;
    ``geo_rescue`` (0 = off) makes pairs scoring above it with d below
    ``geo_rescue_dist`` eligible, and forces the uncapped decode
    (``mpe3d_tpu/pipeline.py:279-300``).  Either takes the eager path.

    ``decode_on_device``: the staged ``__call__`` decodes on the device
    (``match_decode``) instead of on the host.

    ``use_layer_matcher``: the eager path's GAT runs in the per-layer form
    (module header); ``serving_path(S)`` reports it.

    The lifter's dtype is the one it was built for (``Lifter.serve_dtype``,
    also ``self.serve_dtype``; None without a lifter); ``from_checkpoint``
    takes ``serve_dtype``."""

    def __init__(self, rig_config: RigConfig, rig: CameraRig,
                 matcher: Matcher, lifter: Optional[Lifter],
                 slot_buckets: Tuple[int, ...] = (2, 4, 10),
                 person_buckets: Tuple[int, ...] = (4, 8, 16),
                 threshold: float = 0.5, decode_top_k: int = 64,
                 lifter_prior: str = "mean",
                 prior_gate_px: Optional[float] = None,
                 use_frame_kernel: Optional[bool] = None,
                 pair_prune_dist: float = 0.0, pair_prune_cap: int = 0,
                 use_layer_matcher: bool = False, device="cuda", *,
                 backend: str = "mlp", tri_variant: str = "median",
                 decode_on_device: bool = False, geo_rerank: float = 0.0,
                 geo_scale: float = 0.3, geo_rescue: float = 0.0,
                 geo_rescue_dist: float = 0.05):
        if rig_config.graph_alternative not in GRAPH_ALTERNATIVES:
            raise ValueError(f"graph_alternative must be one of "
                             f"{GRAPH_ALTERNATIVES}, got "
                             f"{rig_config.graph_alternative!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if lifter is None and backend == "mlp":
            raise ValueError("backend='mlp' needs a lifter")
        if tri_variant not in TRI_VARIANTS:
            raise ValueError(f"tri_variant must be 'median' or 'irls', got "
                             f"{tri_variant!r}")
        if lifter_prior not in PRIORS:
            raise ValueError(f"lifter_prior must be 'mean', 'median' or "
                             f"'irls', got {lifter_prior!r}")
        if prior_gate_px is not None and prior_gate_px <= 0:
            raise ValueError(f"prior_gate_px must be positive or None, got "
                             f"{prior_gate_px!r}")
        if pair_prune_dist < 0:
            raise ValueError(f"pair_prune_dist must be >= 0 (metres), got "
                             f"{pair_prune_dist!r}")
        self.pair_prune_dist = float(pair_prune_dist)
        self.pair_prune_cap = int(pair_prune_cap)
        self.rig_config = rig_config
        self.device = torch.device(device)
        self.matcher = matcher.to(self.device)
        self.lifter = None if lifter is None else lifter.to(self.device)
        self.backend = backend
        self.tri_variant = tri_variant
        self.decode_on_device = bool(decode_on_device)
        self.geo_rerank = float(geo_rerank)
        self.geo_scale = float(geo_scale)
        self.geo_rescue = float(geo_rescue)
        self.geo_rescue_dist = float(geo_rescue_dist)
        self.slot_buckets = slot_buckets
        self.person_buckets = person_buckets
        self.threshold = threshold
        self.decode_top_k = decode_top_k
        self.lifter_prior = lifter_prior
        self.prior_gate_px = prior_gate_px
        self.use_frame_kernel = use_frame_kernel
        self.use_layer_matcher = bool(use_layer_matcher)
        self.serve_dtype = (None if self.lifter is None
                            else self.lifter.serve_dtype)
        self.rig = rig              # the whole rig, as given (host arrays)
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
        # the batch path's union topologies and edge rows, by (slots, frames)
        self._unions: Dict[Tuple[int, int], Tuple[GatTopology,
                                                  torch.Tensor]] = {}
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

    def _geo_active(self) -> bool:
        return self.geo_rerank > 0.0 or self.geo_rescue > 0.0

    @property
    def _decode_top_k_eff(self) -> int:
        """The device decode's candidate cap: geo rescue can make nearly
        every ray-consistent pair eligible, so it decodes uncapped."""
        return 0 if self.geo_rescue > 0.0 else self.decode_top_k

    def topology(self, slots: int) -> PairTopology:
        return self._bucket_state(slots)[0]

    def _bucket_state(self, slots: int) -> _Bucket:
        """The device state of a bucket (``_Bucket``)."""
        if slots not in self._topos:
            rc = self.rig_config
            topo = build_topology(len(self.match_idx), slots)
            form = self._resolve(slots)[0]
            as_t = lambda a: torch.as_tensor(  # noqa: E731
                a, dtype=torch.int32, device=self.device)
            self._topos[slots] = _Bucket(
                topo, gat_topology(topo, self.device,
                                   "stack" if form == "alt1" else form),
                edge_node_features(
                    topo.n_pairs,
                    rc.matcher_feature_dim_alt(rc.graph_alternative),
                    device=self.device),
                as_t(decode_pairs(topo)), form,
                PairTopology(topo.n_cameras, slots, as_t(topo.e1),
                             as_t(topo.e2), as_t(topo.cam1),
                             as_t(topo.cam2)),
                None if form != "alt1" else alt1_graph(
                    build_alt1_topology(topo, rc.n_joints, rc.joint_format),
                    self.device))
        return self._topos[slots]

    def serving_path(self, slots: int) -> Tuple[str, bool]:
        """(matcher form, frame path on) for the slot bucket ``slots``: a
        pure function of the bucket's sizes and the configuration
        (``resolve_serving_path``).  Raises when ``use_frame_kernel=True``
        and the frame path does not serve the bucket."""
        form, frame = self._resolve(slots)
        if self.use_frame_kernel is True and not frame:
            raise ValueError(f"use_frame_kernel=True, but the frame path "
                             f"does not serve the S={slots} bucket (it "
                             f"exceeds the limits of frame_decode_pack)")
        return form, frame

    def _resolve(self, slots: int) -> Tuple[str, bool]:
        return resolve_serving_path(
            len(self.match_idx), slots, prune=self.pair_prune_dist > 0,
            cap=self.pair_prune_cap, frame_ok=self.frame_path_on(),
            layer=self.use_layer_matcher or self.matcher.cfg.residual,
            alt1=self.rig_config.graph_alternative == "1")

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

    def batch_plan(self, slots: int, n_frames: int) -> BatchPlan:
        """How ``submit_batch`` runs ``n_frames`` frames (pad frames
        included) of the slot bucket ``slots``: where the bucket's frame
        path serves all its pairs, in chunks of as many frames as the union
        GAT takes (n*H <= MAX_HEADS heads and n*E <= MAX_PAIRS pairs, the
        tiled form's incidence build; the stack form is held to the same),
        full chunks first; else the eager body, a frame a chunk.  A pure
        function of the sizes and the configuration, like
        ``serving_path``; raises where ``use_frame_kernel=True`` and the
        frame path does not serve the bucket's pairs."""
        if n_frames < 1:
            raise ValueError(f"batch_plan: n_frames must be >= 1, got "
                             f"{n_frames}")
        C = len(self.match_idx)
        H, E = C * slots, C * (C - 1) // 2 * slots * slots
        if not (self.frame_path_on() and frame_kernel_fits(E, C, slots)):
            if self.use_frame_kernel is True:
                raise ValueError(f"use_frame_kernel=True, but the frame "
                                 f"path does not serve the S={slots} "
                                 f"bucket's {E} pairs")
            return BatchPlan(False, (1,) * n_frames)
        per = max(1, min(MAX_HEADS // H, MAX_PAIRS // E))
        full, rest = divmod(n_frames, per)
        return BatchPlan(True, (per,) * full + ((rest,) if rest else ()))

    def _upload(self, host):
        """Move host buffers to the device in one copy: packed into one
        (pinned, on a CUDA device) host buffer, uploaded with
        ``non_blocking=True``, viewed back on the device."""
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
        return args

    def _frame_tensors(self, frame: FrameArrays, S: Optional[int] = None):
        """Bucket the frame (or take the bucket ``S``) and move its five
        buffers to the device in one copy (``_upload``)."""
        if S is None:
            S = self._bucket(max(1, int(frame.present.sum(axis=1).max())))
        return S, self._upload([np.ascontiguousarray(
            _slot_view(getattr(frame, name), S), dtype=dt)
            for name, dt in _BUFFERS])

    def _batch_tensors(self, frames, S: int, n: int):
        """The frames' five buffers stacked [n, ...] at S slots, padded
        with empty frames (nothing present) to ``n``, in one upload."""
        host = []
        for name, dt in _BUFFERS:
            a = np.stack([_slot_view(getattr(f, name), S) for f in frames])
            if n > len(frames):
                a = np.concatenate([a, np.zeros((n - len(frames),)
                                                + a.shape[1:], a.dtype)])
            host.append(np.ascontiguousarray(a, dtype=dt))
        return self._upload(host)

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
        the shared alt-2/3 edge one-hot, so the stack and tiled forms
        project it once."""
        return torch.sigmoid(self.matcher(x, pw, gtopo, b.form,
                                          edge_const=True)) * pw

    def _match_scores(self, S: int, kp, valid, prob, observed, present):
        """One frame's (full-rig buffers) matcher stage on its bucket, for
        the rig's graph alternative (``mpe3d_tpu/pipeline.py:585-645``):
        (scores [E], pair mask [E], node features, topology of the form:
        the GAT topology, or the alt-1 graph)."""
        b = self._bucket_state(S)
        if b.form != "alt1":
            x_all, pmask, gtopo, _, _ = self._gat_inputs(
                S, *(a[None] for a in (kp, valid, prob, observed, present)))
            return self._scores(b, x_all, pmask, gtopo), pmask, x_all, gtopo
        ms = self._match_sel
        feats, live = alt1_node_features(
            kp[ms], valid[ms], prob[ms], observed[ms], present[ms],
            self.image_size, self.rig_config.joint_format)
        pmask = pair_mask_from_present(present[ms], b.gtopo.e1, b.gtopo.e2)
        x_all = torch.cat([feats, b.efeats])
        scores = apply_matcher_alt1(self.matcher, x_all, live, pmask, b.alt1)
        return scores * pmask, pmask, x_all, b.alt1

    def _geo_decode_scores(self, scores, kp, valid, observed, topo):
        """(eligibility scores, order scores or None) of the decode under
        the geometric rescue and rerank (``mpe3d_tpu/pipeline.py:671-690``):
        the scores and None when both are off.  kp/valid/observed: the
        matching cameras' buffers [C, S, ...] on the scores' device."""
        if not self._geo_active():
            return scores, None
        d = pair_ray_distances(kp, valid * observed.to(kp.dtype),
                               self.match_rig, topo)
        eff = scores
        if self.geo_rescue > 0.0:
            rescued = (scores > self.geo_rescue) & (d < self.geo_rescue_dist)
            eff = torch.where(rescued,
                              torch.clamp(scores, min=self.threshold + 1e-3),
                              scores)
        order = None
        if self.geo_rerank > 0.0:
            order = eff - self.geo_rerank * torch.clamp(d / self.geo_scale,
                                                        0.0, 1.0)
        return eff, order

    def _decode(self, S: int, scores, pmask, kp, valid, observed):
        """The eager path's device decode of one frame (full-rig buffers):
        (persons [P, C] int64, person_mask [P])."""
        b = self._bucket_state(S)
        ms = self._match_sel
        eff, order = self._geo_decode_scores(scores, kp[ms], valid[ms],
                                             observed[ms], b.dtopo)
        return decode_person_proposals_device(
            eff, pmask, b.topo, self.rig_config.min_number_of_views,
            self.threshold, self._p_max(S), top_k=self._decode_top_k_eff,
            order_scores=order)

    def _lift_rows(self, pkp, pval, pprob, pobs):
        """The 3D backend on P person rows of gathered observations:
        (poses [P, J, 3] metres, joint ok [P, J] or None, quality [P],
        lifter input [P, F] or None).  The triangulation backend's quality
        leaves out the joints it could not reconstruct."""
        J = self.rig_config.n_joints
        if self.backend == "triangulation":
            tri = (triangulate_irls if self.tri_variant == "irls"
                   else triangulate_median_filtered)
            poses, ok = tri(pkp, pobs.to(pkp.dtype), self.used_rig)
            return poses, ok, pose_quality_px(poses, pkp, pval, pobs,
                                              self.used_rig, ok), None
        nets, _ = pack_lifter_input(pkp, pval, pprob, pobs, self.used_rig,
                                    self.image_size, prior=self.lifter_prior,
                                    prior_gate_px=self.prior_gate_px)
        poses = self.lifter(nets).reshape(pkp.shape[0], J, 3) * 10.0
        return poses, None, pose_quality_px(poses, pkp, pval, pobs,
                                            self.used_rig), nets

    @torch.inference_mode()
    def _run(self, S: int, kp, valid, prob, observed, present):
        b = self._bucket_state(S)
        scores, pmask, x_all, _ = self._match_scores(S, kp, valid, prob,
                                                     observed, present)
        persons, person_mask = self._decode(S, scores, pmask, kp, valid,
                                            observed)
        pkp, pval, pprob, pobs = self._person_obs(persons, kp, valid, prob,
                                                  observed)
        poses, _, quality, nets = self._lift_rows(pkp, pval, pprob, pobs)
        poses = poses * person_mask[:, None, None]
        return ((poses, persons.to(torch.int32), person_mask, scores,
                 quality), (x_all, pmask, b.gtopo, nets))

    def _frame_decode_args(self, S: int, scores, pmask, kp, valid, prob,
                           observed, pairs=None):
        """(positional, keyword) arguments of ``frame_decode_pack``; its
        pairs are the bucket's or, under pruning, the compacted ones.  With
        scores [n, E] and buffers [n, C, ...] the arguments of a batch of
        n frames."""
        b = self._bucket_state(S)
        pairs = b.pairs if pairs is None else pairs
        us = self._used_sel
        sel = ((lambda t: t[:, us]) if scores.dim() == 2  # noqa: E731
               else (lambda t: t[us]))
        args = (scores, pmask, pairs, self._used_pos32, sel(kp), sel(valid),
                sel(prob), sel(observed), self._cams, self._cam_world)
        E, top_k = b.topo.n_pairs, self.decode_top_k
        k_cap = min(top_k, E) if top_k else E
        kw = dict(n_cameras=b.topo.n_cameras, threshold=self.threshold,
                  min_views=self.rig_config.min_number_of_views,
                  k_cap=min(k_cap, scores.shape[-1]), P=self._p_max(S),
                  prior=self.lifter_prior, gate_px=self.prior_gate_px,
                  image_size=self.image_size)
        return args, kw

    def _union(self, S: int, n: int) -> Tuple[GatTopology, torch.Tensor]:
        """The disjoint union of n frames' graphs of the bucket S: its
        topology tensors (heads of frame b offset by b*H, edges by b*E, in
        the bucket's form) and its n*E edge rows; one frame's are the
        bucket's own."""
        b = self._bucket_state(S)
        if n == 1:
            return b.gtopo, b.efeats
        key = (S, n)
        if key not in self._unions:
            self._unions[key] = (
                union_topology(b.gtopo, n, b.topo.n_pairs),
                edge_node_features(n * b.topo.n_pairs, b.efeats.shape[1],
                                   device=self.device))
        return self._unions[key]

    def _gat_inputs(self, S: int, kp, valid, prob, observed, present,
                    prune: bool = False):
        """What n frames' buffers [n, C, S, ...] give the GAT: (node
        features, pair weights, topology tensors of the union of their
        graphs (``_union``), decode pairs, compaction indices or None); the
        rows are the n*H heads, frame by frame, then the edge rows.  With
        ``prune`` (one frame: the frame path under pair pruning) the gate
        and compaction (``frame_kernel.py:1003-1044``): the heads and the
        first ``cap`` edge rows (all edge rows are the same one-hot), the
        kept pairs' weights and endpoints."""
        b = self._bucket_state(S)
        n = kp.shape[0]
        gtopo, efeats = self._union(S, n)
        ms = self._match_sel
        hfeats, _ = head_features(kp[:, ms], valid[:, ms], prob[:, ms],
                                  observed[:, ms], present[:, ms],
                                  self.match_rig, self.image_size,
                                  self.rig_config.graph_alternative)
        pmask = pair_mask_from_present(present[:, ms], b.gtopo.e1,
                                       b.gtopo.e2).reshape(-1)
        x = torch.cat([hfeats.reshape(n * b.topo.n_heads, -1), efeats], 0)
        if not prune:
            return x, pmask, gtopo, b.pairs, None
        if n != 1:
            raise ValueError(f"pair pruning serves one frame, got {n}")
        cap = prune_cap(b.topo.n_pairs, self.pair_prune_cap)
        idx, w = prune_pair_candidates(
            kp[0, ms], valid[0, ms] * observed[0, ms].to(kp.dtype),
            self.match_rig, b.dtopo, pmask, self.pair_prune_dist, cap)
        H = b.topo.n_heads
        gtopo = GatTopology(b.gtopo.e1[idx], b.gtopo.e2[idx], H)
        return x[:H + cap], w, gtopo, b.pairs[idx], idx

    @torch.inference_mode()
    def _run_frames(self, S: int, kp, valid, prob, observed, present,
                    prune: bool = False):
        """The frame path on n frames [n, C, S, ...] (a served frame is
        n = 1, a batch chunk n >= 1): features, (with ``prune``: the gate
        and compaction,) ONE GAT call on the union of the frames' graphs,
        the decode + gather + pack kernel over the n frames (frame b's
        lifter rows from b*P; one frame in the kernel's one-frame form),
        the lifter kernel on the n*P rows and the epilogue, with no host
        synchronisation (``frame_kernel.py:883-1103``).  Pruned scores are
        scattered back to the bucket's pairs, pruned ones exactly 0
        (:1098-1102).  Returns (outputs with a leading frame axis, the
        decode kernel's (positional, keyword) arguments)."""
        b = self._bucket_state(S)
        n, E, P = kp.shape[0], b.topo.n_pairs, self._p_max(S)
        x, pw, gtopo, pairs, idx = self._gat_inputs(S, kp, valid, prob,
                                                    observed, present, prune)
        scores = self._scores(b, x, pw, gtopo)
        bufs = (kp, valid, prob, observed)
        if n == 1:
            bufs = tuple(a[0] for a in bufs)
        else:
            scores, pw = scores.view(n, E), pw.view(n, E)
        args, kw = self._frame_decode_args(S, scores, pw, *bufs, pairs)
        f = frame_decode_pack(*args, **kw)
        # the residual prior (fields 11-13 of camera block 0) is added in
        # Lifter.forward
        poses = self.lifter(f.net).reshape(n * P, -1, 3) * 10.0
        quality = pose_quality_px(poses, f.kp, f.valid, f.observed,
                                  self.used_rig)
        poses = poses * f.person_mask[:, None, None]
        if idx is not None:
            scores = torch.zeros(E, dtype=scores.dtype,
                                 device=scores.device).index_copy(0, idx,
                                                                  scores)
        return ((poses.view(n, P, -1, 3), f.persons.view(n, P, -1),
                 f.person_mask.view(n, P), scores.view(n, E),
                 quality.view(n, P)), (args, kw))

    def _run_each(self, S: int, *bufs):
        """The eager body on each of n frames [n, C, S, ...], outputs
        stacked on a leading frame axis."""
        outs = [self._run(S, *(a[i] for a in bufs))[0]
                for i in range(bufs[0].shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def stage_inputs(self, frame: FrameArrays):
        """The inputs the frame gives the kernels on the eager path: (GAT
        node features, pair weights, topology tensors, lifter input rows).
        For checks and measurements of the kernels alone."""
        S, args = self._frame_tensors(frame)
        return self._run(S, *args)[1]

    def _chunk(self, frames, slots: Optional[int] = None):
        """(slots, buffers [n, C, S, ...], prune) of frames as the frame
        path takes them in one body: one frame is compacted under pruning,
        as ``submit_fused`` serves it."""
        S = slots or self._batch_slots(frames)
        return (S, self._batch_tensors(frames, S, len(frames)),
                len(frames) == 1 and self.pair_prune_dist > 0)

    def frame_stage_inputs(self, frame: FrameArrays):
        """(positional arguments, keyword arguments) the frame path gives
        ``frame_decode_pack`` for this frame."""
        S, bufs, prune = self._chunk([frame])
        return self._run_frames(S, *bufs, prune)[1]

    @torch.inference_mode()
    def gat_stage_inputs(self, frame: FrameArrays):
        """(node features, pair weights, topology tensors, matcher form)
        the frame path gives the GAT for this frame (compacted under
        pruning).  For checks and measurements of the kernels alone."""
        S, bufs, prune = self._chunk([frame])
        return (self._gat_inputs(S, *bufs, prune)[:3]
                + (self._bucket_state(S).form,))

    def union_stage_inputs(self, frames, slots: Optional[int] = None):
        """What the batch path gives the GAT and the decode kernel for
        these frames as one chunk: ((node features, pair weights, union
        topology, matcher form), (positional, keyword) arguments of
        ``frame_decode_pack`` on the union's scores).  For checks and
        measurements of the kernels alone."""
        S, bufs, prune = self._chunk(frames, slots)
        with torch.inference_mode():
            gat = (self._gat_inputs(S, *bufs, prune)[:3]
                   + (self._bucket_state(S).form,))
        return gat, self._run_frames(S, *bufs, prune)[1]

    def _on_device(self):
        """This pipeline's device as the current CUDA device (the calling
        thread's own may be another); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _download(self, out):
        """Start the copy of a ticket's outputs to the host: on a CUDA
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
            if self.serving_path(S)[1]:
                out = [t[0] for t in self._run_frames(
                    S, *(a[None] for a in args),
                    prune=self.pair_prune_dist > 0)[0]]
            else:
                out = self._run(S, *args)[0]
            return (frame,) + self._download(out)

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

    # ---- the batch path ---------------------------------------------------

    def _batch_slots(self, frames) -> int:
        """The slot bucket of the fullest frame."""
        return self._bucket(max(1, max(int(f.present.sum(axis=1).max())
                                       for f in frames)))

    def submit_batch(self, frames, slots: Optional[int] = None,
                     pad_to: Optional[int] = None):
        """Start a batch of frames on the device and its download, without
        waiting; returns a ticket for :meth:`collect_batch`
        (``mpe3d_tpu/pipeline.py:958``).  The bucket is ``slots`` or the
        fullest frame's; ``pad_to`` pads the batch with empty frames, so a
        micro-batcher with a varying fill reuses one set of plans and
        tables.  The chunks of ``batch_plan`` run in order, each one body;
        one upload, one pinned download, no host synchronisation on the
        batch path (the eager body synchronises in its decode)."""
        if not frames:
            raise ValueError("submit_batch: no frames")
        S = slots or self._batch_slots(frames)
        n = max(len(frames), pad_to or 0)
        plan = self.batch_plan(S, n)
        with self._submit_lock, torch.inference_mode(), self._on_device():
            bufs = self._batch_tensors(frames, S, n)
            outs, i = [], 0
            for m in plan.chunks:
                chunk = [a[i:i + m] for a in bufs]
                outs.append(self._run_frames(S, *chunk)[0] if plan.union
                            else self._run_each(S, *chunk))
                i += m
            out = (outs[0] if len(outs) == 1
                   else tuple(torch.cat(parts) for parts in zip(*outs)))
            return (frames,) + self._download(out)

    def collect_batch(self, ticket):
        """Wait for a :meth:`submit_batch` ticket's download: a
        PipelineOutput a frame, pad frames cropped."""
        frames, host, done = ticket
        if done is not None:
            done.synchronize()
        poses, persons, person_mask, scores, quality = (t.numpy()
                                                        for t in host)
        res = []
        for i, f in enumerate(frames):
            n = int(person_mask[i].sum())
            res.append(PipelineOutput(poses[i][:n],
                                      persons[i][:n].astype(np.int32),
                                      scores[i], int(f.present.sum()),
                                      quality[i][:n]))
        return res

    def infer_batch(self, frames, slots: Optional[int] = None,
                    mesh=None) -> List[PipelineOutput]:
        """Batched inference over a list of frames: one ticket
        (``submit_batch``), a PipelineOutput a frame.  ``mesh`` (the
        reference's frame axis sharded over several devices) raises: the
        port serves one card."""
        if mesh is not None:
            raise NotImplementedError(
                "infer_batch(mesh=...): the frame axis sharded over several "
                "cards is multi-device serving, not in the port (ROADMAP.md "
                "section 1, item 6); the port serves one card")
        if not frames:
            return []
        return self.collect_batch(self.submit_batch(frames, slots))

    # ---- the staged path --------------------------------------------------

    def _match_slots(self, frame: FrameArrays) -> int:
        """The staged path's slot bucket: the matching cameras' skeletons."""
        mi = np.asarray(self.match_idx)
        return self._bucket(max(1, int(frame.present[mi].sum(axis=1).max())))

    def _match_device(self, frame: FrameArrays):
        """(slots, the frame's buffers on the device, scores [E], pair mask
        [E]) of the staged matcher stage, through the bucket's form."""
        S, args = self._frame_tensors(frame, self._match_slots(frame))
        return (S, args) + self._match_scores(S, *args)[:2]

    def match(self, frame: FrameArrays):
        """Matcher stage: (scores [E], pair mask [E], topology, slots) on
        the host."""
        with self._submit_lock, torch.inference_mode(), self._on_device():
            S, _, scores, pmask = self._match_device(frame)
            return (scores.cpu().numpy(), pmask.cpu().numpy(),
                    self.topology(S), S)

    def match_decode(self, frame: FrameArrays):
        """Matcher stage with the decode on the device (the eager path's
        decode, geometric rerank and rescue included): (scores, pair mask,
        topology, slots, persons [n, C] int32)."""
        with self._submit_lock, torch.inference_mode(), self._on_device():
            S, args, scores, pmask = self._match_device(frame)
            persons, mask = self._decode(S, scores, pmask, args[0], args[1],
                                         args[3])
            n = int(mask.sum())
            return (scores.cpu().numpy(), pmask.cpu().numpy(),
                    self.topology(S), S,
                    persons[:n].cpu().numpy().astype(np.int32))

    def host_decode_scores(self, frame: FrameArrays, scores: np.ndarray,
                           topo: PairTopology, slots: int):
        """(eligibility scores, order scores) for a host decode under the
        geometric rerank and rescue ((scores, None) when both are off).  A
        frame parsed with fewer slots than the bucket is zero-padded up to
        ``slots`` (``_slot_view``): a short buffer would make the ray
        distances index past its rows and diverge from the other paths."""
        if not self._geo_active():
            return scores, None
        mi = np.asarray(self.match_idx)

        def dev(a, dt):
            return torch.as_tensor(np.ascontiguousarray(
                _slot_view(np.asarray(a)[mi], slots), dtype=dt),
                device=self.device)

        with torch.inference_mode(), self._on_device():
            eff, order = self._geo_decode_scores(
                torch.as_tensor(np.array(scores, np.float32),
                                device=self.device),
                dev(frame.kp, np.float32), dev(frame.valid, np.float32),
                dev(frame.in_view, np.bool_), topo)
            return (eff.cpu().numpy(),
                    None if order is None else order.cpu().numpy())

    def gather_person_obs(self, frame: FrameArrays, persons: np.ndarray):
        """Each person's observations in the used cameras, on the host:
        kp [P, Cu, J, 2], valid/prob [P, Cu, J] fp32, observed [P, Cu, J]
        bool.  persons [P, C_match]; a used camera that is not a matching
        one contributes nothing."""
        P = len(persons)
        Cu, J = len(self.used_idx), self.rig_config.n_joints
        kp = np.zeros((P, Cu, J, 2), np.float32)
        valid = np.zeros((P, Cu, J), np.float32)
        prob = np.zeros((P, Cu, J), np.float32)
        observed = np.zeros((P, Cu, J), bool)
        names = self.rig_config.camera_names
        match_names = [names[i] for i in self.match_idx]
        for ui, cam in enumerate(self.used_idx):
            if names[cam] not in match_names:
                continue
            mi = match_names.index(names[cam])
            for p in range(P):
                s = persons[p, mi]
                if s < 0:
                    continue
                kp[p, ui] = frame.kp[cam, s]
                valid[p, ui] = frame.valid[cam, s]
                prob[p, ui] = frame.prob[cam, s]
                observed[p, ui] = frame.in_view[cam, s]
        return kp, valid, prob, observed

    def _lift_host(self, obs):
        """The 3D backend on host person rows: (poses, quality) numpy."""
        with self._submit_lock, torch.inference_mode(), self._on_device():
            rows = [torch.as_tensor(a, device=self.device) for a in obs]
            poses, _, quality, _ = self._lift_rows(*rows)
            return poses.cpu().numpy(), quality.cpu().numpy()

    def lift(self, frame: FrameArrays, persons: np.ndarray,
             with_quality: bool = False):
        """The 3D stage on decoded persons [P, C_match]: poses [P, J, 3]
        metres (and the quality column with ``with_quality``), computed on
        the person bucket's rows.  The host decode has no person cap, so
        past the largest person bucket the first ones are lifted (the
        greedy decode emits the most confident first) and the rest dropped,
        with a note on stderr."""
        P = len(persons)
        J = self.rig_config.n_joints
        if P == 0:
            empty = np.zeros((0, J, 3), np.float32)
            return (empty, np.zeros(0, np.float32)) if with_quality else empty
        PB = self._person_bucket(P)
        if P > PB:
            print(f"[mpe3d_torch] {P} person proposals exceed the largest "
                  f"person bucket ({PB}); lifting the first {PB}",
                  file=sys.stderr)
            persons, P = persons[:PB], PB
        obs = [np.concatenate([a, np.zeros((PB - P,) + a.shape[1:], a.dtype)])
               for a in self.gather_person_obs(frame, persons)]
        poses, quality = self._lift_host(obs)
        return (poses[:P], quality[:P]) if with_quality else poses[:P]

    def __call__(self, frame: FrameArrays) -> PipelineOutput:
        """The staged path: match, decode (host, or device with
        ``decode_on_device``; every present skeleton with one matching
        camera), lift."""
        if len(self.match_idx) == 1:
            persons = single_camera_bypass(
                frame.present[np.asarray(self.match_idx)])
            scores = np.zeros(0, np.float32)
        elif self.decode_on_device:
            scores, _, _, _, persons = self.match_decode(frame)
        else:
            scores, pm, topo, S = self.match(frame)
            eff, order = self.host_decode_scores(frame, scores, topo, S)
            persons = decode_person_proposals(
                eff, pm, topo, self.rig_config.min_number_of_views,
                self.threshold, order_scores=order)
        poses, quality = self.lift(frame, persons, with_quality=True)
        # lift truncates past the largest person bucket: keep rows aligned
        persons = persons[:len(poses)]
        return PipelineOutput(poses, persons, scores,
                              int(frame.present.sum()), quality)

    def warmup(self, slots: Optional[int] = None,
               persons: Optional[int] = None, fused: bool = True) -> None:
        """Run every slot bucket (or ``slots`` alone) once: the first call
        of a bucket builds its device state, the kernels' plans and tables
        and, on the card, the kernel library.  ``fused``: an all-present
        frame of zeros through ``submit_fused``; with ``persons`` given or
        ``fused=False`` also the staged path (the match of each slot
        bucket, the 3D stage on each person bucket's rows, or ``persons``
        rows), as the reference's ``warmup`` compiles it."""
        C, J = self.rig_config.n_cameras, self.rig_config.n_joints
        buckets = [slots] if slots else list(self.slot_buckets)

        def zeros(S, present):
            return FrameArrays(
                np.zeros((C, S, J, 2), np.float32),
                np.zeros((C, S, J), np.float32),
                np.zeros((C, S, J), np.float32), np.zeros((C, S, J), bool),
                np.full((C, S), present), np.zeros(C))

        if persons is not None or not fused:
            for S in buckets:
                if len(self.match_idx) > 1:
                    self.match(zeros(S, True))
            Cu = len(self.used_idx)
            for PB in ([persons] if persons else self.person_buckets):
                self._lift_host([np.zeros((PB, Cu, J, 2), np.float32),
                                 np.zeros((PB, Cu, J), np.float32),
                                 np.zeros((PB, Cu, J), np.float32),
                                 np.zeros((PB, Cu, J), bool)])
        if fused:
            for S in buckets:
                self.infer_fused(zeros(S, True))

    def reload_weights(self, matcher_tree=None, lifter_tree=None) -> None:
        """Swap the serving weights for trees in the JAX package's layout
        (``weights.py``; ``checkpoint.py`` reads them from npz files)
        without rebuilding the pipeline (``mpe3d_tpu/pipeline.py:1063-
        1160``, without its multi-device part).

        The new weights get the construction's serving transform (the
        lifter in this pipeline's ``serve_dtype``: int8 quantised, bf16
        cast or fp32) and must have the current architecture: a shape
        mismatch, an int8 tree for a pipeline that does not serve int8, or
        a lifter for a pipeline built without one raises ValueError with
        the serving weights untouched.  Everything is built and checked
        first; then the matcher and lifter are swapped together under the
        submit lock, so each frame sees old or new weights, never a mix.
        Frames submitted earlier keep reading the old tensors: every
        launch is on one stream, so the caching allocator hands their
        memory to a later allocation only in stream order, after those
        launches.  The lifter's run tables are keyed by weight addresses
        (``ops/fused_mlp.py::mlp_run``) and hold only addresses and
        shapes, and the tiled GAT's cached plans
        (``ops/gat_tiled.py::_stack_plan``) no weight address, so neither
        serves stale weights."""
        matcher, lifter = self.matcher, self.lifter
        if matcher_tree is not None:
            matcher = matcher_from_tree(matcher_tree, self.matcher.cfg,
                                        self.device)
        if lifter_tree is not None:
            if self.lifter is None:
                raise ValueError("reload_weights: this pipeline was built "
                                 "without a lifter")
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
