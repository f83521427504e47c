"""End-to-end multi-person 3D pose estimation, one frame at a time.

Port of the fused serving path of ``mpe3d_tpu/pipeline.py``
(``PoseEstimationPipeline.infer_fused`` :1215, program body ``_fused_impl``
:804-892, the branch without the whole-frame kernel): alt-3 features -> GAT
pair scores -> greedy decode on the device -> per-person gather -> lifter
input with its triangulated prior -> MLP lifter -> poses in metres plus the
reprojection quality column.  The GAT stack and the MLP run through the
port's hand-written CUDA kernels on a CUDA device, through their plain
versions on the CPU.

The GAT is true fp32: TF32 is switched off for matmuls and convolutions at
import, because rounded operands change decodes (RESULTS.md:1265-1271,
1369-1377).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                        load_matcher_checkpoint)
from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig, MatcherConfig,
                                    RigConfig)
from mpe3d_tpu_torch.data.frames import FrameArrays
from mpe3d_tpu_torch.geometry.camera import CameraRig, project_points
from mpe3d_tpu_torch.lifting.pack import pack_lifter_input
from mpe3d_tpu_torch.matching.decode_device import \
    decode_person_proposals_device
from mpe3d_tpu_torch.matching.features import (PairTopology, build_topology,
                                               edge_node_features,
                                               head_features,
                                               pair_mask_from_present)
from mpe3d_tpu_torch.models.gat import Matcher, gat_topology
from mpe3d_tpu_torch.models.mlp import Lifter
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


def _slot_view(a: np.ndarray, S: int) -> np.ndarray:
    """Restrict a per-frame buffer [C, slots, ...] to S slots: slice, or
    zero-pad (absent slots) when the frame has fewer."""
    a = np.asarray(a)
    if a.shape[1] >= S:
        return a[:, :S]
    pad = np.zeros((a.shape[0], S - a.shape[1]) + a.shape[2:], a.dtype)
    return np.concatenate([a, pad], axis=1)


class PoseEstimationPipeline:
    """Frame -> poses with the learned lifter, on ``device``."""

    def __init__(self, rig_config: RigConfig, rig: CameraRig,
                 matcher: Matcher, lifter: Lifter,
                 slot_buckets: Tuple[int, ...] = (2, 4, 10),
                 person_buckets: Tuple[int, ...] = (4, 8, 16),
                 threshold: float = 0.5, decode_top_k: int = 64,
                 lifter_prior: str = "mean",
                 prior_gate_px: Optional[float] = None,
                 device="cuda"):
        if rig_config.graph_alternative != "3":
            raise NotImplementedError("only the alt-3 matcher graph is ported")
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
        self._match_sel = torch.tensor(self.match_idx, device=self.device)
        self._used_sel = torch.tensor(self.used_idx, device=self.device)
        self._topos: Dict[int, tuple] = {}

    @classmethod
    def from_checkpoint(cls, models_dir: str, rig: CameraRig,
                        rig_config: RigConfig = PANOPTIC, device="cuda",
                        **kwargs) -> "PoseEstimationPipeline":
        """Matcher ``skeleton_matching`` and lifter ``pose_estimator`` from
        a models directory; architecture, ``residual_prior`` and the packing
        ``prior`` come from the checkpoint meta."""
        mtree, mcfg = load_matcher_checkpoint(
            os.path.join(models_dir, "skeleton_matching"),
            MatcherConfig(in_dim=rig_config.matcher_feature_dim))
        ltree, lcfg, prior = load_lifter_checkpoint(
            os.path.join(models_dir, "pose_estimator"),
            LifterConfig(in_dim=rig_config.lifter_input_dim,
                         out_dim=rig_config.n_joints * 3))
        return cls(rig_config, rig, matcher_from_tree(mtree, mcfg, device),
                   lifter_from_tree(ltree, lcfg, device), lifter_prior=prior,
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

    def _bucket_state(self, slots: int):
        """(topology, its index tensors, edge-node features) of a bucket."""
        if slots not in self._topos:
            topo = build_topology(len(self.match_idx), slots)
            self._topos[slots] = (
                topo, gat_topology(topo, self.device),
                edge_node_features(topo.n_pairs,
                                   self.rig_config.matcher_feature_dim,
                                   device=self.device))
        return self._topos[slots]

    def _frame_tensors(self, frame: FrameArrays):
        """Bucket the frame and move its buffers to the device."""
        S = self._bucket(max(1, int(frame.present.sum(axis=1).max())))
        args = [torch.from_numpy(np.ascontiguousarray(_slot_view(a, S)))
                .to(self.device)
                for a in (frame.kp, frame.valid, frame.prob, frame.in_view,
                          frame.present)]
        return S, args

    def _match_inputs(self, S: int, kp, valid, prob, observed, present):
        """GAT node features [H+E, in_dim] and pair mask [E]."""
        _, gtopo, efeats = self._bucket_state(S)
        ms = self._match_sel
        hfeats, _ = head_features(kp[ms], valid[ms], prob[ms], observed[ms],
                                  present[ms], self.match_rig,
                                  self.image_size)
        pmask = pair_mask_from_present(present[ms], gtopo.e1, gtopo.e2)
        return torch.cat([hfeats, efeats], 0), pmask

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

    @torch.inference_mode()
    def _run(self, S: int, kp, valid, prob, observed, present):
        topo, gtopo, _ = self._bucket_state(S)
        p_max = self._p_max(S)
        x_all, pmask = self._match_inputs(S, kp, valid, prob, observed,
                                          present)
        scores = torch.sigmoid(self.matcher(x_all, pmask, gtopo)) * pmask
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
        return ((poses, persons, person_mask, scores, quality),
                (x_all, pmask, gtopo, nets))

    def stage_inputs(self, frame: FrameArrays):
        """The inputs the frame gives the two kernels on the serving path:
        (GAT node features, pair weights, topology tensors, lifter input
        rows).  For checks and measurements of the kernels alone."""
        S, args = self._frame_tensors(frame)
        return self._run(S, *args)[1]

    def submit_fused(self, frame: FrameArrays):
        """Start one frame on the device; returns a ticket for
        :meth:`collect_fused`."""
        S, args = self._frame_tensors(frame)
        return frame, self._run(S, *args)[0]

    def collect_fused(self, ticket) -> PipelineOutput:
        """Wait for a ticket's results and crop to the real persons."""
        frame, out = ticket
        poses, persons, person_mask, scores, quality = (
            t.cpu().numpy() for t in out)
        n = int(person_mask.sum())
        return PipelineOutput(poses[:n], persons[:n], scores,
                              int(frame.present.sum()), quality[:n])

    def infer_fused(self, frame: FrameArrays) -> PipelineOutput:
        """Full-frame inference."""
        return self.collect_fused(self.submit_fused(frame))
