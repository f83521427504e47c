"""Matcher composite scenes synthesised on the device (``--device-synth``).

Port of ``mpe3d_tpu/train/matcher_synth.py``: the reference's training-set
synthesis (skeleton_matching/graph_generator.py:672-810: sample 1..N
single-person frames from the highest-probability files, mark the biggest
skeleton a camera holds as that person's real head, label real-real
same-person pairs) over a bank of parsed recordings that stays on the
device, so an epoch synthesises its scenes with no host work.

* ``build_scene_bank`` (host, once; :88-193): every single-person frame
  parsed into fixed [F, C, K, J, ...] arrays, and the camera-subset
  augmentation pool (utils/data_augmentation.py:50-85) as an index list,
  one (frame, camera mask) entry per subset.  Its arrays equal the JAX
  package's; ``SceneBank.tensors`` uploads them.
* ``synth_scenes`` (device; :196-312): per scene a number of people, that
  count's highest-probability file set (the map is computed on the host
  with the reference's ``np.argpartition``, byte-identical), one augmented
  entry per file drawn uniformly with replacement, skeletons packed into
  the (C, S) slots by running offset, real heads marked, labels and pair
  multiplicities on the static topology.  The bank, the file-set map and
  the topology are uploaded once (``SceneBank.tensors``), so a batch
  copies nothing to the device.  The draws come from a
  ``torch.Generator``, so they are not ``jax.random``'s numbers; a scene
  the reference skips (slot overflow, no live pair) is a null scene with
  weight 0, as in the JAX package.  Where the reference gathers each
  slot's fields by a one-hot contraction over (person, skeleton) for its
  TPU lanes, this gathers the owning row by index: the same values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.matching.features import PairTopology
from mpe3d_tpu_torch.train.matcher_data import _parse_skeletons


@dataclass
class SceneBank:
    """Parsed recordings and the augmentation pool, host numpy.

    kp/valid/prob/obs: [F, C, K, ...] per-skeleton slabs (K = most
    skeletons of a (frame, camera) in the bank); nsk [F, C] skeleton
    counts; real_k [F, C] index of the biggest skeleton (-1 if none);
    aug_frame [A] / aug_mask [A, C]: the augmentation pool; file_segments:
    per input file its [start, end) range of the pool; top_sets[n-1]: the n
    highest-probability file indices (the reference's argpartition
    order)."""

    kp: np.ndarray
    valid: np.ndarray
    prob: np.ndarray
    obs: np.ndarray
    nsk: np.ndarray
    real_k: np.ndarray
    aug_frame: np.ndarray
    aug_mask: np.ndarray
    file_segments: Tuple[Tuple[int, int], ...]
    top_sets: Tuple[Tuple[int, ...], ...]

    @property
    def n_files(self) -> int:
        return len(self.file_segments)

    def tensors(self, device, topo: PairTopology) -> "DeviceBank":
        """The bank on ``device``, with the file-set map and the segment
        bounds as index tables and the endpoints of ``topo``: everything
        ``synth_scenes`` reads, uploaded once."""
        P = self.n_files
        files = np.full((P, P), -1, np.int64)
        for k, top in enumerate(self.top_sets):
            files[k, :len(top)] = top
        as_t = lambda a, dt=None: torch.as_tensor(  # noqa: E731
            a, dtype=dt, device=device)
        return DeviceBank(
            *(as_t(a) for a in (self.kp, self.valid, self.prob, self.obs,
                                self.nsk, self.real_k, self.aug_frame,
                                self.aug_mask)),
            files=as_t(files),
            seg=as_t(np.asarray(self.file_segments, np.int64).reshape(P, 2)),
            e1=as_t(topo.e1, torch.long), e2=as_t(topo.e2, torch.long),
            n_slots=topo.n_slots)


class DeviceBank(NamedTuple):
    """``SceneBank.tensors``: the bank's arrays on the device; files
    [P, P] (row n-1: the n files of an n-person scene, -1 past n) and seg
    [P, 2] (each file's [start, end) of the pool); the topology's
    endpoints e1/e2 [E] and its slots."""

    kp: torch.Tensor
    valid: torch.Tensor
    prob: torch.Tensor
    obs: torch.Tensor
    nsk: torch.Tensor
    real_k: torch.Tensor
    aug_frame: torch.Tensor
    aug_mask: torch.Tensor
    files: torch.Tensor
    seg: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n_slots: int


def build_scene_bank(inputs: List[List[dict]], rig_config: RigConfig,
                     probabilities: Optional[Sequence[float]] = None,
                     min_views: int = 2) -> SceneBank:
    """Parse single-person recordings into a fixed-shape bank.  ``inputs``:
    one list of wire frames per source file (as ``build_matcher_scenes``
    takes them); the default ``probabilities`` are the reference's
    (train_skeleton_matching.py:122-132)."""
    if probabilities is None:
        first = max(len(inputs[0]), 1)
        probabilities = [0.8 * len(frames) / first for frames in inputs]
        probabilities[0] = 0.8
    probs = np.asarray(probabilities, np.float64)
    n_files = len(inputs)
    top_sets = tuple(
        tuple(int(i) for i in np.argpartition(probs, -n)[-n:])
        for n in range(1, n_files + 1))

    match_cams = rig_config.used_cameras_skeleton_matching
    cam_pos = {c: i for i, c in enumerate(match_cams)}
    C, J = len(match_cams), rig_config.n_joints

    # pass 1: parse the frames, find K
    parsed = []          # (file index, {matching camera: skeletons}, avail)
    for fi, frames in enumerate(inputs):
        for frame in frames:
            byc, avail = {}, []
            for c in rig_config.used_cameras:
                entry = frame.get(c)
                if entry is None:
                    continue
                sks = _parse_skeletons(entry, J)
                if not sks:
                    continue
                avail.append(c)
                if c in cam_pos:
                    byc[cam_pos[c]] = sks
            if avail:
                parsed.append((fi, byc, avail))
    K = max((len(s) for _, byc, _ in parsed for s in byc.values()),
            default=1)
    F = len(parsed)

    kp = np.zeros((F, C, K, J, 2), np.float32)
    valid = np.zeros((F, C, K, J), np.float32)
    prob = np.zeros((F, C, K, J), np.float32)
    obs = np.zeros((F, C, K, J), np.float32)
    nsk = np.zeros((F, C), np.int32)
    real_k = np.full((F, C), -1, np.int32)
    for f, (_, byc, _) in enumerate(parsed):
        for ci, sks in byc.items():
            nsk[f, ci] = len(sks)
            real_k[f, ci] = int(np.argmax([s[4] for s in sks]))
            for k, (skp, sv, sp, so, _) in enumerate(sks):
                kp[f, ci, k] = skp
                valid[f, ci, k] = sv
                prob[f, ci, k] = sp
                obs[f, ci, k] = so.astype(np.float32)

    def mask(cams):
        m = np.zeros(C, np.float32)
        for c in cams:
            if c in cam_pos:
                m[cam_pos[c]] = 1.0
        return m

    # the augmentation pool: the full camera set first, then every proper
    # subset of the available used cameras with >= min_views
    aug_frame, aug_mask, segs = [], [], []
    file_of = np.array([fi for fi, _, _ in parsed])
    for fi in range(n_files):
        start = len(aug_frame)
        for f in np.nonzero(file_of == fi)[0]:
            avail = parsed[f][2]
            n = len(avail)
            aug_frame.append(f)
            aug_mask.append(mask(avail))
            for bits in range(1, 2 ** n):
                subset = [avail[i] for i in range(n) if bits >> i & 1]
                if len(subset) < min_views or len(subset) == n:
                    continue
                aug_frame.append(f)
                aug_mask.append(mask(subset))
        if len(aug_frame) == start:
            # an empty segment would give a file's draws nothing to draw
            # from: the same 2D evidence would end up under two person ids
            raise ValueError(
                f"input file {fi} contributed no parseable single-person "
                f"frames: every file in the bank must have at least one")
        segs.append((start, len(aug_frame)))

    return SceneBank(
        kp=kp, valid=valid, prob=prob, obs=obs, nsk=nsk, real_k=real_k,
        aug_frame=np.asarray(aug_frame, np.int32),
        aug_mask=(np.stack(aug_mask) if aug_mask
                  else np.zeros((0, C), np.float32)),
        file_segments=tuple(segs), top_sets=top_sets)


def synth_scenes(bank: DeviceBank, generator: torch.Generator,
                 n_scenes: int):
    """``n_scenes`` composite scenes on the bank's device (module header),
    with no host work and no copy to the device.  Returns the 7-tuple (kp
    [N, C, S, J, 2], valid, prob, obs (bool), present (bool) [N, C, S],
    labels [N, E], pair_weight [N, E]) that ``train_matcher`` steps on."""
    (b_kp, b_valid, b_prob, b_obs, b_nsk, b_realk, aug_frame, aug_mask,
     files, seg, e1, e2, S) = bank
    dev = b_kp.device
    P = files.shape[0]
    n = n_scenes

    # person p of a scene of n_people people comes from file
    # files[n_people - 1, p]; the segment bounds of that file
    n_people = torch.randint(1, P + 1, (n,), generator=generator,
                             device=dev)
    alive = (torch.arange(P, device=dev)[None] < n_people[:, None])  # [n, P]
    fsel = files[n_people - 1].clamp(min=0)                         # [n, P]
    a0, a1 = seg[fsel, 0], seg[fsel, 1]
    u = torch.rand((n, P), generator=generator, device=dev,
                   dtype=torch.float64)
    idx = torch.minimum(a0 + (u * (a1 - a0)).long(), a1 - 1)
    frames = torch.where(alive, aug_frame[idx].long(), 0)           # [n, P]
    aliv = alive.to(torch.float32)
    masks = aug_mask[idx] * aliv[..., None]                         # [n,P,C]

    # per person and camera the skeletons it brings, packed by offset
    cnt = b_nsk[frames].to(torch.float32) * masks                   # [n,P,C]
    off = torch.cumsum(cnt, 1) - cnt
    overflow = (cnt.sum(1) > S).any(-1)                             # [n]
    s_iota = torch.arange(S, dtype=torch.float32, device=dev)
    owns = ((s_iota >= off[..., None])
            & (s_iota < (off + cnt)[..., None]))                    # [n,P,C,S]
    ownf = owns.to(torch.float32)
    present = owns.any(1)                                           # [n,C,S]
    kidx = (ownf * (s_iota - off[..., None])).sum(1)                # [n,C,S]
    p_iota = torch.arange(P, dtype=torch.float32, device=dev)
    pidx = (ownf * p_iota[:, None, None]).sum(1)

    # a slot holds the real head iff its skeleton is the frame's biggest
    realk = b_realk[frames].to(torch.float32)                       # [n,P,C]
    realk_cs = (ownf * realk[..., None]).sum(1)
    is_real = present & (kidx == realk_cs)
    person_id = torch.where(is_real, pidx, -1.0)

    # each slot's fields: the owning person's frame, this camera, skeleton k
    f_cs = torch.gather(frames, 1, pidx.long().view(n, -1)).view(pidx.shape)
    c_cs = torch.arange(pidx.shape[1], device=dev)[None, :, None].expand_as(
        f_cs)
    k_cs = kidx.long()
    keep = present.to(torch.float32)

    def gather(field):
        v = field[f_cs, c_cs, k_cs]                                 # [n,C,S,...]
        return v * keep.view(*keep.shape, *([1] * (v.dim() - 3)))

    kp = gather(b_kp)
    valid = gather(b_valid)
    prob = gather(b_prob)
    obs = gather(b_obs) > 0.5

    pid = person_id.view(n, -1)
    pres = present.view(n, -1)
    p1, p2 = pid[:, e1], pid[:, e2]
    m = (pres[:, e1] & pres[:, e2]).to(torch.float32)
    labels = ((p1 >= 0) & (p1 == p2)).to(torch.float32) * m
    one_spur = ((p1 >= 0) & (p2 < 0)) | ((p1 < 0) & (p2 >= 0))
    weight = torch.where(one_spur, 1.0, 2.0) * m
    # scenes the reference skips (overflow, nothing live) are null; an
    # overflowed layout is garbage, so no label survives outside a weight
    live = (~(overflow | (weight.sum(1) == 0))).to(torch.float32)[:, None]
    return kp, valid, prob, obs, present, labels * live, weight * live
