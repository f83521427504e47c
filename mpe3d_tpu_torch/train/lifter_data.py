"""The lifter's training set: wire frames -> packed network inputs and loss
inputs.

Port of ``mpe3d_tpu/train/lifter_data.py`` (:34-241), the reference's
``PoseEstimatorDataset`` list path (utils/pose_estimator_dataset_from_json
.py:146-236): per frame, the biggest skeleton of each camera (one person a
frame, :49-61), packed into the 1260-float network input (the used
cameras) and the 360-float loss input (every camera), then expanded with
camera-dropout augmentation (:219-229): up to ``max_combinations`` camera
subsets a sample, the full set first, drawn with numpy from ``seed`` so
the subsets are the JAX package's.  Packing runs in batches on ``device``
(``lifting/pack.py``); the masks are applied to the packed rows.  The
cache mirrors the reference's ``<lastfile>.pytorch`` tensor cache
(:300-304) as an npz keyed on every packing option and on the input paths.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.config import RigConfig
from mpe3d_tpu_torch.data.frames import (FrameArrays, parse_frame,
                                         parse_frames_file)
from mpe3d_tpu_torch.geometry.camera import CameraRig
from mpe3d_tpu_torch.lifting.pack import (apply_camera_dropout,
                                          apply_prior_dropout,
                                          pack_error_input,
                                          pack_lifter_input)


def biggest_skeleton_obs(frame: FrameArrays, cam_indices: Sequence[int]
                         ) -> Tuple[np.ndarray, ...]:
    """The skeleton with most listed joints in each camera (reference
    get_skeleton_indices :49-61): (kp, valid, prob, observed), each
    [C_sel, J, ...]."""
    best = frame.in_view.sum(axis=2).argmax(axis=1)       # [C]
    ci = np.asarray(cam_indices)
    sel = best[ci]
    return (frame.kp[ci, sel], frame.valid[ci, sel], frame.prob[ci, sel],
            frame.in_view[ci, sel])


def random_camera_subsets(flags: np.ndarray, max_count: int,
                          rng: np.random.Generator,
                          low_view_bias: float = 0.0) -> List[np.ndarray]:
    """The reference's ``permutations_generator_random``
    (utils/data_augmentation.py:29-47): the full set first, then up to
    ``max_count - 1`` distinct random strict non-empty subsets of the
    available cameras, uniform.  ``low_view_bias`` (no reference
    counterpart): with this probability an augmented copy is instead a
    uniform 2- or 3-camera subset.  The draws are the JAX package's, so
    the same ``rng`` state gives the same subsets."""
    out = [flags.astype(np.float32)]
    avail = np.nonzero(flags)[0]
    n = len(avail)
    if n <= 1:
        return out
    if low_view_bias > 0.0:
        for _ in range(max_count - 1):
            if n > 2 and rng.random() < low_view_bias:
                s = int(rng.integers(2, min(3, n - 1) + 1))
                pick = rng.choice(n, size=s, replace=False)
            else:
                bits = int(rng.integers(1, 2 ** n - 1))
                pick = np.nonzero((bits >> np.arange(n)) & 1)[0]
            m = np.zeros(len(flags), np.float32)
            m[avail[pick]] = 1.0
            out.append(m)
        return out
    total = 2 ** n - 2
    k = min(max_count - 1, total)
    if total <= 4096:
        bit_sel = rng.choice(total, size=k, replace=False) + 1
    else:
        chosen = set()
        while len(chosen) < k:
            chosen.add(int(rng.integers(1, total + 1)))
        bit_sel = np.fromiter(chosen, dtype=np.int64)
    for bits in bit_sel:
        m = np.zeros(len(flags), np.float32)
        m[avail[(int(bits) >> np.arange(n)) & 1 == 1]] = 1.0
        out.append(m)
    return out


def build_lifter_dataset(frames: List, rig_config: RigConfig,
                         rig: CameraRig, augment: bool = True,
                         max_combinations: int = 5, seed: int = 0,
                         cache_path: Optional[str] = None,
                         batch: int = 2048, prior: str = "mean",
                         prior_dropout: float = 0.0,
                         low_view_bias: float = 0.0, device="cuda"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(network inputs [N, Cu*J*14], loss inputs [N, C*J*4]) float32 of
    wire frames (dicts or FrameArrays).

    ``prior``: the triangulated prior of fields 10-13 (``pack_lifter_
    input``); a caller with ``cache_path`` must key the path on it.
    ``prior_dropout`` > 0 zeroes each joint's prior fields with that
    probability on the augmented copies (the first copy of each sample
    stays whole)."""
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as data:
            return data["net"], data["err"]
    used_idx = rig_config.used_camera_indices()
    used_rig = rig.select(used_idx).to(device)
    all_idx = tuple(range(rig_config.n_cameras))
    J = rig_config.n_joints
    Cu, C = len(used_idx), rig_config.n_cameras
    img = (float(rig_config.image_width), float(rig_config.image_height))

    obs, eobs = [], []
    for fr in frames:
        fa = fr if isinstance(fr, FrameArrays) else parse_frame(fr,
                                                                rig_config)
        obs.append(biggest_skeleton_obs(fa, used_idx))
        eobs.append(biggest_skeleton_obs(fa, all_idx))
    if not obs:
        return (np.zeros((0, Cu * J * 14), np.float32),
                np.zeros((0, C * J * 4), np.float32))

    def stacked(rows, sl):
        return [torch.as_tensor(np.stack([r[k] for r in rows[sl]]),
                                device=device) for k in range(4)]

    nets, includes, errs = [], [], []
    with torch.no_grad():
        for i in range(0, len(obs), batch):
            sl = slice(i, i + batch)
            net, inc = pack_lifter_input(*stacked(obs, sl), used_rig, img,
                                         require_valid=True, prior=prior)
            nets.append(net.cpu().numpy())
            includes.append(inc.cpu().numpy())
            errs.append(pack_error_input(*stacked(eobs, sl)).cpu().numpy())
    net_all = np.concatenate(nets)
    inc_all = np.concatenate(includes)             # [F, Cu, J]
    err_all = np.concatenate(errs)

    # per-frame camera flags (reference :196) and the validity gate (:211)
    flags = inc_all.any(axis=2)
    keep = flags.any(axis=1)
    net_all, err_all, flags = net_all[keep], err_all[keep], flags[keep]

    rng = np.random.default_rng(seed)
    sample_idx, masks, first_copy = [], [], []
    for i in range(len(net_all)):
        subsets = (random_camera_subsets(flags[i], max_combinations, rng,
                                         low_view_bias=low_view_bias)
                   if augment else [flags[i].astype(np.float32)])
        for k, m in enumerate(subsets):
            sample_idx.append(i)
            masks.append(m)
            first_copy.append(k == 0)
    sample_idx = np.asarray(sample_idx)
    masks = np.stack(masks)
    jkeep = np.ones((len(sample_idx), J), np.float32)
    if prior_dropout > 0.0 and augment:
        aug = ~np.asarray(first_copy)
        jkeep[aug] = (rng.random((int(aug.sum()), J))
                      >= prior_dropout).astype(np.float32)

    outs = []
    with torch.no_grad():
        for i in range(0, len(sample_idx), 4096):
            sl = slice(i, i + 4096)
            x = torch.as_tensor(net_all[sample_idx[sl]], device=device)
            x = apply_camera_dropout(
                x, torch.as_tensor(masks[sl], device=device), J)
            x = apply_prior_dropout(
                x, torch.as_tensor(jkeep[sl], device=device), J)
            outs.append(x.cpu().numpy())
    net_final = np.concatenate(outs)
    err_final = err_all[sample_idx]
    if cache_path:
        # published with one rename: a concurrent reader never sees a
        # half-written cache
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, net=net_final, err=err_final)
        os.replace(tmp, cache_path)
    return net_final, err_final


def build_lifter_dataset_from_files(paths: Sequence[str],
                                    rig_config: RigConfig, rig: CameraRig,
                                    cache: bool = False, **kw
                                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``build_lifter_dataset`` of wire files (read by the C++ parser).
    With ``cache`` the arrays are kept beside the last file, in a name
    keyed on every packing option and on all the input paths."""
    frames: List = []
    for p in paths:
        frames.extend(parse_frames_file(p, rig_config))
    cache_path = None
    if cache:
        tag = hashlib.sha1("|".join(os.path.abspath(p)
                                    for p in paths).encode()).hexdigest()[:8]
        lvb = kw.get("low_view_bias", 0.0)
        suffix = (f".{kw.get('prior', 'mean')}"
                  f".a{int(kw.get('augment', True))}"
                  f"x{kw.get('max_combinations', 5)}.s{kw.get('seed', 0)}"
                  f".pd{kw.get('prior_dropout', 0.0)}"
                  + (f".lvb{lvb}" if lvb else "") + f".{tag}")
        cache_path = f"{paths[-1]}.mpe3d_torch{suffix}.npz"
    return build_lifter_dataset(frames, rig_config, rig,
                                cache_path=cache_path, **kw)

