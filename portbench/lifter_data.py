"""The lifter's training set, packed by the benchmark from seeded frames (a
frozen copy of the port's ``train/lifter_data.py`` packing): the
skeleton with most joints in each camera (one person a frame), its
14-numbers-a-(camera, joint) network input with the "mean" prior and its
4-numbers-a-(camera, joint) loss input, then the camera-dropout
augmentation (the full camera set first, then up to ``max_combinations``
- 1 distinct random strict subsets, fields 0-9 of dropped cameras
zeroed).  The frames mark every detected joint valid, so the training
path's packing mask (observed and valid) is the observed mask.  Samples
whose packed input is not finite (a joint on two cameras' baseline: the
two-view triangulation behind the prior is singular there) are left
out."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench import frames as F
from portbench.reference import pose as R
from portbench.reference.geometry import torch_rig


def camera_subsets(flags: np.ndarray, max_count: int,
                   rng: np.random.Generator) -> List[np.ndarray]:
    out = [flags.astype(np.float32)]
    avail = np.nonzero(flags)[0]
    n = len(avail)
    if n <= 1:
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


def pack(cfg: dict, rig: F.Rig, fr: F.Frames, max_combinations: int,
         rng: np.random.Generator, device) -> Tuple[np.ndarray, np.ndarray]:
    """(network inputs [N, C*J*14], loss inputs [N, C*J*4]) of frames."""
    dev = torch.device(device)
    best = fr.in_view.sum(axis=3).argmax(axis=2)                # [F, C]
    f_i = np.arange(len(fr))[:, None]
    c_i = np.arange(fr.kp.shape[1])[None, :]
    kp, valid, prob, obs = (a[f_i, c_i, best] for a in
                            (fr.kp, fr.valid, fr.prob, fr.in_view))
    t = [torch.as_tensor(a, device=dev) for a in (kp, valid, prob, obs)]
    size = (cfg["image_width"], cfg["image_height"])
    with torch.no_grad():
        net = R.lifter_input(*t, torch_rig(rig, dev), size).cpu().numpy()
    m = obs.astype(np.float32)
    err = np.stack([valid * m, kp[..., 0] * m, kp[..., 1] * m, prob * m],
                   -1).reshape(len(fr), -1)
    flags = obs.any(axis=2)
    # a joint on the baseline of two cameras makes their two-view DLT
    # singular and its "mean" prior infinite: such a sample is no input a
    # trainer can take, so it is left out
    keep = flags.any(axis=1) & np.isfinite(net).all(axis=1)
    net, err, flags = net[keep], err[keep], flags[keep]
    idx, masks = [], []
    for i in range(len(net)):
        for mk in camera_subsets(flags[i], max_combinations, rng):
            idx.append(i)
            masks.append(mk)
    C, J = fr.kp.shape[1], fr.kp.shape[3]
    x = net[np.asarray(idx)].reshape(len(idx), C, J, 14)
    obs_field = (np.arange(14) < 10).astype(np.float32)
    keepm = np.stack(masks)[:, :, None, None]
    x = x * (keepm * obs_field + (1.0 - obs_field))
    return x.reshape(len(idx), -1).astype(np.float32), err[np.asarray(idx)]


def dataset(cfg: dict, rig: F.Rig, traffic: dict, batch_size: int, seed: int,
            device) -> dict:
    """``train_batches`` full batches of training rows and ``dev_batches``
    of dev rows, from disjoint seeded frame streams."""
    out = {}
    for split, n_batches, stream in (("train", traffic["train_batches"], 0),
                                     ("dev", traffic["dev_batches"], 1)):
        need = n_batches * batch_size
        nets, errs, have, k = [], [], 0, 0
        rng = np.random.default_rng([seed % 2 ** 63, 100 + stream])
        while have < need:
            n_frames = max(16, int((need - have) / 4.5) + 16)
            fr = F.generate(cfg, rig, n_frames, tuple(traffic["people"]),
                            1, [seed % 2 ** 63, stream, k],
                            traffic["spread_m"])
            net, err = pack(cfg, rig, fr, traffic["max_combinations"], rng,
                            device)
            nets.append(net)
            errs.append(err)
            have += len(net)
            k += 1
        out["net_" + split] = np.concatenate(nets)[:need]
        out["err_" + split] = np.concatenate(errs)[:need]
    return out
