"""The one module of the benchmark that imports the program under test,
``mpe3d_tpu_torch``: it builds the served pipeline and drives lifter
training from what the benchmark made (rig arrays, frames, weights,
datasets), or serves a stored lifter through the program's own
checkpoint readers.  The references never import it."""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import checkpoints
from portbench.frames import Frames, Rig

# what a configuration of a stored lifter states, as its meta must hold it
LIFTER_META = ("in_dim", "out_dim", "widths", "negative_slope",
               "residual_prior", "prior", "stored")


def check_rig(cfg: dict) -> None:
    """The program's rig preset must be the configuration's cameras."""
    from mpe3d_tpu_torch.config import get_rig
    rc = get_rig(cfg["rig"])
    cams = cfg["cameras"]
    same = list(rc.camera_names) == cams["names"] and all(
        np.allclose(getattr(rc, k), cams[k], rtol=1e-7, atol=0)
        for k in ("fx", "fy", "cx", "cy", "kd0", "kd1", "kd2", "p1", "p2"))
    if not same:
        raise SystemExit(f"rig preset {cfg['rig']}: its cameras differ "
                         f"from the configuration's")
    if (rc.image_width, rc.image_height) != (cfg["image_width"],
                                             cfg["image_height"]) \
            or rc.n_joints != cfg["n_joints"] \
            or rc.min_number_of_views != cfg["min_views"] \
            or rc.matcher_feature_dim != cfg["matcher"]["in_dim"] \
            or rc.lifter_input_dim != cfg["lifter"]["in_dim"]:
        raise SystemExit(f"rig preset {cfg['rig']} differs from the "
                         f"configuration's sizes")


def _camera_rig(rig: Rig):
    from mpe3d_tpu_torch.geometry.camera import make_rig
    return make_rig(rig.K, rig.dist, rig.T_wc, tuple(rig.image_size))


def _seeded_matcher(cfg: dict, layers, dev):
    from mpe3d_tpu_torch.config import MatcherConfig
    from mpe3d_tpu_torch.weights import matcher_from_tree
    m = cfg["matcher"]
    mcfg = MatcherConfig(in_dim=m["in_dim"], hidden=tuple(m["hidden"]),
                         heads=tuple(m["heads"]), n_classes=m["n_classes"],
                         alpha=m["alpha"], hidden_slope=m["hidden_slope"])
    return matcher_from_tree({"layers": layers}, mcfg, dev)


def _serving(cfg: dict, traffic: dict, dev) -> dict:
    """The serving settings of the configuration and the mix, on the
    frame path (on the CPU its plain versions)."""
    s = cfg["serve"]
    return dict(slot_buckets=(traffic["slots"],),
                person_buckets=tuple(traffic["person_buckets"]),
                threshold=s["threshold"], decode_top_k=s["decode_top_k"],
                use_frame_kernel=True if dev.type == "cpu" else None,
                device=dev)


def pipeline(cfg: dict, traffic: dict, rig: Rig, matcher_layers, lifter_layers,
             device):
    """The served pipeline with the configuration's models and serving
    settings, on the frame path (on the CPU its plain versions)."""
    from mpe3d_tpu_torch.config import LifterConfig, get_rig
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch.weights import lifter_from_tree
    l = cfg["lifter"]
    lcfg = LifterConfig(in_dim=l["in_dim"], out_dim=l["out_dim"],
                        widths=tuple(l["widths"]),
                        negative_slope=l["negative_slope"])
    dev = torch.device(device)
    return PoseEstimationPipeline(
        get_rig(cfg["rig"]), _camera_rig(rig),
        _seeded_matcher(cfg, matcher_layers, dev),
        lifter_from_tree({"layers": lifter_layers}, lcfg, dev),
        lifter_prior=l["prior"], **_serving(cfg, traffic, dev))


def _lifter_default(cfg: dict):
    """The lifter sizes the program takes where a meta states none, as
    ``PoseEstimationPipeline.from_checkpoint`` does."""
    from mpe3d_tpu_torch.config import LifterConfig, get_rig
    rc = get_rig(cfg["rig"])
    return LifterConfig(in_dim=rc.lifter_input_dim, out_dim=rc.n_joints * 3)


def check_lifter(cfg: dict) -> None:
    """The stored lifter's meta, as the program reads it, must be the
    configuration's lifter: each of ``LIFTER_META``."""
    from mpe3d_tpu_torch.checkpoint import (lifter_config_from_meta,
                                            open_checkpoint)
    _, meta = open_checkpoint(checkpoints.path(cfg["lifter"]["checkpoint"]))
    lc = lifter_config_from_meta(meta, _lifter_default(cfg))
    stored = {"in_dim": lc.in_dim, "out_dim": lc.out_dim,
              "widths": list(lc.widths), "negative_slope": lc.negative_slope,
              "residual_prior": lc.residual_prior,
              "prior": meta.get("prior", "mean"),
              "stored": meta.get("stored", "fp32")}
    differ = [k for k in LIFTER_META if cfg["lifter"].get(k) != stored[k]]
    if differ:
        raise SystemExit(f"{cfg['lifter']['checkpoint']}: its meta differs "
                         f"from the configuration's lifter in "
                         + ", ".join(f"{k} ({stored[k]!r}, stated "
                                     f"{cfg['lifter'].get(k)!r})"
                                     for k in differ))


def served_pipeline(cfg: dict, traffic: dict, rig: Rig, device,
                    matcher_layers=None):
    """The served pipeline on the configuration's stored lifter
    (``cfg["lifter"]["checkpoint"]``, a stem relative to the repository's
    root), read by the program's own readers: its architecture, residual
    prior, packing prior and stored dtype come from the meta, which
    ``check_lifter`` holds to the configuration.  Without
    ``matcher_layers`` the matcher is the stem's directory's
    ``skeleton_matching`` and the pipeline is
    ``PoseEstimationPipeline.from_checkpoint``'s; with them, the seeded
    matcher as ``pipeline`` builds it.  Serving settings as ``pipeline``'s."""
    from mpe3d_tpu_torch.checkpoint import load_lifter_checkpoint
    from mpe3d_tpu_torch.config import get_rig
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch.weights import lifter_from_tree
    check_lifter(cfg)
    stem = checkpoints.path(cfg["lifter"]["checkpoint"])
    dev = torch.device(device)
    serving = _serving(cfg, traffic, dev)
    if matcher_layers is None:
        if os.path.basename(stem) != "pose_estimator":
            raise SystemExit(f"{cfg['lifter']['checkpoint']}: a models "
                             f"directory's lifter is its pose_estimator")
        return PoseEstimationPipeline.from_checkpoint(
            os.path.dirname(stem), _camera_rig(rig), get_rig(cfg["rig"]),
            **serving)
    ltree, lcfg, prior = load_lifter_checkpoint(stem, _lifter_default(cfg))
    return PoseEstimationPipeline(
        get_rig(cfg["rig"]), _camera_rig(rig),
        _seeded_matcher(cfg, matcher_layers, dev),
        lifter_from_tree(ltree, lcfg, dev), lifter_prior=prior, **serving)


def frame_list(fr: Frames) -> list:
    """The frames as the program's ``FrameArrays`` (views, no copies)."""
    from mpe3d_tpu_torch.data.frames import FrameArrays
    ts = np.zeros(fr.kp.shape[1], np.float64)
    return [FrameArrays(fr.kp[i], fr.valid[i], fr.prob[i], fr.in_view[i],
                        fr.present[i], ts) for i in range(len(fr))]


def train_lifter(cfg: dict, rig: Rig, data: Dict[str, np.ndarray],
                 layers: List[Dict[str, torch.Tensor]],
                 stop_flag: Callable[[], bool], device,
                 batch_size: Optional[int] = None):
    """``train_lifter`` on the packed dataset from the given fp32 weights,
    at the configuration's training settings; no checkpoint is written."""
    from mpe3d_tpu_torch.config import (LifterConfig, LifterTrainConfig,
                                        get_rig)
    from mpe3d_tpu_torch.train.lifter import train_lifter as train
    l, t = cfg["lifter"], cfg["train"]
    lcfg = LifterConfig(in_dim=l["in_dim"], out_dim=l["out_dim"],
                        widths=tuple(l["widths"]),
                        negative_slope=l["negative_slope"])
    tcfg = LifterTrainConfig(
        epochs=t["epochs"], lr=t["lr"],
        batch_size=batch_size or t["batch_size"], patience=t["patience"],
        eval_every=t["eval_every"], grad_clip_norm=t["grad_clip_norm"],
        seed=t["seed"], shuffle=t["shuffle"], loss=t["loss"])
    tree = {"layers": [{"w": p["w"], "b": p["b"]} for p in layers]}
    return train(data["net_train"], data["err_train"], data["net_dev"],
                 data["err_dev"], get_rig(cfg["rig"]), _camera_rig(rig),
                 cfg=lcfg, tcfg=tcfg, params=tree, log=lambda s: None,
                 stop_flag=stop_flag, device=device)
