"""Command line of the PyTorch port: ``serve`` and ``infer``.

Port of the serving subcommands of ``mpe3d_tpu/cli.py`` (``load_rig``
:35, ``load_models`` :54, ``build_pipeline`` :133, ``cmd_infer`` :454,
``cmd_serve`` :520, the parser :884-1274)::

    python -m mpe3d_tpu_torch serve --modelsdir models_demo/pan_irls_bf16 \\
        [--rig PANOPTIC|ARPLAB] [--tcp PORT] [--depth 3] [--track] \\
        [--quality-gate PX] [--warmup] [--batch-window N] \\
        [--batch-linger-ms MS]
    python -m mpe3d_tpu_torch infer --modelsdir DIR --testfiles f.json \\
        [--stream 3 | --batch] [--out poses.json]

``--backend triangulation`` (with ``--tri-variant median|irls``) and the
geometric decode options (``--geo-rerank``, ``--geo-rescue``,
``--geo-rescue-dist``) serve through the eager path; a rig with one
matching camera through the staged path's single-camera bypass.

Both run on the CUDA card, or with ``--cpu`` on the CPU through the
kernels' plain versions; without a card and without ``--cpu`` they fail.
Options of the JAX command line that the port does not have are refused
with the ROADMAP.md item that will bring them, never ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig, get_rig

# the lifter dtype a --serve-dtype asks weights.lifter_from_tree for; auto
# keeps the port's default, bf16 (int8 exports serve int8 whatever it says)
SERVE_DTYPES = {"auto": None, "bf16": None, "fp32": "fp32", "int8": "int8"}


def _refuse(what: str, where: str) -> None:
    sys.exit(f"mpe3d_tpu_torch: {what} is not in the PyTorch port yet "
             f"({where})")


def _refuse_unported(args) -> None:
    """Exit with a message for every option the port does not have."""
    if args.no_pallas_matcher or args.fused_mlp:
        _refuse("--no-pallas-matcher / --fused-mlp (TPU kernel switches)",
                "they have no meaning in the port: its kernels serve "
                "every path")
    if getattr(args, "multi_device", False):
        _refuse("--multi-device", "multi-device serving, ROADMAP.md section "
                "1, item 6; not applicable on one card")


def load_rig(args):
    """(RigConfig, CameraRig) from ``--rig`` (a preset name, any case; an
    unknown one raises ``get_rig``'s KeyError, as the reference's
    ``load_rig`` does) and ``--tm``: the calibration file given, else the
    rig's default file where it exists, else a synthetic ring rig (with a
    warning).  A ``--tm`` that does not exist fails."""
    from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
    from mpe3d_tpu_torch.geometry.calib_io import rig_from_files

    rig_config = get_rig(args.rig)
    tm = args.tm or rig_config.transformations_path
    if tm and os.path.exists(tm):
        return rig_config, rig_from_files(rig_config, tm)
    if args.tm:
        sys.exit(f"--tm {args.tm}: file not found")
    print(f"[mpe3d_torch] calibration '{tm}' not found: using a synthetic "
          f"ring rig", file=sys.stderr)
    return rig_config, synthetic_ring_rig(rig_config)


def load_models(models_dir: str, rig_config):
    """(matcher tree, MatcherConfig, lifter tree, LifterConfig, prior) of a
    models directory's npz checkpoints (``checkpoint.py``); a model without
    a checkpoint gets numpy-seeded random weights, with a warning.  The
    reference's torch files (``.tch``, ``.pytorch``) and orbax checkpoints
    are refused."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)

    mcfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    lcfg = LifterConfig(in_dim=rig_config.lifter_input_dim,
                        out_dim=rig_config.n_joints * 3)
    stems = {name: os.path.join(models_dir, name)
             for name in ("skeleton_matching", "pose_estimator")}
    for name, stem in stems.items():
        if os.path.isdir(stem + ".orbax"):
            _refuse(f"the orbax checkpoint {stem}.orbax",
                    "checkpoints beyond npz, ROADMAP.md section 1, item 8")
    for torch_file in ("skeleton_matching.tch", "pose_estimator.pytorch"):
        if (os.path.exists(os.path.join(models_dir, torch_file))
                and not os.path.exists(
                    stems[torch_file.split(".")[0]] + ".npz")):
            _refuse(f"the reference torch checkpoint {torch_file}",
                    "conversion, ROADMAP.md section 1, item 9")
    if os.path.exists(stems["skeleton_matching"] + ".npz"):
        mtree, mcfg = load_matcher_checkpoint(stems["skeleton_matching"],
                                              mcfg)
    else:
        print("[mpe3d_torch] no matcher checkpoint found: random weights",
              file=sys.stderr)
        mtree = weights.random_matcher_tree(mcfg, 0)
    prior = "mean"
    if os.path.exists(stems["pose_estimator"] + ".npz"):
        ltree, lcfg, prior = load_lifter_checkpoint(
            stems["pose_estimator"], lcfg)
    else:
        print("[mpe3d_torch] no lifter checkpoint found: random weights",
              file=sys.stderr)
        ltree = weights.random_lifter_tree(lcfg, 1)
    return mtree, mcfg, ltree, lcfg, prior


def build_pipeline(args):
    """(RigConfig, CameraRig, PoseEstimationPipeline) of the command line,
    on the card, or on the CPU with ``--cpu``.  A ``refined_rig.npz`` in
    the models directory (a checkpoint trained with
    ``--optimise-matrices``) replaces the ``--tm`` calibration."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.geometry.camera import load_rig_npz
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    _refuse_unported(args)
    device = "cpu" if args.cpu else "cuda"
    rig_config, rig = load_rig(args)
    refined = os.path.join(args.modelsdir, "refined_rig.npz")
    if os.path.exists(refined):
        rig = load_rig_npz(refined)
        print(f"[mpe3d_torch] using refined calibration {refined} (trained "
              f"with --optimise-matrices; overrides --tm)", file=sys.stderr)
    mtree, mcfg, ltree, lcfg, prior = load_models(args.modelsdir, rig_config)
    pipe = PoseEstimationPipeline(
        rig_config, rig, weights.matcher_from_tree(mtree, mcfg, device),
        weights.lifter_from_tree(ltree, lcfg, device,
                                 SERVE_DTYPES[args.serve_dtype]),
        lifter_prior=prior, prior_gate_px=args.prior_gate_px,
        pair_prune_dist=args.pair_prune_dist,
        pair_prune_cap=args.pair_prune_cap,
        use_frame_kernel=False if args.no_frame_kernel else None,
        device=device, backend=args.backend, tri_variant=args.tri_variant,
        geo_rerank=args.geo_rerank, geo_rescue=args.geo_rescue,
        geo_rescue_dist=args.geo_rescue_dist)
    return rig_config, rig, pipe


def _make_tracker(args):
    if not args.track:
        return None
    from mpe3d_tpu_torch.tracking import PoseTracker
    return PoseTracker(max_dist=args.track_max_dist,
                       max_missed=args.track_max_missed,
                       smooth=args.track_smooth)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def cmd_infer(args) -> None:
    """Wire-format JSON files -> one JSON list of {frame, n_persons,
    persons, quality_px, poses_m} (and track_ids with --track), through
    ``infer_stream`` with ``--stream`` frames in flight, or ``infer_batch``
    with ``--batch``; with one matching camera, the staged path's bypass."""
    from mpe3d_tpu_torch.data.frames import parse_frames_file
    from mpe3d_tpu_torch.serve import gate_and_track

    rig_config, _, pipe = build_pipeline(args)
    fas = []
    for p in args.testfiles:
        fas.extend(parse_frames_file(p, rig_config, args.max_skeletons))
    if len(pipe.match_idx) <= 1:
        outs = [pipe(fa) for fa in fas]
    elif args.batch:
        outs = pipe.infer_batch(fas)
    else:
        outs = pipe.infer_stream(fas, depth=max(args.stream, 1))
    tracker = _make_tracker(args)
    result = []
    for i, o in enumerate(outs):
        poses, quality, persons, ids, dropped = gate_and_track(
            o.poses, o.quality, gate=args.quality_gate, tracker=tracker,
            persons=o.persons)
        rec = {"frame": i}
        if dropped:
            rec["dropped_low_quality"] = dropped
        rec["n_persons"] = int(len(persons))
        rec["persons"] = np.asarray(persons).tolist()
        if ids is not None:
            rec["track_ids"] = ids.tolist()
        rec["quality_px"] = np.asarray(quality).round(2).tolist()
        rec["poses_m"] = poses.round(4).tolist()
        result.append(rec)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({len(result)} frames)", file=sys.stderr)
    else:
        print(text)


def cmd_serve(args) -> None:
    """The long-lived serving front end (``serve.py``) over stdio, or TCP
    with ``--tcp``.  On exit, one stderr line says how many frame lines
    the C++ parser and the python parser read."""
    from mpe3d_tpu_torch import native
    from mpe3d_tpu_torch.data.frames import FrameArrays
    from mpe3d_tpu_torch.serve import PoseServer, serve_tcp

    rig_config, _, pipe = build_pipeline(args)
    if args.warmup:
        pipe.warmup(fused=len(pipe.match_idx) > 1)
        native.load_library()
    if args.warmup and args.batch_window > 1 and len(pipe.match_idx) > 1:
        # the padded batch of each slot bucket once: its plans and tables
        C, J = rig_config.n_cameras, rig_config.n_joints
        for S in pipe.slot_buckets:
            empty = FrameArrays(np.zeros((C, S, J, 2), np.float32),
                                np.zeros((C, S, J), np.float32),
                                np.zeros((C, S, J), np.float32),
                                np.zeros((C, S, J), bool),
                                np.zeros((C, S), bool), np.zeros(C))
            pipe.collect_batch(pipe.submit_batch(
                [empty], slots=S, pad_to=args.batch_window))
    # track state is per stream: every connection starts with fresh ids
    tracker_factory = (lambda: _make_tracker(args)) if args.track else None
    server = PoseServer(pipe, rig_config, max_skeletons=args.max_skeletons,
                        depth=args.depth, tracker_factory=tracker_factory,
                        quality_gate=args.quality_gate,
                        batch_window=args.batch_window,
                        batch_linger_ms=args.batch_linger_ms)
    try:
        if args.tcp is not None:
            serve_tcp(server, host=args.host, port=args.tcp,
                      max_clients=args.max_clients)
        else:
            server.serve_stdio()
    finally:
        lib = native.LIB_PATH if native.load_library() else "unavailable"
        print(f"[mpe3d_torch] frame lines parsed: native "
              f"{server.parsed['native']}, python "
              f"{server.parsed['python']} (native library: {lib})",
              file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def _add_track_flags(p) -> None:
    p.add_argument("--quality-gate", type=float, default=None, metavar="PX",
                   help="drop output poses whose quality column (mean "
                   "reprojection residual, px) exceeds PX; applied before "
                   "tracking")
    p.add_argument("--track", action="store_true",
                   help="assign stable person ids across frames "
                   "(tracking.py)")
    p.add_argument("--track-max-dist", type=float, default=0.5,
                   help="association gate: mean per-joint distance (m)")
    p.add_argument("--track-max-missed", type=int, default=10,
                   help="frames a track coasts before retiring")
    p.add_argument("--track-smooth", type=float, default=0.0,
                   help="EMA weight on history for reported joints "
                   "(0 = raw)")


def _add_common(p) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions "
                   "(default: the CUDA card; without one the command "
                   "fails)")
    p.add_argument("--rig", default="PANOPTIC",
                   help="rig preset name: PANOPTIC or ARPLAB (any case)")
    p.add_argument("--tm", default=None,
                   help="calibration file (pytransform3d pickle or JSON)")
    p.add_argument("--modelsdir", default="./models",
                   help="directory with the npz checkpoints")
    p.add_argument("--backend", choices=("mlp", "triangulation"),
                   default="mlp", help="3D backend: the learned lifter or "
                   "the classical triangulation (eager path)")
    p.add_argument("--max-skeletons", type=int, default=10)
    p.add_argument("--serve-dtype", default="auto",
                   choices=tuple(SERVE_DTYPES),
                   help="lifter weights: auto and bf16 serve bf16, fp32 "
                   "fp32 (eager path), int8 quantises; int8 exports serve "
                   "int8")
    p.add_argument("--prior-gate", dest="prior_gate_px", type=float,
                   default=None, metavar="PX",
                   help="drop a joint's triangulated lifter prior when it "
                   "reprojects more than PX pixels from its 2D evidence")
    p.add_argument("--pair-prune-dist", type=float, default=0.0,
                   metavar="M", help="geometric candidate-pair pruning "
                   "distance in metres on the frame path (0 = off)")
    p.add_argument("--pair-prune-cap", type=int, default=0,
                   help="compacted pair count under pruning (0 = auto)")
    p.add_argument("--no-frame-kernel", action="store_true",
                   help="serve through the eager path (decode and packing "
                   "in PyTorch) instead of the frame path")
    p.add_argument("--geo-rerank", type=float, default=0.0,
                   help="geometric decode rerank weight (0 = off; eager "
                   "path)")
    p.add_argument("--geo-rescue", type=float, default=0.0,
                   help="geometric rescue low-score floor (0 = off; forces "
                   "the uncapped decode; eager path)")
    p.add_argument("--geo-rescue-dist", type=float, default=0.05,
                   help="geometric rescue ray distance (m)")
    p.add_argument("--tri-variant", default="median",
                   choices=("median", "irls"),
                   help="triangulator of --backend triangulation")
    # options of the JAX command line the port refuses (_refuse_unported)
    p.add_argument("--no-pallas-matcher", action="store_true",
                   help="TPU switch, refused")
    p.add_argument("--fused-mlp", action="store_true",
                   help="TPU switch, refused")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpe3d_tpu_torch",
        description="Multi-person 3D pose estimation, PyTorch/CUDA port: "
        "serve and infer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("infer", help="wire JSON files -> 3D poses JSON")
    _add_common(p)
    p.add_argument("--testfiles", nargs="+", required=True)
    p.add_argument("--out", default=None,
                   help="output JSON path (default stdout)")
    p.add_argument("--stream", type=int, default=3,
                   help="frames in flight (infer_stream depth)")
    p.add_argument("--batch", action="store_true",
                   help="one batched submit (infer_batch) instead of "
                   "streaming")
    _add_track_flags(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("serve", help="line-protocol server over stdio or "
                       "TCP")
    _add_common(p)
    p.add_argument("--depth", type=int, default=3,
                   help="in-flight window (1 = synchronous)")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve on a TCP port (0 = ephemeral) instead of "
                   "stdio")
    p.add_argument("--max-clients", type=int, default=1,
                   help="TCP connections served at once (each with its "
                   "own window and tracker); more wait")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--warmup", action="store_true",
                   help="run every slot bucket once (and its padded batch "
                   "with --batch-window), and load the C++ parser, before "
                   "serving")
    p.add_argument("--multi-device", action="store_true",
                   help="not ported: refused")
    p.add_argument("--batch-window", type=int, default=1,
                   help="micro-batching: group up to N consecutive frames "
                   "into one submit_batch (1 = off)")
    p.add_argument("--batch-linger-ms", type=float, default=5.0,
                   help="longest a partial batch window waits for more "
                   "frames")
    _add_track_flags(p)
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if not args.cpu:
        import torch
        if not torch.cuda.is_available():
            sys.exit("mpe3d_tpu_torch: no CUDA device is available; the "
                     "port serves on the card, or on the CPU through the "
                     "kernels' plain versions with --cpu")
    args.fn(args)
    return 0
