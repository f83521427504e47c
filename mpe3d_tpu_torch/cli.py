"""Command line of the PyTorch port: serving, evaluation, training and the
model files.

Port of ``mpe3d_tpu/cli.py`` (``load_rig`` :35, ``load_models`` :54,
``build_pipeline`` :133, ``cmd_train_matcher`` :213, ``cmd_train_lifter``
:303, the evaluation commands :392-452, ``cmd_infer`` :454, ``cmd_serve``
:520, ``cmd_merge_jsons`` and ``cmd_generate_synthetic`` :671-691,
``cmd_convert_torch`` / ``cmd_export_torch`` :714-785,
``cmd_export_servable`` :787, the parser :990-1274)::

    python -m mpe3d_tpu_torch serve --modelsdir models_demo/pan_irls_bf16 \\
        [--rig PANOPTIC|ARPLAB] [--tcp PORT] [--depth 3] [--track] \\
        [--quality-gate PX] [--warmup] [--batch-window N] \\
        [--batch-linger-ms MS]
    python -m mpe3d_tpu_torch infer --modelsdir DIR --testfiles f.json \\
        [--stream 3 | --batch] [--out poses.json] [--profile-trace DIR]
    python -m mpe3d_tpu_torch metrics-from-model --modelsdir DIR \
        --testfiles f.json [--fused | --stream N | --device-decode] \
        [--dedup-gt] [--dataset-tm TM]    (also metrics-from-triangulation)
    python -m mpe3d_tpu_torch sm-metrics [--unassigned singleton] ...
    python -m mpe3d_tpu_torch sm-metrics-without-gt --testfiles a.json ...
    python -m mpe3d_tpu_torch reprojection-error [--showgt] ...
    python -m mpe3d_tpu_torch generate-synthetic --output f.json \
        [--single-person] [--frames 200]
    python -m mpe3d_tpu_torch merge-jsons a.json b.json out.json
    python -m mpe3d_tpu_torch train-lifter --modelsdir DIR \
        --trainset t.json --devset d.json [--resume] [--optimise-matrices]
    python -m mpe3d_tpu_torch train-matcher --modelsdir DIR \
        --trainset a.json b.json --devset d.json [--testset t.json] \
        [--slots 4] [--resume] [--device-synth]
    python -m mpe3d_tpu_torch convert-torch --lifter pose_estimator.pytorch \
        --matcher skeleton_matching.tch --prms skeleton_matching.prms \
        --modelsdir DIR
    python -m mpe3d_tpu_torch export-torch --modelsdir DIR --out TORCH_DIR
    python -m mpe3d_tpu_torch export-servable --modelsdir DIR --out DIR2 \
        [--dtype int8|bf16]

Each evaluation command prints the JAX command's report (a JSON object);
``train-lifter`` writes ``pose_estimator.npz`` (and ``refined_rig.npz``
with ``--optimise-matrices``) into ``--modelsdir``, ``train-matcher``
``skeleton_matching.npz``.  A models directory may hold the reference's
torch files (``skeleton_matching.tch`` + ``.prms``,
``pose_estimator.pytorch``) instead of npz checkpoints; they are served
as they are.  ``infer --profile-trace DIR`` writes a ``torch.profiler``
Chrome trace of the inference (``utils/logging.py``).

``--backend triangulation`` (with ``--tri-variant median|irls``) and the
geometric decode options (``--geo-rerank``, ``--geo-rescue``,
``--geo-rescue-dist``) serve through the eager path; a rig with one
matching camera through the staged path's single-camera bypass.

Commands that use a device run on the CUDA card, or with ``--cpu`` on the
CPU through the kernels' plain versions; without a card and without
``--cpu`` they fail.  Commands and options of the JAX command line that
the port does not have are refused with the ROADMAP.md item that will
bring them, never ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
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
    models directory: its npz checkpoints (``checkpoint.py``), else the
    reference's torch files (``skeleton_matching.tch`` + ``.prms``,
    ``pose_estimator.pytorch``; ``convert/torch_import.py``); a model
    without either gets numpy-seeded random weights, with a warning.
    Orbax checkpoints are refused."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)
    from mpe3d_tpu_torch.convert.torch_import import (load_reference_lifter,
                                                      load_reference_matcher)

    mcfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    lcfg = LifterConfig(in_dim=rig_config.lifter_input_dim,
                        out_dim=rig_config.n_joints * 3)
    j = os.path.join
    stems = {name: j(models_dir, name)
             for name in ("skeleton_matching", "pose_estimator")}
    for name, stem in stems.items():
        if os.path.isdir(stem + ".orbax"):
            _refuse(f"the orbax checkpoint {stem}.orbax",
                    "checkpoints beyond npz, ROADMAP.md section 1, item 8")
    if os.path.exists(stems["skeleton_matching"] + ".npz"):
        mtree, mcfg = load_matcher_checkpoint(stems["skeleton_matching"],
                                              mcfg)
    elif os.path.exists(j(models_dir, "skeleton_matching.tch")):
        mtree, mcfg = load_reference_matcher(
            j(models_dir, "skeleton_matching.tch"),
            j(models_dir, "skeleton_matching.prms"))
    else:
        print("[mpe3d_torch] no matcher checkpoint found: random weights",
              file=sys.stderr)
        mtree = weights.random_matcher_tree(mcfg, 0)
    prior = "mean"
    if os.path.exists(stems["pose_estimator"] + ".npz"):
        ltree, lcfg, prior = load_lifter_checkpoint(
            stems["pose_estimator"], lcfg)
    elif os.path.exists(j(models_dir, "pose_estimator.pytorch")):
        ltree, lcfg = load_reference_lifter(
            j(models_dir, "pose_estimator.pytorch"))
    else:
        print("[mpe3d_torch] no lifter checkpoint found: random weights",
              file=sys.stderr)
        ltree = weights.random_lifter_tree(lcfg, 1)
    return mtree, mcfg, ltree, lcfg, prior


def build_pipeline(args, backend=None):
    """(RigConfig, CameraRig, PoseEstimationPipeline) of the command line,
    on the card, or on the CPU with ``--cpu``; ``backend`` overrides
    ``--backend`` (the evaluation commands fix it).  A ``refined_rig.npz``
    in the models directory (a checkpoint trained with
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
        device=device, backend=backend or args.backend,
        tri_variant=args.tri_variant,
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
    with ``--batch``; with one matching camera, the staged path's bypass.
    ``--profile-trace DIR``: a ``torch.profiler`` trace of the inference
    (``utils/logging.py::profiler_trace``), the output unchanged."""
    from mpe3d_tpu_torch.data.frames import parse_frames_file
    from mpe3d_tpu_torch.serve import gate_and_track

    rig_config, _, pipe = build_pipeline(args)
    fas = []
    for p in args.testfiles:
        fas.extend(parse_frames_file(p, rig_config, args.max_skeletons))
    trace = contextlib.nullcontext()
    if args.profile_trace:
        from mpe3d_tpu_torch.utils.logging import profiler_trace
        trace = profiler_trace(args.profile_trace)
    with trace as prof:
        if len(pipe.match_idx) <= 1:
            outs = [pipe(fa) for fa in fas]
        elif args.batch:
            outs = pipe.infer_batch(fas)
        else:
            outs = list(pipe.infer_stream(fas, depth=max(args.stream, 1)))
    if prof is not None:
        print(f"[mpe3d_torch] profile trace: {prof.trace_path}",
              file=sys.stderr)
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
        if args.track:
            # the tracker's Hungarian solver (scipy.optimize) loads with it
            from mpe3d_tpu_torch import tracking  # noqa: F401
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


def _print_report(report: dict) -> None:
    print(json.dumps(report, indent=2, default=str))


def _pose_metrics(args, backend: str) -> None:
    from mpe3d_tpu_torch.data.frames import load_eval_frames
    from mpe3d_tpu_torch.eval.runners import run_pose_metrics

    rig_config, _, pipe = build_pipeline(args, backend)
    dataset_T = None
    if args.dataset_tm:
        from mpe3d_tpu_torch.geometry.calib_io import load_transform_manager
        dataset_T = load_transform_manager(args.dataset_tm).get_transform(
            "root", rig_config.camera_names[1])
    pipe.decode_on_device = args.device_decode
    _print_report(run_pose_metrics(
        load_eval_frames(args.testfiles, rig_config, args.max_skeletons),
        rig_config, pipe, datastep=args.datastep, dataset_T_wc1=dataset_T,
        max_skeletons=args.max_skeletons, fused=args.fused,
        stream=args.stream, dedup_gt=args.dedup_gt))


def cmd_metrics_from_model(args) -> None:
    """3D accuracy and timing of the lifter pipeline (reference
    test/metrics_from_model.py)."""
    _pose_metrics(args, "mlp")


def cmd_metrics_from_triangulation(args) -> None:
    """3D accuracy and timing of the triangulation backend (reference
    test/metrics_from_triangulation.py)."""
    _pose_metrics(args, "triangulation")


def cmd_sm_metrics(args) -> None:
    """Matching quality against GT (reference test/sm_metrics.py)."""
    from mpe3d_tpu_torch.data.frames import load_frames
    from mpe3d_tpu_torch.eval.runners import run_sm_metrics

    rig_config, _, pipe = build_pipeline(args, "triangulation")
    pipe.decode_on_device = args.device_decode
    frames = [f for p in args.testfiles for f in load_frames(p)]
    _print_report(run_sm_metrics(frames, rig_config, pipe,
                                 datastep=args.datastep,
                                 max_skeletons=args.max_skeletons,
                                 unassigned=args.unassigned))


def cmd_sm_metrics_without_gt(args) -> None:
    """GT-free matching quality on composited single-person recordings
    (reference test/sm_metrics_without_gt.py)."""
    from mpe3d_tpu_torch.data.frames import load_frames
    from mpe3d_tpu_torch.eval.runners import run_sm_metrics_without_gt

    rig_config, _, pipe = build_pipeline(args, "triangulation")
    _print_report(run_sm_metrics_without_gt(
        [load_frames(p) for p in args.testfiles], rig_config, pipe,
        limit=args.limit))


def cmd_reprojection_error(args) -> None:
    """Per-camera reprojection error of the lifter's and the triangulation
    backend's poses (reference test/reprojection_error.py)."""
    from mpe3d_tpu_torch.data.frames import load_eval_frames
    from mpe3d_tpu_torch.eval.runners import run_reprojection_error
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    rig_config, rig, pipe = build_pipeline(args, "mlp")
    tri = PoseEstimationPipeline(
        rig_config, rig, pipe.matcher, None, device=pipe.device,
        backend="triangulation", tri_variant=args.tri_variant)
    _print_report(run_reprojection_error(
        load_eval_frames(args.testfiles, rig_config, args.max_skeletons),
        rig_config, pipe, tri, datastep=args.datastep,
        max_skeletons=args.max_skeletons, show_gt=args.showgt))


def cmd_merge_jsons(args) -> None:
    from mpe3d_tpu_torch.data.frames import merge_frame_files
    n = merge_frame_files(args.inputs, args.output)
    print(f"wrote {n} frames to {args.output}")


def cmd_generate_synthetic(args) -> None:
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                generate_single_person_frames,
                                                write_frames)

    rig_config, rig = load_rig(args)
    if args.single_person:
        frames = generate_single_person_frames(rig_config, rig, args.frames,
                                               seed=args.seed)
    else:
        frames = generate_frames(rig_config, rig, args.frames,
                                 n_people=(args.min_people, args.max_people),
                                 seed=args.seed, with_gt=not args.no_gt)
    write_frames(frames, args.output)
    print(f"wrote {len(frames)} frames to {args.output}")


def cmd_train_lifter(args) -> None:
    """Self-supervised lifter training into ``--modelsdir``
    (``train/lifter.py``); ``--resume`` continues from its checkpoint."""
    from mpe3d_tpu_torch.checkpoint import (checkpoint_exists,
                                            load_lifter_checkpoint,
                                            read_meta,
                                            read_optimizer_leaves)
    from mpe3d_tpu_torch.config import LifterTrainConfig
    from mpe3d_tpu_torch.geometry.camera import load_rig_npz, save_rig_npz
    from mpe3d_tpu_torch.train.lifter import train_lifter
    from mpe3d_tpu_torch.train.lifter_data import (
        build_lifter_dataset_from_files)

    if args.ckpt_backend == "orbax":
        _refuse("--ckpt-backend orbax", "orbax checkpoints, ROADMAP.md "
                "section 1, item 8")
    device = "cpu" if args.cpu else "cuda"
    rig_config, rig = load_rig(args)
    tcfg = LifterTrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                             optimise_matrices=args.optimise_matrices,
                             seed=args.seed, loss=args.loss,
                             checkpoint_backend=args.ckpt_backend,
                             ema_decay=args.ema,
                             compute_dtype=args.compute_dtype)
    ckpt_path = os.path.join(args.modelsdir, "pose_estimator")
    refined_rig_path = os.path.join(args.modelsdir, "refined_rig.npz")
    if args.resume:
        # checked before the dataset build: a bad resume fails at once
        if not checkpoint_exists(ckpt_path):
            sys.exit(f"--resume: no checkpoint at {ckpt_path} (.npz or "
                     f".orbax/) -- drop --resume to train fresh")
        if not os.path.exists(ckpt_path + ".npz"):
            _refuse(f"resuming the orbax checkpoint {ckpt_path}.orbax",
                    "orbax checkpoints, ROADMAP.md section 1, item 8")
        meta = read_meta(ckpt_path)
        if meta.get("stored"):
            sys.exit(f"{ckpt_path} is a serving-only export (stored="
                     f"{meta.get('stored')}) -- it has no fp32 master "
                     f"weights to resume from")
        ck_prior = meta.get("prior", "mean")
        if ck_prior != args.prior:
            sys.exit(f"{ckpt_path} was trained with prior={ck_prior}; pass "
                     f"--prior {ck_prior} or use a fresh --modelsdir")
        if os.path.exists(refined_rig_path):
            # the loaded weights co-adapted to the refined calibration
            rig = load_rig_npz(refined_rig_path)
            print(f"[mpe3d_torch] resuming with refined calibration "
                  f"{refined_rig_path}", file=sys.stderr)
    net_t, err_t = build_lifter_dataset_from_files(
        args.trainset, rig_config, rig, cache=args.cache, prior=args.prior,
        device=device)
    net_d, err_d = build_lifter_dataset_from_files(
        args.devset, rig_config, rig, cache=args.cache, prior=args.prior,
        device=device)
    print(f"dataset length: {len(net_t)} (dev {len(net_d)})")
    lcfg = LifterConfig(in_dim=rig_config.lifter_input_dim,
                        out_dim=rig_config.n_joints * 3,
                        residual_prior=args.residual_prior)
    params = opt_state = None
    if args.resume:
        # the architecture recorded in the meta overrides the flags
        params, lcfg, _ = load_lifter_checkpoint(ckpt_path, lcfg)
        opt_state = read_optimizer_leaves(ckpt_path)
        meta = read_meta(ckpt_path)
        print(f"resuming from {ckpt_path} (epoch {meta.get('epoch')}, "
              f"val {meta.get('val_loss')}, "
              f"opt_state={'yes' if opt_state is not None else 'no'})")
    res = train_lifter(net_t, err_t, net_d, err_d, rig_config, rig, lcfg,
                       tcfg, checkpoint_path=ckpt_path, params=params,
                       opt_state=opt_state,
                       extra_meta={"prior": args.prior}, device=device)
    print(f"best dev loss {res.best_val_loss:.6f} after {res.epochs_run} "
          f"epochs \u2192 {ckpt_path} [{tcfg.checkpoint_backend}]")
    if res.rig is not None:
        save_rig_npz(refined_rig_path, res.rig)
        print(f"refined calibration (--optimise-matrices) \u2192 "
              f"{refined_rig_path}")
    elif not args.resume and os.path.exists(refined_rig_path):
        # a fresh run trained against the original rig: a refined
        # calibration left in this directory would be paired with it
        os.remove(refined_rig_path)
        print(f"[mpe3d_torch] removed stale {refined_rig_path} (this run "
              f"did not refine the calibration)", file=sys.stderr)


def cmd_train_matcher(args) -> None:
    """Matcher training into ``--modelsdir`` (``train/matcher.py``) on
    composites of the single-person ``--trainset`` files, early-stopped on
    ``--devset``'s; ``--device-synth`` synthesises the training scenes on
    the device each epoch (``train/matcher_synth.py``); ``--resume``
    continues from the checkpoint (its architecture overrides the
    default); ``--testset`` prints the trained matcher's MSE on its
    scenes, the mean over batches weighted by their sizes."""
    import torch

    from mpe3d_tpu_torch.checkpoint import (checkpoint_exists,
                                            load_matcher_checkpoint,
                                            read_meta,
                                            read_optimizer_leaves)
    from mpe3d_tpu_torch.config import MatcherTrainConfig
    from mpe3d_tpu_torch.data.frames import load_frames
    from mpe3d_tpu_torch.matching.features import build_topology
    from mpe3d_tpu_torch.train.matcher import (MatcherObjective,
                                               scene_tensors, train_matcher)
    from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes
    from mpe3d_tpu_torch.weights import trainable_matcher_from_tree

    if args.ckpt_backend == "orbax":
        _refuse("--ckpt-backend orbax", "orbax checkpoints, ROADMAP.md "
                "section 1, item 8")
    device = "cpu" if args.cpu else "cuda"
    out = os.path.join(args.modelsdir, "skeleton_matching")
    if args.resume:
        # checked before the scenes are built: a bad resume fails at once
        if not checkpoint_exists(out):
            sys.exit(f"--resume: no checkpoint at {out} (.npz or .orbax/) "
                     f"-- drop --resume to train fresh")
        if not os.path.exists(out + ".npz"):
            _refuse(f"resuming the orbax checkpoint {out}.orbax",
                    "orbax checkpoints, ROADMAP.md section 1, item 8")
    rig_config, rig = load_rig(args)
    topo = build_topology(rig_config.n_matching_cameras, args.slots)
    tcfg = MatcherTrainConfig(epochs=args.epochs, limit=args.limit,
                              batch_size=args.batch_size, seed=args.seed,
                              checkpoint_backend=args.ckpt_backend)
    cfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    train = bank = None
    if args.device_synth:
        from mpe3d_tpu_torch.train.matcher_synth import build_scene_bank
        bank = build_scene_bank([load_frames(p) for p in args.trainset],
                                rig_config)
        print(f"device-synth bank: {bank.kp.shape[0]} frames, "
              f"{bank.aug_frame.shape[0]} augmented entries; {tcfg.limit} "
              f"scenes/epoch synthesized on device")
    else:
        train = build_matcher_scenes([load_frames(p) for p in args.trainset],
                                     rig_config, topo, limit=tcfg.limit,
                                     seed=tcfg.seed)
    dev = build_matcher_scenes([load_frames(p) for p in args.devset],
                               rig_config, topo, limit=tcfg.limit,
                               seed=tcfg.seed + 1)
    print(f"train scenes: "
          f"{'on-device synth' if bank is not None else len(train)}, "
          f"dev scenes: {len(dev)}")
    params = opt_state = None
    if args.resume:
        params, cfg = load_matcher_checkpoint(out, cfg)
        opt_state = read_optimizer_leaves(out)
        meta = read_meta(out)
        print(f"resuming from {out} (epoch {meta.get('epoch')}, "
              f"val {meta.get('val_loss')}, "
              f"opt_state={'yes' if opt_state is not None else 'no'})")
    res = train_matcher(train, dev, rig_config, rig, topo, cfg, tcfg,
                        checkpoint_path=out, params=params,
                        opt_state=opt_state, synth_bank=bank, device=device)
    print(f"best dev loss {res.best_val_loss:.6f} after {res.epochs_run} "
          f"epochs \u2192 {out} [{tcfg.checkpoint_backend}]")
    if args.testset:
        test = build_matcher_scenes([load_frames(p) for p in args.testset],
                                    rig_config, topo, limit=tcfg.limit,
                                    seed=tcfg.seed + 2)
        obj = MatcherObjective(
            rig.select(rig_config.matching_camera_indices()), rig_config,
            topo, cfg, device)
        model = trainable_matcher_from_tree(res.params, cfg, device)
        losses, sizes = [], []
        with torch.no_grad():
            for i in range(0, len(test), tcfg.batch_size):
                idx = np.arange(i, min(i + tcfg.batch_size, len(test)))
                losses.append(obj.loss(model, scene_tensors(test, device,
                                                            idx)))
                sizes.append(len(idx))
        mse = (float(np.average(torch.stack(losses).cpu().numpy(),
                                weights=sizes)) if sizes else float("nan"))
        print(f"MSE for the test set {mse:.6f}")


def cmd_convert_torch(args) -> None:
    """The reference's torch files -> npz checkpoints in ``--modelsdir``
    (``convert/torch_import.py``)."""
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.convert.torch_import import (load_reference_lifter,
                                                      load_reference_matcher)

    if args.lifter:
        params, cfg = load_reference_lifter(args.lifter)
        out = os.path.join(args.modelsdir, "pose_estimator")
        save_checkpoint(out, params, meta={"lifter_config": cfg,
                                           "source": args.lifter})
        print(f"wrote {out}.npz")
    if args.matcher:
        params, cfg = load_reference_matcher(args.matcher, args.prms)
        out = os.path.join(args.modelsdir, "skeleton_matching")
        save_checkpoint(out, params, meta={"matcher_config": cfg,
                                           "source": args.matcher})
        print(f"wrote {out}.npz")


def _npz_or_refuse(stem: str) -> bool:
    """Whether ``<stem>.npz`` exists; an orbax checkpoint there instead is
    refused."""
    from mpe3d_tpu_torch.checkpoint import checkpoint_exists
    if checkpoint_exists(stem) and not os.path.exists(stem + ".npz"):
        _refuse(f"the orbax checkpoint {stem}.orbax", "orbax checkpoints, "
                "ROADMAP.md section 1, item 8")
    return os.path.exists(stem + ".npz")


def cmd_export_torch(args) -> int:
    """The inverse of convert-torch: the npz checkpoints of ``--modelsdir``
    as the reference's torch files in ``--out``
    (``convert/torch_export.py``), which the reference's torch/DGL stack
    loads.  A bf16 serving export's lifter goes out as the fp32 values of
    its bf16 weights (exact); an int8 one is not exported."""
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint,
                                            read_meta)
    from mpe3d_tpu_torch.convert.torch_export import (export_reference_lifter,
                                                      export_reference_matcher)

    rig_config = get_rig(args.rig)
    os.makedirs(args.out, exist_ok=True)
    j = os.path.join
    wrote = []
    mstem = j(args.modelsdir, "skeleton_matching")
    if _npz_or_refuse(mstem):
        mtree, mcfg = load_matcher_checkpoint(
            mstem, MatcherConfig(in_dim=rig_config.matcher_feature_dim))
        export_reference_matcher(mtree, mcfg,
                                 j(args.out, "skeleton_matching.tch"),
                                 j(args.out, "skeleton_matching.prms"))
        wrote += ["skeleton_matching.tch", "skeleton_matching.prms"]
    lstem = j(args.modelsdir, "pose_estimator")
    if _npz_or_refuse(lstem):
        stored = read_meta(lstem).get("stored")
        ltree, lcfg, _ = load_lifter_checkpoint(
            lstem, LifterConfig(in_dim=rig_config.lifter_input_dim,
                                out_dim=rig_config.n_joints * 3))
        try:
            if stored == "int8":
                raise ValueError("an int8 serving export has no fp32 "
                                 "weights")
            if stored == "bf16":        # bf16 values are exact in fp32
                ltree = {"layers": [{"w": layer["w"].float().numpy(),
                                     "b": layer["b"]}
                                    for layer in ltree["layers"]]}
            export_reference_lifter(ltree, j(args.out,
                                             "pose_estimator.pytorch"),
                                    cfg=lcfg)
            wrote.append("pose_estimator.pytorch")
        except ValueError as e:
            print(f"[mpe3d_torch] lifter not exported: {e}", file=sys.stderr)
    if not wrote:
        print(f"[mpe3d_torch] no npz checkpoints in {args.modelsdir}",
              file=sys.stderr)
        return 1
    print(f"wrote {', '.join(wrote)} to {args.out}")
    return 0


def cmd_export_servable(args) -> int:
    """A serving-only models directory in ``--out``: the matcher
    (``skeleton_matching.npz/.json``) and a refined calibration copied as
    they are, the lifter stored ``--dtype int8`` (the weight-only
    quantisation of ``models/mlp.py::quantize_lifter_weights``) or ``bf16``
    (the weights rounded to nearest even, stored as their uint16 bit
    patterns), meta ``"stored"`` set.  Serving reads it; an export is not
    exported again, and ``train-lifter --resume`` refuses it."""
    import torch

    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            read_meta, save_checkpoint)
    from mpe3d_tpu_torch.models.mlp import (lifter_is_quantized,
                                            quantize_lifter_weights)

    rig_config = get_rig(args.rig)
    j = os.path.join
    _npz_or_refuse(j(args.modelsdir, "skeleton_matching"))
    lpath = j(args.modelsdir, "pose_estimator")
    if not _npz_or_refuse(lpath):
        print(f"[mpe3d_torch] no lifter checkpoint in {args.modelsdir}",
              file=sys.stderr)
        return 1
    lmeta = read_meta(lpath)
    if lmeta.get("stored"):
        sys.exit(f"{lpath} is already a serving export "
                 f"(stored={lmeta['stored']})")
    os.makedirs(args.out, exist_ok=True)
    wrote = []
    for name in ("skeleton_matching.npz", "skeleton_matching.json",
                 "refined_rig.npz"):
        src = j(args.modelsdir, name)
        if os.path.exists(src):
            shutil.copy2(src, j(args.out, name))
            wrote.append(name)
    ltree, _, _ = load_lifter_checkpoint(
        lpath, LifterConfig(in_dim=rig_config.lifter_input_dim,
                            out_dim=rig_config.n_joints * 3))
    tree = {"layers": [{k: torch.from_numpy(np.asarray(v, np.float32))
                        for k, v in layer.items()}
                       for layer in ltree["layers"]]}
    if args.dtype == "int8":
        tree = quantize_lifter_weights(tree)
        assert lifter_is_quantized(tree)
        layers = [{k: v.numpy() for k, v in layer.items()}
                  for layer in tree["layers"]]
    else:
        # npz holds no bfloat16: the bit patterns go in as uint16
        layers = [{"w": layer["w"].to(torch.bfloat16).view(torch.int16)
                   .numpy().view(np.uint16), "b": layer["b"].numpy()}
                  for layer in tree["layers"]]
    meta = {k: v for k, v in lmeta.items() if k != "epoch"}
    meta["stored"] = args.dtype
    save_checkpoint(j(args.out, "pose_estimator"), {"layers": layers},
                    meta=meta)
    wrote += ["pose_estimator.npz", "pose_estimator.json"]
    total = sum(os.path.getsize(j(args.out, n)) for n in wrote)
    print(f"wrote {', '.join(wrote)} to {args.out} ({total / 1e6:.1f} MB, "
          f"lifter stored {args.dtype})")
    return 0


# commands of the JAX command line that later slices port
REFUSED_COMMANDS = {
    "show-results": "the viewers, ROADMAP.md section 1, item 9",
    "convert-panoptic": "conversion, ROADMAP.md section 1, item 9",
}


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


def _add_common(p, models: bool = True, backend: bool = True) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU through the kernels' plain versions "
                   "(default: the CUDA card; without one the command "
                   "fails)")
    p.add_argument("--rig", default="PANOPTIC",
                   help="rig preset name: PANOPTIC or ARPLAB (any case)")
    p.add_argument("--tm", default=None,
                   help="calibration file (pytransform3d pickle or JSON)")
    if not models:
        return
    p.add_argument("--modelsdir", default="./models",
                   help="directory with the npz checkpoints")
    if backend:
        p.add_argument("--backend", choices=("mlp", "triangulation"),
                       default="mlp", help="3D backend: the learned lifter "
                       "or the classical triangulation (eager path)")
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
        "serve, infer, evaluate, train and convert models")
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
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the inference "
                   "(Chrome trace JSON) into DIR")
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

    for name, fn in (("metrics-from-model", cmd_metrics_from_model),
                     ("metrics-from-triangulation",
                      cmd_metrics_from_triangulation),
                     ("sm-metrics", cmd_sm_metrics)):
        p = sub.add_parser(name, help=name.replace("-", " "))
        _add_common(p, backend=False)
        p.add_argument("--testfiles", nargs="+", required=True)
        p.add_argument("--datastep", type=int, default=12)
        p.add_argument("--dataset-tm", default=None,
                       help="dataset calibration if GT is in another frame")
        p.add_argument("--fused", action="store_true",
                       help="infer_fused a frame (reports t_e2e_ms)")
        p.add_argument("--stream", type=int, default=0,
                       help="infer_stream with N frames in flight")
        p.add_argument("--device-decode", action="store_true",
                       help="staged path: decode on the device")
        p.add_argument("--dedup-gt", action="store_true",
                       help="drop duplicated GT rows before scoring "
                       "(data/frames.py::dedup_ground_truth); default: "
                       "the reference's raw protocol")
        if name == "sm-metrics":
            p.add_argument("--unassigned", default="lump",
                           choices=["lump", "singleton"],
                           help="label of heads the decode left "
                           "unassigned: 'lump' (the reference protocol, "
                           "one shared label) or 'singleton' (one each)")
        p.set_defaults(fn=fn)

    p = sub.add_parser("sm-metrics-without-gt",
                       help="GT-free matching quality")
    _add_common(p, backend=False)
    p.add_argument("--testfiles", nargs="+", required=True)
    p.add_argument("--limit", type=int, default=1000)
    p.set_defaults(fn=cmd_sm_metrics_without_gt)

    p = sub.add_parser("reprojection-error",
                       help="per-camera reprojection error")
    _add_common(p, backend=False)
    p.add_argument("--testfiles", nargs="+", required=True)
    p.add_argument("--datastep", type=int, default=1)
    p.add_argument("--showgt", action="store_true",
                   help="also reproject GT 3D when frames carry it")
    p.set_defaults(fn=cmd_reprojection_error)

    p = sub.add_parser("merge-jsons", help="concatenate wire files")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    p.set_defaults(fn=cmd_merge_jsons, needs_device=False)

    p = sub.add_parser("generate-synthetic",
                       help="synthetic wire frames of the rig")
    _add_common(p, models=False)
    p.add_argument("--output", required=True)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--single-person", action="store_true")
    p.add_argument("--min-people", type=int, default=1)
    p.add_argument("--max-people", type=int, default=4)
    p.add_argument("--no-gt", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_generate_synthetic, needs_device=False)

    p = sub.add_parser("train-lifter", help="self-supervised lifter "
                       "training into --modelsdir")
    _add_common(p, backend=False)
    p.add_argument("--trainset", nargs="+", required=True)
    p.add_argument("--devset", nargs="+", required=True)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=2096)
    p.add_argument("--optimise-matrices", action="store_true",
                   help="refine the rig's T_wc, K and dist with the lifter; "
                   "writes refined_rig.npz")
    p.add_argument("--cache", action="store_true",
                   help="cache packed datasets next to the last input file")
    p.add_argument("--seed", type=int, default=58008)
    p.add_argument("--resume", action="store_true",
                   help="resume the weights (and the optimizer state where "
                   "the checkpoint holds it) from --modelsdir")
    p.add_argument("--loss", default="reference",
                   choices=["reference", "per_term", "huber"],
                   help="reprojection-loss kind (lifting/loss.py)")
    p.add_argument("--prior", default="mean",
                   choices=["mean", "median", "irls"],
                   help="triangulated prior of the lifter input; recorded "
                   "in the checkpoint, read back at inference")
    p.add_argument("--residual-prior", action="store_true",
                   help="predict a correction to the triangulated prior "
                   "(zero head at the start); recorded in the checkpoint")
    p.add_argument("--ckpt-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="checkpoint format: npz (orbax is refused)")
    p.add_argument("--ema", type=float, default=0.0,
                   help="EMA weight-averaging decay (0 = off)")
    p.add_argument("--compute-dtype", default="fp32",
                   choices=["fp32", "bf16"],
                   help="training matmul operands: fp32, or bf16 with "
                   "fp32 sums and fp32 master weights")
    p.set_defaults(fn=cmd_train_lifter)

    p = sub.add_parser("train-matcher", help="matcher training into "
                       "--modelsdir")
    _add_common(p, backend=False)
    p.add_argument("--trainset", nargs="+", required=True)
    p.add_argument("--devset", nargs="+", required=True)
    p.add_argument("--testset", nargs="*", default=[])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=15)
    p.add_argument("--limit", type=int, default=120000)
    p.add_argument("--slots", type=int, default=4,
                   help="skeleton slots per camera in training scenes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume the weights and the optimizer state from "
                   "the --modelsdir checkpoint (the reference can only "
                   "save)")
    p.add_argument("--ckpt-backend", default="npz",
                   choices=["npz", "orbax"],
                   help="checkpoint format: npz (orbax is refused)")
    p.add_argument("--device-synth", action="store_true",
                   help="synthesise the training composites on the device "
                   "each epoch (train/matcher_synth.py) instead of "
                   "building --limit scenes on the host; the dev set stays "
                   "host-built")
    p.set_defaults(fn=cmd_train_matcher)

    p = sub.add_parser("convert-torch", help="the reference's torch files "
                       "-> npz checkpoints")
    p.add_argument("--lifter", default=None,
                   help="path to pose_estimator.pytorch")
    p.add_argument("--matcher", default=None,
                   help="path to skeleton_matching.tch")
    p.add_argument("--prms", default=None,
                   help="path to skeleton_matching.prms")
    p.add_argument("--modelsdir", default="./models")
    p.set_defaults(fn=cmd_convert_torch, needs_device=False)

    p = sub.add_parser("export-torch", help="npz checkpoints -> the "
                       "reference's torch files")
    p.add_argument("--modelsdir", default="./models",
                   help="directory with the npz checkpoints")
    p.add_argument("--out", required=True,
                   help="directory for the reference-format torch files")
    p.add_argument("--rig", default="PANOPTIC")
    p.set_defaults(fn=cmd_export_torch, needs_device=False)

    p = sub.add_parser("export-servable", help="a serving-only models "
                       "directory (int8 or bf16 lifter)")
    p.add_argument("--modelsdir", default="./models",
                   help="directory with the npz checkpoints")
    p.add_argument("--out", required=True,
                   help="output directory of the servable export")
    p.add_argument("--dtype", choices=("int8", "bf16"), default="int8",
                   help="stored lifter weights: int8 (weight-only, "
                   "per-channel and per-row scales) or bf16")
    p.add_argument("--rig", default="PANOPTIC")
    p.set_defaults(fn=cmd_export_servable, needs_device=False)

    for name in REFUSED_COMMANDS:
        sub.add_parser(name, help="not ported: refused")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in REFUSED_COMMANDS:
        _refuse(f"the {argv[0]} command", REFUSED_COMMANDS[argv[0]])
    args = make_parser().parse_args(argv)
    if getattr(args, "needs_device", True) and not args.cpu:
        import torch
        if not torch.cuda.is_available():
            sys.exit("mpe3d_tpu_torch: no CUDA device is available; the "
                     "port serves on the card, or on the CPU through the "
                     "kernels' plain versions with --cpu")
    return args.fn(args) or 0
