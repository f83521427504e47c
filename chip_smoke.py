#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its wall time; any
failure raises, and the script exits non-zero):

1. env: torch/CUDA versions, the card's name and power limit.
2. build: the one ``nvcc`` call that builds the CUDA kernels of
   ``mpe3d_tpu_torch/csrc`` (0 s when the build cache matches).
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the serving path gives it (Panoptic rig, S=4 slots, P=8
   persons), with median times over 50 launches (CUDA events) beside the
   plain version's, the card's bound and a PyTorch yardstick where one
   exists.  The decode + gather + pack kernel is checked for every prior
   (mean, median, IRLS) with and without the prior gate.
4. main path: ``PoseEstimationPipeline.infer_fused`` on 16 synthetic frames
   on the card, once with the trained matcher and once with a numpy-seeded
   random matcher (the trained one scores near 0 on the synthetic ring rig;
   the random one marks every present pair, so decode, gather, pack and the
   lifter run on live persons); each through the frame path (the default:
   GAT kernel, decode + gather + pack kernel, lifter kernel) and through the
   eager path (``use_frame_kernel=False``).  Checks the kernels' launch
   counts in each run, that outputs are finite, and that persons, scores
   and poses agree with the same path on the CPU (plain versions); runs
   ``submit_fused`` of the frame path once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
   prints each path's median frame time and the frame path's per-stage
   times and device busy share.

The last lines are the kernel table as one JSON object and the contract
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, the script fails before printing any
result.  Imports only torch, numpy, the standard library and
``mpe3d_tpu_torch``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(ROOT, "models_demo", "pan_irls_bf16")

N_FRAMES, N_WARMUP, N_TIMED = 16, 3, 50
RANDOM_MATCHER_SEED = 0    # its scores sit above the 0.5 threshold

# H100 SXM peaks from NVIDIA's data sheet (dense, without sparsity)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12

# Tolerances, kernel against its plain version on the card:
#  * GAT logits: the same fp32 arithmetic summed in another order; 1e-6
#    relative per layer, bounded here at 1e-4 x (1 + |logit|).
#  * one MLP layer on the same input: fp32 sums of exact bf16 products in
#    another order, bounded at 1e-5 x max(1, max |output|).
#  * the whole 9-layer MLP: a last-bit fp32 difference flips the bf16
#    rounding of a later layer's operand (2^-8 relative), and the flips
#    cascade through the layers; 5e-3 decameters bounds that cascade.
GAT_RTOL = 1e-4
MLP_LAYER_TOL = 1e-5
MLP_NET_TOL = 5e-3
# decode + gather + pack kernel against its plain version on the same
# inputs: persons, masks and gathered observations exactly equal; fields 0-9
# within 1e-5 (the same fp32 formulas, FMA contraction on the card); prior
# fields 11-13 within 1e-4 decameters (iterated fp32 geometry, sums in
# another order); ok flags (field 10) equal except for joints whose gate
# residual lies within 1e-3 px of the gate, which are counted
FIELD_TOL, PRIOR_TOL, GATE_NEAR_PX = 1e-5, 1e-4, 1e-3
# main path on the card against the CPU: scores 1e-4 (fp32 GAT and features,
# summed in other orders by the card's kernels and the CPU's; 9.3e-6 seen
# with the trained matcher); poses 1e-2 m (the lifter's bf16 rounding
# cascade above, times 10 for metres)
SCORE_TOL = 1e-4
POSE_TOL_M = 1e-2


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.1f} s)", flush=True)


def median_ms(fn, n: int = N_TIMED) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def load_trees(rig_config):
    """Trained matcher and lifter trees of models_demo/pan_irls_bf16, their
    configs and the lifter's prior."""
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)
    from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(DEMO, "skeleton_matching"),
        MatcherConfig(in_dim=rig_config.matcher_feature_dim))
    ltree, lcfg, prior = load_lifter_checkpoint(
        os.path.join(DEMO, "pose_estimator"),
        LifterConfig(in_dim=rig_config.lifter_input_dim,
                     out_dim=rig_config.n_joints * 3))
    return mtree, mcfg, ltree, lcfg, prior


def gat_costs(x, n_weights, dims, E, D):
    """(bytes, flops) the GAT stack must move and compute for one frame:
    inputs read once (features, weights, pair weights, topology), logits
    written once; the fc products, attention terms and both softmaxes."""
    N = x.shape[0]
    bytes_ = 4 * (x.numel() + n_weights + E + 2 * E + (N - E) * D) + 4 * E
    flops = 0
    for l, (d_in, d, nh) in enumerate(dims):
        F = nh * d
        flops += 2 * N * (d_in * d_in + d_in * F) + 4 * N * F   # fc + attn
        flops += E * F * 6                                      # edge out
        if l < len(dims) - 1:
            flops += 2 * E * F * 2                              # head sums
    return bytes_, flops


def check_kernels(pipe, frame, report):
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, gat_kernel

    x_all, pw, gtopo, nets = pipe.stage_inputs(frame)
    m = pipe.matcher
    args = (x_all, pw, gtopo, m.flat, m.dims, m.cfg.alpha,
            m.cfg.hidden_slope)
    got = gat_kernel.gat_stack(*args)
    ref = gat_kernel.gat_stack_plain(*args)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > GAT_RTOL * (1 + ref.abs())).any()):
        raise AssertionError(f"GAT kernel disagrees with its plain version: "
                             f"max |d logit| {float(err.max()):.3g}")
    bytes_, flops = gat_costs(x_all, m.flat.numel(), m.dims, gtopo.n_pairs,
                              gtopo.inc.shape[1])
    report.append({
        "name": "gat_stack", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/gat_stack.cu",
        "replaces": "mpe3d_tpu/ops/gat_kernel.py:206",
        "launches": 0, "max_abs_err": float(err.max()),
        "ms": median_ms(lambda: gat_kernel.gat_stack(*args)),
        "plain_ms": median_ms(lambda: gat_kernel.gat_stack_plain(*args)),
        "bound_ms": 1e3 * max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS),
        "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S > flops / FP32_FLOPS
                     else "operations"),
        "library_ms": None})
    print(f"  gat_stack: H+E={x_all.shape[0]} rows, max |d logit| "
          f"{float(err.max()):.3g} (tol {GAT_RTOL:g} x (1+|logit|))")

    layers = pipe.lifter.packed_layers()
    slope, out_dim = pipe.lifter.cfg.negative_slope, pipe.lifter.cfg.out_dim
    h = nets.float().contiguous()
    for i, (w, b) in enumerate(layers):
        act = i < len(layers) - 1
        y = fused_mlp.mlp_layer(h, w, b, slope, act)
        y_ref = fused_mlp.mlp_layer_plain(h, w, b, slope, act)
        torch.cuda.synchronize()
        lerr = float((y - y_ref).abs().max())
        ltol = MLP_LAYER_TOL * max(1.0, float(y_ref.abs().max()))
        if not lerr <= ltol:
            raise AssertionError(f"MLP layer {i}: max err {lerr:.3g} > "
                                 f"{ltol:.3g}")
        h = y_ref
    got = fused_mlp.fused_mlp_forward(nets, layers, slope, out_dim)

    def plain_net():
        hp = nets.float()
        for i, (w, b) in enumerate(layers):
            hp = fused_mlp.mlp_layer_plain(hp, w, b, slope,
                                           i < len(layers) - 1)
        return hp[:, :out_dim]

    ref = plain_net()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
        raise AssertionError(f"MLP kernel disagrees with its plain version: "
                             f"max err {err:.3g} > {MLP_NET_TOL}")
    wb = [w.to(torch.bfloat16) for w, _ in layers]

    def library():
        hb = nets.to(torch.bfloat16)
        for w in wb:
            hb = torch.matmul(hb, w)
        return hb

    M = nets.shape[0]
    bytes_ = (4 * nets.numel() + 4 * M * out_dim
              + sum(w.numel() * 2 + b.numel() * 4 for w, b in layers))
    flops = sum(2 * M * w.shape[0] * w.shape[1] for w, _ in layers)
    report.append({
        "name": "mlp_bf16_layer", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "mpe3d_tpu/ops/fused_mlp.py:57",
        "launches": 0, "max_abs_err": err,
        "ms": median_ms(lambda: fused_mlp.fused_mlp_forward(
            nets, layers, slope, out_dim)),
        "plain_ms": median_ms(plain_net),
        "bound_ms": 1e3 * max(bytes_ / HBM_BYTES_PER_S,
                              flops / BF16_TENSOR_FLOPS),
        "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                     > flops / BF16_TENSOR_FLOPS else "operations"),
        "library_ms": median_ms(library)})
    print(f"  mlp: {M} rows x 9 layers, per-layer max err within "
          f"{MLP_LAYER_TOL:g} x max|out|; whole net max err {err:.3g} "
          f"(tol {MLP_NET_TOL:g} decameters)")
    for k in report[-2:]:
        print(f"  {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
              f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"library {k['library_ms']}")


def frame_costs(args, kw, out):
    """(bytes, operations) of one decode + gather + pack call: each input
    read once and each output written once; operations for what this
    frame's data needs, counted from the kernel's arithmetic: one compare
    per remaining pair in each of the n_live decode trips, H^2 for the
    member counts, and per (live person, used camera, joint) the 10-step
    undistortion (27 operations a step) and fields 0-9 (30), per (live
    person, joint) the prior (a pair triangulation with 2 refinements is
    380 operations; an IRLS solve 50 per camera + 60, 5 reweighting rounds
    30 per camera) and the gate (35 per camera)."""
    scores, pmask = args[0], args[1]
    E, Cu, J = scores.numel(), args[4].shape[0], args[4].shape[2]
    H = kw["n_cameras"] * args[4].shape[1]
    bytes_ = (sum(t.numel() * t.element_size() for t in args[:10])
              + sum(t.numel() * t.element_size() for t in out))
    eligible = int(((pmask > 0.5) & (scores > kw["threshold"])).sum())
    n_live = min(eligible, kw["k_cap"])
    n_pers = int(out.person_mask.sum())
    pairs = Cu * (Cu - 1) // 2
    per_joint = {"mean": pairs * 388,
                 "median": pairs * 388 + 3 * pairs * pairs,
                 "irls": 6 * (50 * Cu + 60) + 5 * 30 * Cu}[kw["prior"]]
    if kw["gate_px"] is not None:
        per_joint += 35 * Cu + 3 * Cu * Cu
    ops = (n_live * E + H * H + n_pers * Cu * J * (10 * 27 + 30)
           + n_pers * J * per_joint)
    return bytes_, ops


def compare_frame_outputs(got, ref, ref_ungated, kw, rig):
    """Kernel against plain outputs: exact fields, net bounds, ok flags
    (module header).  Returns (max |d| of the net where the ok flags
    agree, ok flags that differ, joints near the gate)."""
    import torch
    from mpe3d_tpu_torch.lifting.pack import gate_residual_px
    for name in ("persons", "person_mask", "kp", "valid", "observed"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"frame_decode_pack: {name} differs from "
                                 f"the plain version")
    P, Cu, J = ref.kp.shape[:3]
    g = got.net.view(P, Cu, J, 14)
    r = ref.net.view(P, Cu, J, 14)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("frame_decode_pack: non-finite net")
    flips = (g[..., 10] != r[..., 10]).any(1)                  # [P, J]
    near = torch.zeros_like(flips)
    if kw["gate_px"] is not None:
        xyz = ref_ungated.net.view(P, Cu, J, 14)[:, 0, :, 11:14] * 10.0
        resid = gate_residual_px(ref.kp, ref.observed, xyz, rig)
        near = (resid - kw["gate_px"]).abs() < GATE_NEAR_PX
    if bool((flips & ~near).any()):
        raise AssertionError(f"frame_decode_pack: {int(flips.sum())} ok "
                             f"flags differ, {int(near.sum())} joints near "
                             f"the gate")
    d09 = float((g[..., :10] - r[..., :10]).abs().max())
    keep = ~flips[:, None, :, None]
    dpr = float(((g[..., 11:] - r[..., 11:]).abs() * keep).max())
    if not (d09 <= FIELD_TOL and dpr <= PRIOR_TOL):
        raise AssertionError(f"frame_decode_pack: fields 0-9 max |d| "
                             f"{d09:.3g} (tol {FIELD_TOL}), prior fields "
                             f"{dpr:.3g} (tol {PRIOR_TOL})")
    return max(d09, dpr), int(flips.sum()), int(near.sum())


def check_frame_cases(args, kw, cases, label):
    """The decode + gather + pack kernel against its plain version on one
    input for each (prior, gate) case; returns the largest net error."""
    import torch
    from mpe3d_tpu_torch.ops import frame_kernel as fk
    rig = fk.rig_from_consts(args[8], args[9])
    max_err = 0.0
    for prior, gate in cases:
        k = dict(kw, prior=prior, gate_px=gate)
        got = fk.frame_decode_pack(*args, **k)
        ref = fk.frame_decode_pack_plain(*args, **k)
        ungated = fk.frame_decode_pack_plain(*args, **dict(k, gate_px=None))
        torch.cuda.synchronize()
        err, flips, near = compare_frame_outputs(got, ref, ungated, k, rig)
        max_err = max(max_err, err)
        print(f"  frame_decode_pack {label} prior={prior} gate={gate}: "
              f"persons {int(ref.person_mask.sum())}, persons/gathers "
              f"equal, net max |d| {err:.3g}, {flips} ok flags differ "
              f"({near} joints within {GATE_NEAR_PX} px of the gate)")
    return max_err


def consistency_scores(pipe, S, kp, observed, pmask):
    """A pair score field from geometry instead of the matcher [E]: two
    skeletons that triangulate with a small reprojection error over at
    least 3 shared joints score high, so the decode groups real people."""
    import torch
    from mpe3d_tpu_torch.geometry.camera import (project_points,
                                                 undistort_points)
    from mpe3d_tpu_torch.geometry.triangulate import triangulate_pair
    topo, ms, rig = pipe.topology(S), pipe._match_sel, pipe.match_rig
    kp, obs = kp[ms], observed[ms]
    e1, e2 = (torch.as_tensor(e, dtype=torch.long, device=kp.device)
              for e in (topo.e1, topo.e2))
    ends = ((e1 // S, e1 % S), (e2 // S, e2 % S))
    xn = undistort_points(kp, rig.K[:, None, None], rig.dist[:, None, None])
    Pm = rig.T_wc[:, :3, :]
    (c1, s1), (c2, s2) = ends
    X = triangulate_pair(xn[c1, s1], xn[c2, s2], Pm[c1][:, None],
                         Pm[c2][:, None])                       # [E, J, 3]
    err = sum(torch.linalg.norm(project_points(
        X, rig.T_wc[c][:, None], rig.K[c][:, None], rig.dist[c][:, None],
        min_depth=1e-4) - kp[c, s], dim=-1) for c, s in ends)
    both = (obs[c1, s1] & obs[c2, s2]).float()
    n = both.sum(1)
    return (torch.exp(-(err * both).sum(1) / n.clamp(min=1) / 60.0)
            * (n >= 3) * pmask)


def check_frame_kernel(pipe, frame, crowded_pipe, crowded_frame, report):
    """Phase 3, the decode + gather + pack kernel against its plain version,
    for every prior with and without the gate: on the serving bucket's
    random-matcher frame (timed at the pipeline's own prior and gate), and
    on a crowded S=16 frame (E=2560 pairs, P=16 rows) scored by geometric
    consistency with every eligible pair decoded.  The crowded frame is not
    scored by the random matcher: it groups unrelated skeletons at S=16,
    and IRLS on such groups is ill-conditioned (the plain version's prior
    moved 0.047 decameters under a 1e-7 relative change of the pixels),
    so no fp32 tolerance holds there."""
    import torch
    from mpe3d_tpu_torch.ops import frame_kernel as fk

    cases = [(p, g) for p in fk.PRIORS for g in (None, 8.0)]
    args, kw = pipe.frame_stage_inputs(frame)
    max_err = check_frame_cases(args, kw, cases, "S=4")
    # scores on a grid of eighths: exact ties, which go to the lower pair
    tied = (torch.round(args[0] * 8) / 8,) + args[1:]
    check_frame_cases(tied, kw, [(kw["prior"], kw["gate_px"])],
                      "S=4, tied scores")
    with torch.inference_mode():
        S, bufs = crowded_pipe._frame_tensors(crowded_frame)
        pmask = crowded_pipe._match_inputs(S, *bufs)[1]
        scores = consistency_scores(crowded_pipe, S, bufs[0], bufs[3], pmask)
        cargs, ckw = crowded_pipe._frame_decode_args(S, scores, pmask,
                                                     *bufs[:4])
    ckw["k_cap"] = scores.numel()
    check_frame_cases(cargs, ckw, cases,
                      f"S=16 (E={scores.numel()}, P={ckw['P']})")
    print(f"  frame_decode_pack S=16 ({ckw['prior']}, gate "
          f"{ckw['gate_px']}): "
          f"{median_ms(lambda: fk.frame_decode_pack(*cargs, **ckw)):.4f} "
          f"ms, plain "
          f"{median_ms(lambda: fk.frame_decode_pack_plain(*cargs, **ckw)):.4f}"
          f" ms")
    out = fk.frame_decode_pack(*args, **kw)
    bytes_, ops = frame_costs(args, kw, out)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS
    report.append({
        "name": "frame_decode_pack", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/frame_decode_pack.cu",
        "replaces": "mpe3d_tpu/ops/frame_kernel.py:358",
        "launches": 0, "max_abs_err": max_err,
        "ms": median_ms(lambda: fk.frame_decode_pack(*args, **kw)),
        "plain_ms": median_ms(lambda: fk.frame_decode_pack_plain(*args,
                                                                 **kw)),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None})
    k = report[-1]
    print(f"  frame_decode_pack S=4 ({kw['prior']}, gate {kw['gate_px']}): "
          f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
          f"{k['bound_ms']:.6f} ms ({k['bound_by']}: {bytes_} bytes, {ops} "
          f"operations), library None")


def reset_launches():
    from mpe3d_tpu_torch.ops import fused_mlp, frame_kernel, gat_kernel
    gat_kernel.gat_stack.launches = 0
    frame_kernel.frame_decode_pack.launches = 0
    fused_mlp.mlp_layer.launches = 0


def read_launches():
    from mpe3d_tpu_torch.ops import fused_mlp, frame_kernel, gat_kernel
    return {"gat_stack": gat_kernel.gat_stack.launches,
            "frame_decode_pack": frame_kernel.frame_decode_pack.launches,
            "mlp_bf16_layer": fused_mlp.mlp_layer.launches}


def check_no_host_sync(gpu, frame):
    """The frame path's submit_fused (upload, the three kernels, the
    epilogue) raises if anything on it synchronises with the host."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ticket = gpu.submit_fused(frame)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gpu.collect_fused(ticket)


def run_main_path(gpu, cpu, frames, label):
    """Phase 4 for one matcher and one path: counters, finiteness, CPU
    agreement.  Returns the launches and the median frame ms."""
    import numpy as np
    import torch

    frame_path = gpu.frame_path_on()
    if frame_path != cpu.frame_path_on():
        raise AssertionError(f"{label}: the CPU reference runs another path")
    for f in frames[:N_WARMUP]:
        gpu.infer_fused(f)
    if frame_path:
        check_no_host_sync(gpu, frames[0])
    reset_launches()
    outs, times = [], []
    for f in frames:
        t0 = time.perf_counter()
        outs.append(gpu.infer_fused(f))
        times.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    n, n_layers = len(frames), gpu.lifter.n_layers
    want = {"gat_stack": n, "frame_decode_pack": n if frame_path else 0,
            "mlp_bf16_layer": n_layers * n}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected "
                             f"{want}")
    near, max_dp, max_ds = 0, 0.0, 0.0
    for i, (f, o) in enumerate(zip(frames, outs)):
        r = cpu.infer_fused(f)
        for a in (o.poses, o.scores, o.quality):
            if not np.isfinite(a).all():
                raise AssertionError(f"{label} frame {i}: non-finite output")
        near += int((np.abs(r.scores - gpu.threshold) < 1e-5).sum())
        if not np.array_equal(o.persons, r.persons):
            raise AssertionError(f"{label} frame {i}: persons differ from "
                                 f"the CPU run:\n{o.persons}\n{r.persons}")
        max_ds = max(max_ds, float(np.abs(o.scores - r.scores).max()))
        if len(o.poses):
            max_dp = max(max_dp, float(np.abs(o.poses - r.poses).max()))
    if max_ds > SCORE_TOL or max_dp > POSE_TOL_M:
        raise AssertionError(f"{label}: max |d score| {max_ds:.3g} (tol "
                             f"{SCORE_TOL}), max |d pose| {max_dp:.3g} m "
                             f"(tol {POSE_TOL_M})")
    torch.cuda.synchronize()
    ms = statistics.median(times)
    print(f"  {label}: persons per frame {[len(o.persons) for o in outs]}, "
          f"launches {launches}"
          + ("; submit_fused raised no sync error under "
             "set_sync_debug_mode('error')" if frame_path else "")
          + f"; vs CPU: persons equal, max |d score| {max_ds:.3g}, max "
          f"|d pose| {max_dp:.3g} m, {near} scores within 1e-5 of the "
          f"threshold")
    print(f"  {label}: median frame {ms:.3f} ms (host clock, "
          f"{len(frames)} frames)", flush=True)
    return launches, ms


def frame_stage_times(pipe, frame):
    """Host ms of each stage of one frame-path frame, each stage ended by a
    device synchronize (mirrors PoseEstimationPipeline._run_frame)."""
    import torch
    from mpe3d_tpu_torch.ops.frame_kernel import frame_decode_pack
    from mpe3d_tpu_torch.pipeline import pose_quality_px

    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = 1e3 * (now - t)
        t = now

    with torch.inference_mode():
        S, args = pipe._frame_tensors(frame)
        mark("upload")
        x_all, pmask = pipe._match_inputs(S, *args)
        mark("features")
        gtopo = pipe._bucket_state(S)[1]
        scores = torch.sigmoid(pipe.matcher(x_all, pmask, gtopo)) * pmask
        mark("gat")
        fargs, kw = pipe._frame_decode_args(S, scores, pmask, *args[:4])
        f = frame_decode_pack(*fargs, **kw)
        mark("decode_gather_pack")
        poses = pipe.lifter(f.net).reshape(kw["P"], -1, 3) * 10.0
        mark("lifter")
        q = pose_quality_px(poses, f.kp, f.valid, f.observed, pipe.used_rig)
        (poses * f.person_mask[:, None, None]).cpu(), q.cpu(), scores.cpu()
        mark("quality_download")
    return out


def busy_share(pipe, frames):
    """(wall ms, device ms) of the frames, unsynchronized, under
    torch.profiler: the device time of kernels and copies, each device
    event counted once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            pipe.infer_fused(f)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = sum(max(ev.device_time_total, ev.self_device_time_total)
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA) / 1e3
    return wall, dev


def stage_table(pipe, frames, label):
    """The frame path's per-stage medians and device busy share."""
    per = [frame_stage_times(pipe, f) for f in frames]
    stages = {k: statistics.median(p[k] for p in per) for k in per[0]}
    try:
        wall, dev = busy_share(pipe, frames)
        share = f"device {dev:.3f} ms of {wall:.3f} ms wall, busy share " \
                f"{dev / wall:.3f}"
    except Exception as exc:    # a measurement, not a check
        share = f"busy share not measured ({type(exc).__name__}: {exc})"
    print(f"  {label}, frame path stages (synchronized, median ms of "
          f"{len(frames)}): " + ", ".join(f"{k} {v:.3f}"
                                           for k, v in stages.items())
          + f"; {len(frames)} unsynchronized frames under the profiler: "
          + share, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.ops import _build
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase("env", t0, f"python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    lib = _build.library()
    spills = [ln.strip() for ln in lib.compiler_output.splitlines()
              if "spill" in ln and not ln.strip().startswith(
                  "0 bytes stack frame, 0 bytes spill")]
    phase("build", t0, f"nvcc {lib.build_seconds:.1f} s; ptxas: "
          + ("; ".join(spills) if spills else "no spills"))

    t0 = time.perf_counter()
    rig_config = PANOPTIC
    rig = synthetic_ring_rig(rig_config)
    mtree, mcfg, ltree, lcfg, prior = load_trees(rig_config)
    rtree = weights.random_matcher_tree(mcfg, RANDOM_MATCHER_SEED)
    frames = [parse_frame(f, rig_config) for f in generate_frames(
        rig_config, rig, N_FRAMES, n_people=(2, 3), seed=1)]

    def pipeline(tree, device, use_frame_kernel=None, slots=4, persons=8):
        return PoseEstimationPipeline(
            rig_config, rig, weights.matcher_from_tree(tree, mcfg, device),
            weights.lifter_from_tree(ltree, lcfg, device),
            slot_buckets=(slots,), person_buckets=(persons,),
            lifter_prior=prior, use_frame_kernel=use_frame_kernel,
            device=device)

    gpu_r = pipeline(rtree, "cuda")
    report = []
    check_kernels(gpu_r, frames[0], report)
    crowded = parse_frame(generate_frames(rig_config, rig, 1,
                                          n_people=(10, 14), seed=2)[0],
                          rig_config, max_skeletons=16)
    check_frame_kernel(gpu_r, frames[0],
                       pipeline(mtree, "cuda", slots=16, persons=16),
                       crowded, report)
    phase("kernels", t0, "all three kernels match their plain versions")

    t0 = time.perf_counter()
    print(f"  lifter weights: trained, models_demo/pan_irls_bf16; "
          f"prior {prior!r}")
    main_launches, frame_ms = None, {}
    for mlabel, tree in (("trained matcher", mtree),
                         (f"random matcher (numpy seed "
                          f"{RANDOM_MATCHER_SEED})", rtree)):
        gpu = pipeline(tree, "cuda")
        if not gpu.frame_path_on():
            raise AssertionError("the frame path is not the default on the "
                                 "card")
        launches, ms = run_main_path(gpu, pipeline(tree, "cpu", True), frames,
                                     f"{mlabel}, frame path")
        main_launches = main_launches or launches
        _, ms_eager = run_main_path(pipeline(tree, "cuda", False),
                                    pipeline(tree, "cpu", False), frames,
                                    f"{mlabel}, eager path")
        frame_ms[mlabel] = (ms, ms_eager)
        stage_table(gpu, frames, mlabel)
    for k in report:
        k["launches"] = main_launches[k["name"]]
    phase("main path", t0, "infer_fused on the card agrees with the CPU on "
          "both paths; median frame ms (frame path / eager path): "
          + "; ".join(f"{m} {a:.3f} / {b:.3f}"
                      for m, (a, b) in frame_ms.items()))

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
