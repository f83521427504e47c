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
   plain version's, the card's bound and a PyTorch yardstick.
4. main path: ``PoseEstimationPipeline.infer_fused`` on 16 synthetic frames
   on the card, once with the trained matcher and once with a numpy-seeded
   random matcher (the trained one scores near 0 on the synthetic ring rig;
   the random one marks every present pair, so decode, gather, pack and the
   lifter run on live persons).  Checks that both kernels were launched by
   the run, that outputs are finite, and that persons, scores and poses
   agree with the same pipeline on the CPU (plain versions).

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


def run_main_path(gpu, cpu, frames, label):
    """Phase 4 for one matcher: counters, finiteness, CPU agreement."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, gat_kernel

    for f in frames[:N_WARMUP]:
        gpu.infer_fused(f)
    gat_kernel.gat_stack.launches = 0
    fused_mlp.mlp_layer.launches = 0
    outs, times = [], []
    for f in frames:
        t0 = time.perf_counter()
        outs.append(gpu.infer_fused(f))
        times.append(1e3 * (time.perf_counter() - t0))
    launches = {"gat_stack": gat_kernel.gat_stack.launches,
                "mlp_bf16_layer": fused_mlp.mlp_layer.launches}
    n_layers = gpu.lifter.n_layers
    if launches != {"gat_stack": len(frames),
                    "mlp_bf16_layer": n_layers * len(frames)}:
        raise AssertionError(f"{label}: kernel launches {launches}, expected "
                             f"1 GAT call and {n_layers} MLP layers per frame")
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
    print(f"  {label}: persons per frame {[len(o.persons) for o in outs]}, "
          f"{statistics.median(times):.3f} ms/frame (median of "
          f"{len(frames)}), launches {launches}; vs CPU: persons equal, "
          f"max |d score| {max_ds:.3g}, max |d pose| {max_dp:.3g} m, "
          f"{near} scores within 1e-5 of the threshold")
    return launches


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

    def pipeline(tree, device):
        return PoseEstimationPipeline(
            rig_config, rig, weights.matcher_from_tree(tree, mcfg, device),
            weights.lifter_from_tree(ltree, lcfg, device),
            slot_buckets=(4,), person_buckets=(8,), lifter_prior=prior,
            device=device)

    gpu_r = pipeline(rtree, "cuda")
    report = []
    check_kernels(gpu_r, frames[0], report)
    phase("kernels", t0, "both kernels match their plain versions")

    t0 = time.perf_counter()
    print(f"  lifter weights: trained, models_demo/pan_irls_bf16; "
          f"prior {prior!r}")
    launches = run_main_path(pipeline(mtree, "cuda"), pipeline(mtree, "cpu"),
                             frames, "trained matcher")
    run_main_path(gpu_r, pipeline(rtree, "cpu"), frames,
                  f"random matcher (numpy seed {RANDOM_MATCHER_SEED})")
    for k in report:
        k["launches"] = launches[k["name"]]
    phase("main path", t0, "infer_fused on the card agrees with the CPU")

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
