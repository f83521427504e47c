#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its wall time; any
failure raises, and the script exits non-zero):

1. env: torch/CUDA versions, the card's name and power limit.
2. build: the one ``nvcc`` call that builds the CUDA kernels of
   ``mpe3d_tpu_torch/csrc`` (0 s when the build cache matches), and
   ptxas's registers, shared memory and spills of the fp64 tensor-core GEMM
   shared by the three GAT kernels (one copy in each of their sources), the
   stack kernel's output kernel, the lifter's run kernel and the decode +
   gather + pack kernel.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the serving path gives it (Panoptic rig, S=4 slots, P=8
   persons), with median times over 50 launches (CUDA events) beside the
   plain version's, the card's bound and a PyTorch yardstick where one
   exists.  The decode + gather + pack kernel is checked for every prior
   (mean, median, IRLS) with and without the prior gate.  The tiled GAT
   kernels (K1, K2) are checked at Panoptic S=10 and S=16 with the trained
   and a random matcher, on an ARPLAB-shaped 6 x 16 topology (head degree
   80, past the stack kernel's cap), on a pruned, compacted edge set, and at
   S=16 against the stack kernel too.  The lifter's run kernel
   (``mlp_run``) is checked on each layer of the bf16 lifter alone (a run of
   one layer) and on the whole 9-layer net (one launch) at M=8 and M=16,
   two launches bit-equal; on each int8 layer of ``models_demo/pan_irls``
   and ``pan_compact`` alone on the serving path's lifter inputs (M=8) and
   at M=40 (a run a group of 16 rows), ``int8_weight_matmul`` on row-major
   weights, and the whole mixed nets (8 int8 layers, a bf16 head: one
   launch) at M=8 and M=16, two launches bit-equal; the fused projection
   kernel on the trained matcher's five layer inputs at S=4 and S=16, two
   calls bit-equal, with its distance from an fp64 evaluation.  The run
   kernel (both layer kinds) and the projection are timed in turns with
   their PyTorch yardsticks (kernel, yardstick, yardstick, kernel).  The
   stack GAT kernel with and without ``edge_const`` (the shared edge row
   projected once, as the pipeline serves it), two calls bit-equal; on the
   trained matcher at S=4 and S=16 with its distance from fp64 beside the
   tiled kernels', both held to ``GAT_FP64_TOL`` and bit-equal across
   calls.  Every kernel row also carries its device time (torch.profiler),
   and the GAT kernels print their CUDA launches a call.
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
   times and device busy share.  Then the int8 pair ``models_demo/pan_irls``
   (``from_checkpoint``): 16 frames on the frame path and 6 on the eager
   path, trained and random matcher, against the same pipeline on the CPU,
   one lifter run launch a frame, beside the bf16 pair's frame time; ``pan_compact`` on 6 frames of the frame path; and the per-layer
   GAT form (``use_layer_matcher``) on the eager path at S=4 and at the
   default buckets on the S=10 frames ("mean" prior), 5 projection launches
   a frame and no stack or tiled GAT launch.
5. crowded path: ``infer_fused`` on the card against the CPU for S=10
   through the default buckets ``(2, 4, 10)`` / ``(4, 8, 16)`` (frames of
   6-9 people) and for S=16 through ``(16,)`` / ``(16,)`` (10-14 people),
   with the trained and the random matcher, pair pruning off and on: the
   split frame path (tiled GAT kernels, the decode + gather + pack kernel on
   the compacted pairs under pruning, the lifter kernel).  Prints each
   bucket's resolved serving path, the launches per frame and the median
   frame ms, and the split path's stages.

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
DEMO_INT8 = os.path.join(ROOT, "models_demo", "pan_irls")   # same recipe
DEMO_COMPACT = os.path.join(ROOT, "models_demo", "pan_compact")

N_FRAMES, N_WARMUP, N_TIMED = 16, 3, 50
N_CROWDED = 6              # frames of each crowded run but the reported one
N_SHORT = 6                # frames of the int8 eager, pan_compact and layer runs
RANDOM_MATCHER_SEED = 0    # its scores sit above the 0.5 threshold
ARPLAB_MATCHER_SEED = 1
PRUNE_DIST_M = 0.2         # pair_prune_dist of the pruned crowded runs
GPU = "cuda"

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
#  * the int8 layers are held to the same two: their products (bf16
#    activation x int8 weight) are exact in fp32 as well, and the sums are
#    fp32 in another order.
#  * the fused GAT projection (fc1 -> LeakyReLU -> fc2): the kernel sums in
#    fp64, the plain version (cuBLAS, no TF32) in fp32 over at most 902
#    terms, about 1e-6 of the output's scale; bounded at
#    1e-5 x (1 + max |out|) per layer.
GAT_RTOL = 1e-4
MLP_LAYER_TOL = 1e-5
MLP_NET_TOL = 5e-3
PROJ_RTOL = 1e-5
# the fused projection against an fp64 evaluation of the same function: its
# sums are fp64, so only the two fp32 roundings (h and out) remain, about
# 6e-8 of the output's scale; bounded at 1e-7 x (1 + max |out|)
PROJ_FP64_TOL = 1e-7
# the GAT stack (stack kernel, tiled kernels) on the trained matcher against
# an fp64 evaluation of the same function: fp64 sums, fp32 operands and
# stored activations, whose roundings the trained logits (to |130|, heavy
# cancellation near 0) amplify: 1.64e-6 at S=4, 8.16e-6 at S=16 before the
# tensor-core GEMM; bounded at 1e-5 x (1 + |logit|)
GAT_FP64_TOL = 1e-5
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
# Crowded runs pack the lifter input with the "mean" prior: on crowded
# frames the decode groups skeletons of different people, and the IRLS
# prior of such groups is ill-conditioned (a 1e-7 relative change of the
# pixels moves IRLS poses by decimetres on the CPU alone,
# tests/test_torch_crowded.py::test_crowded_prior_sensitivity), so no fp32
# tolerance holds between the card and the CPU under it.  The IRLS prior of
# the decode + gather + pack kernel is held at S=16 in phase 3 instead, on
# groups of real people.
CROWDED_PRIOR = "mean"


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


def device_profile(fn, n: int = 20):
    """(device ms, CUDA kernel launches) of one call of ``fn``: the kernels
    and copies it runs, as torch.profiler records them, over ``n`` calls
    (no host time); launches count kernels only, not copies or memsets."""
    from mpe3d_tpu_torch.tools import gat_timing
    return gat_timing.device_profile(fn, n)[:2]


def device_ms(fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` (``device_profile``)."""
    return device_profile(fn, n)[0]


def in_turns(kernel, yardstick, n: int = N_TIMED):
    """(kernel ms, yardstick ms), each the median of its two runs of ``n``
    timed calls, taken in turns in one call: kernel, yardstick, yardstick,
    kernel (times drift between calls)."""
    k1 = median_ms(kernel, n)
    y1, y2 = median_ms(yardstick, n), median_ms(yardstick, n)
    k2 = median_ms(kernel, n)
    return statistics.median([k1, k2]), statistics.median([y1, y2])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def ptxas_report(output: str, kernel: str):
    """ptxas's lines (registers, shared memory, spills) for each compiled
    instance of the kernel whose mangled name contains ``kernel``."""
    lines, keep = [], False
    for ln in output.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            keep = kernel in ln
            continue
        if keep and ("Used" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines or ["not found in the compiler output"]


def load_lifter(models_dir, rig_config):
    """(tree, config, prior) of the lifter checkpoint of a models dir."""
    from mpe3d_tpu_torch.checkpoint import load_lifter_checkpoint
    from mpe3d_tpu_torch.config import LifterConfig
    return load_lifter_checkpoint(
        os.path.join(models_dir, "pose_estimator"),
        LifterConfig(in_dim=rig_config.lifter_input_dim,
                     out_dim=rig_config.n_joints * 3))


def load_trees(rig_config):
    """Trained matcher and lifter trees of models_demo/pan_irls_bf16, their
    configs and the lifter's prior."""
    from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
    from mpe3d_tpu_torch.config import MatcherConfig
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(DEMO, "skeleton_matching"),
        MatcherConfig(in_dim=rig_config.matcher_feature_dim))
    return (mtree, mcfg) + tuple(load_lifter(DEMO, rig_config))


def gat_costs(x, n_weights, dims, E, D, edge_const):
    """(bytes, flops) the GAT stack must move and compute for one frame:
    inputs read once (features, weights, pair weights, topology), logits
    written once; the fc products and attention terms (layer 0 on the H
    head rows and the one shared edge row under ``edge_const``), and both
    softmaxes."""
    N = x.shape[0]
    H = N - E
    rows0 = H + 1 if edge_const else N
    bytes_ = 4 * (rows0 * x.shape[1] + n_weights + E + 2 * E + H * D) + 4 * E
    flops = 0
    for l, (d_in, d, nh) in enumerate(dims):
        F, rows = nh * d, rows0 if l == 0 else N
        flops += 2 * rows * (d_in * d_in + d_in * F) + 4 * rows * F  # fc+attn
        flops += E * F * 6                                      # edge out
        if l < len(dims) - 1:
            flops += 2 * E * F * 2                              # head sums
    return bytes_, flops


def check_kernels(pipe, frame, report):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, gat_kernel

    x_all, pw, gtopo, nets = pipe.stage_inputs(frame)
    m = pipe.matcher
    args = (x_all, pw, gtopo, m.flat, m.dims, m.cfg.alpha,
            m.cfg.hidden_slope)
    errs = {}
    for const in (True, False):
        got = gat_kernel.gat_stack(*args, edge_const=const)
        again = gat_kernel.gat_stack(*args, edge_const=const)
        ref = gat_kernel.gat_stack_plain(*args, edge_const=const)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > GAT_RTOL * (1 + ref.abs())).any()):
            raise AssertionError(f"GAT kernel (edge_const={const}) disagrees "
                                 f"with its plain version: max |d logit| "
                                 f"{float(err.max()):.3g}")
        if not torch.equal(got, again):
            raise AssertionError(f"GAT kernel (edge_const={const}): two "
                                 f"calls on the same input differ")
        errs[const] = float(err.max())
    costs = {const: bound(*gat_costs(x_all, m.flat.numel(), m.dims,
                                     gtopo.n_pairs, gtopo.inc.shape[1],
                                     const)) for const in (True, False)}
    b_ms, b_by = costs[True]
    report.append({
        "name": "gat_stack", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/gat_stack.cu",
        "replaces": "mpe3d_tpu/ops/gat_kernel.py:206",
        "launches": 0, "max_abs_err": max(errs.values()),
        "ms": median_ms(lambda: gat_kernel.gat_stack(*args,
                                                     edge_const=True)),
        "plain_ms": median_ms(lambda: gat_kernel.gat_stack_plain(
            *args, edge_const=True)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": device_ms(lambda: gat_kernel.gat_stack(
            *args, edge_const=True))})
    print(f"  gat_stack: H+E={x_all.shape[0]} rows, max |d logit| with "
          f"edge_const {errs[True]:.3g}, without {errs[False]:.3g} (tol "
          f"{GAT_RTOL:g} x (1+|logit|)), two calls bit-equal in both; bound "
          f"with edge_const (the pipeline's function) {b_ms:.5f} ms "
          f"({b_by}), all rows projected at layer 0 {costs[False][0]:.5f} "
          f"ms; all rows: "
          f"{median_ms(lambda: gat_kernel.gat_stack(*args)):.4f} ms")

    lifter = pipe.lifter
    layers = lifter.packed_layers()
    slope, out_dim = lifter.cfg.negative_slope, lifter.cfg.out_dim
    if fused_mlp.launch_plan(layers) != [("run", 0, len(layers))]:
        raise AssertionError("the bf16 lifter is not one run")
    acts = [i < len(layers) - 1 for i in range(len(layers))]
    h, one_ms = nets.float().contiguous(), []
    for i, layer in enumerate(layers):
        # the run kernel on this layer alone (a run of one layer)
        one = lambda h=h, i=i: fused_mlp.run_layers(  # noqa: E731
            h, [layers[i]], slope, [acts[i]])
        y = one()
        y_ref = fused_mlp.mlp_layer_plain(h, *layer, slope, acts[i])
        torch.cuda.synchronize()
        lerr = float((y - y_ref).abs().max())
        ltol = MLP_LAYER_TOL * max(1.0, float(y_ref.abs().max()))
        if not (bool(torch.isfinite(y).all()) and lerr <= ltol):
            raise AssertionError(f"MLP layer {i}: max err {lerr:.3g} > "
                                 f"{ltol:.3g}")
        one_ms.append((median_ms(one, 20), device_ms(one)))
        h = y_ref
    rng = np.random.default_rng(16)
    x16 = (nets.float().repeat(2, 1) * torch.tensor(
        rng.uniform(0.5, 1.5, (2 * nets.shape[0], 1)), dtype=torch.float32,
        device=nets.device)).contiguous()
    wb = [w.to(torch.bfloat16) for w, _ in layers]
    rows = {}
    for x in (nets.float().contiguous(), x16):
        M = x.shape[0]
        run = lambda x=x: fused_mlp.fused_mlp_forward(  # noqa: E731
            x, layers, slope, out_dim)
        got, again = run(), run()
        ref = fused_mlp.fused_mlp_plain(x, layers, slope, out_dim)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
            raise AssertionError(f"MLP run kernel, M={M}: max err {err:.3g} "
                                 f"> {MLP_NET_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"MLP run kernel, M={M}: two launches on "
                                 f"the same input differ")

        def library(x=x):
            hb = x.to(torch.bfloat16)
            for w in wb:
                hb = torch.matmul(hb, w)
            return hb

        ms, lib_ms = in_turns(run, library)
        # x read once, y written once, every weight and bias read once
        bytes_ = (4 * x.numel() + 4 * M * layers[-1].w.shape[1]
                  + sum(w.numel() * 2 + b.numel() * 4 for w, b in layers))
        flops = sum(2 * M * w.shape[0] * w.shape[1] for w, _ in layers)
        t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
        rows[M] = {
            "name": "mlp_run", "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "mpe3d_tpu/ops/fused_mlp.py:57",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": median_ms(lambda x=x: fused_mlp.fused_mlp_plain(
                x, layers, slope, out_dim)),
            "bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b > t_f else "operations",
            "library_ms": lib_ms, "device_ms": device_ms(run)}
        k = rows[M]
        print(f"  mlp_run (bf16 kind): whole net ({len(layers)} layers, one "
              f"launch) on {M} rows: max err {err:.3g} (tol "
              f"{MLP_NET_TOL:g} decameters), two launches bit-equal; "
              f"{k['ms']:.4f} ms, library ({len(layers)} chained bf16 "
              f"torch.matmul) {lib_ms:.4f} ms (in turns), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}: {bytes_} bytes); device time alone "
              f"(profiler): kernel {k['device_ms']:.4f} ms, library "
              f"{device_ms(library):.4f} ms")
    report.append(rows[nets.shape[0]])
    print(f"  mlp_run (bf16 kind): each of the {len(layers)} layers alone "
          f"within {MLP_LAYER_TOL:g} x max|out| of its plain version; each "
          f"one-layer run (M={nets.shape[0]}), ms / device ms: "
          + ", ".join(f"{t:.4f} / {d:.4f}" for t, d in one_ms))
    k = report[0]
    dev, n_k = device_profile(lambda: gat_kernel.gat_stack(*args,
                                                           edge_const=True))
    print(f"  {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
          f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library "
          f"{k['library_ms']}; device time alone (profiler) {dev:.4f} ms, "
          f"{n_k:g} CUDA launches a call")


def mlp_costs(layers, M):
    """(bytes, operations) of the given packed lifter layers on M rows: each
    layer's input rows, weights, scales and bias read once, its output
    written once; 2 M K N operations a layer."""
    from mpe3d_tpu_torch.ops.fused_mlp import layer_shape
    bytes_ = flops = 0
    for layer in layers:
        K, N = layer_shape(layer)
        bytes_ += (4 * M * K + 4 * M * N
                   + sum(t.numel() * t.element_size() for t in layer))
        flops += 2 * M * K * N
    return bytes_, flops


def check_int8_layers(label, lifter, x):
    """Each int8 layer of ``lifter`` on the input the serving path gives it
    (the plain version's output of the layer before) through the run kernel
    (``int8_layer_matmul``: a run of the one layer a group of at most 16
    rows) against its plain version; returns the layers' inputs."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, quant_matmul
    slope = lifter.cfg.negative_slope
    layers, inputs, h = lifter.packed_layers(), [], x.float().contiguous()
    worst = 0.0
    for i, layer in enumerate(layers[:-1]):
        if not isinstance(layer, fused_mlp.Int8Layer):
            raise AssertionError(f"{label}: layer {i} is not int8")
        before = fused_mlp.mlp_run.launches
        y = quant_matmul.int8_layer_matmul(h, layer, slope)
        y_ref = fused_mlp.layer_plain(h, layer, slope, True)
        torch.cuda.synchronize()
        runs = fused_mlp.mlp_run.launches - before
        lerr = float((y - y_ref).abs().max())
        ltol = MLP_LAYER_TOL * max(1.0, float(y_ref.abs().max()))
        if not (bool(torch.isfinite(y).all()) and lerr <= ltol
                and runs == -(-h.shape[0] // fused_mlp.MAX_ROWS)):
            raise AssertionError(f"{label}: int8 layer {i} ({tuple(h.shape)}"
                                 f" x {fused_mlp.layer_shape(layer)}): max "
                                 f"err {lerr:.3g} > {ltol:.3g} or {runs} "
                                 f"run launches")
        worst = max(worst, lerr / ltol)
        inputs.append((h, layer))
        h = y_ref
    print(f"  mlp_run, int8 layers of {label}: {len(inputs)} layers alone on "
          f"{x.shape[0]} rows ({-(-x.shape[0] // fused_mlp.MAX_ROWS)} "
          f"launches a layer), each within {MLP_LAYER_TOL:g} x max|out| of "
          f"its plain version (largest error {worst:.3g} of the tolerance)")
    return inputs


def int8_yardstick(layers, slope):
    """The int8 rows' PyTorch yardstick over a list of int8 layers (M rows
    in, LeakyReLU after each): ``aten::_weight_int8pack_mm`` a layer where
    the card's PyTorch registers it for CUDA (on bf16(x * rscale), bf16
    column scales, then + b), else a bf16 ``torch.matmul`` on the bf16 copy
    of the weights (exact), ``* scale + b``.  Returns (label, function of
    x)."""
    import torch
    import torch.nn.functional as tf
    from mpe3d_tpu_torch.ops.fused_mlp import int8_rows, layer_shape
    packed = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    prep = []
    for layer in layers:
        K, N = layer_shape(layer)
        w = int8_rows(layer.wq)[:K, :N]
        prep.append((layer.rscale, w.t().contiguous() if packed
                     else w.to(torch.bfloat16),
                     layer.scale.to(torch.bfloat16) if packed
                     else layer.scale, layer.b))

    def run(x):
        h = x
        for rs, w, sc, b in prep:
            hb = (h * rs).to(torch.bfloat16)
            if packed:
                h = torch._weight_int8pack_mm(hb, w, sc).float() + b
            else:
                h = torch.matmul(hb, w).float() * sc + b
            h = tf.leaky_relu(h, slope)
        return h

    label = ("aten::_weight_int8pack_mm a layer" if packed else
             "bf16 torch.matmul on the bf16 weights, * scale + b, a layer")
    return label, run


def check_int8_kernels(pipe, frame, int8_lifter, compact_lifter, report,
                       bf16_ms):
    """Phase 3, the int8 layer kind of the run kernel: each int8 layer of
    the pan_irls and pan_compact lifters on the serving path's inputs (M=8
    lifter rows of a random-matcher frame) and at M=40 (three runs a
    layer); ``int8_weight_matmul`` on row-major weights at M=40; the whole
    mixed nets (8 int8 layers and a bf16 head, one launch) against their
    plain versions at M=8 and M=16, two launches bit-equal.  Two report
    rows: the int8 kind (pan_irls's 8 int8 layers as one run) and the
    int8 matmul (the same 8 layers, a run of one layer each), both at
    M=8, each beside its PyTorch yardstick in turns."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, quant_matmul

    nets = pipe.stage_inputs(frame)[3].float().contiguous()
    rng = np.random.default_rng(40)
    x40 = nets.repeat(5, 1) * torch.tensor(
        rng.uniform(0.5, 1.5, (5 * nets.shape[0], 1)), dtype=torch.float32,
        device=nets.device)
    inputs = check_int8_layers("pan_irls", int8_lifter, nets)
    check_int8_layers("pan_irls", int8_lifter, x40)
    check_int8_layers("pan_compact", compact_lifter, nets)
    check_int8_layers("pan_compact", compact_lifter, x40)
    cfg = int8_lifter.cfg
    slope = cfg.negative_slope
    layers = int8_lifter.packed_layers()
    # the row-major entry (the counterpart of _pallas_int8_matmul's)
    l0 = layers[0]
    K, N = fused_mlp.layer_shape(l0)
    args = (x40, fused_mlp.int8_rows(l0.wq)[:K, :N].contiguous(),
            l0.scale[:N], l0.b[:N], slope, l0.rscale)
    got = quant_matmul.int8_weight_matmul(*args)
    ref = quant_matmul.int8_matmul_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= MLP_LAYER_TOL * max(1.0, float(ref.abs().max())):
        raise AssertionError(f"int8_weight_matmul, M=40: max err {err:.3g}")
    print(f"  int8_weight_matmul (row-major int8 weights, packed at the "
          f"call) on pan_irls layer 0 at M=40: max err {err:.3g}")

    x16 = torch.cat([nets, nets * 0.75])
    nets_err = {}
    for name, lifter in (("pan_irls", int8_lifter),
                         ("pan_compact", compact_lifter)):
        ls = lifter.packed_layers()
        if fused_mlp.launch_plan(ls) != [("run", 0, len(ls))]:
            raise AssertionError(f"{name}: the int8 lifter is not one run")
        for x in (nets, x16):
            run = lambda x=x, ls=ls: fused_mlp.fused_mlp_forward(  # noqa
                x, ls, slope, lifter.cfg.out_dim)
            before = fused_mlp.mlp_run.launches
            got, again = run(), run()
            ref = fused_mlp.fused_mlp_plain(x, ls, slope, lifter.cfg.out_dim)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            nets_err[name, x.shape[0]] = err
            if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
                raise AssertionError(f"{name} int8 net, M={x.shape[0]}: max "
                                     f"err {err:.3g} > {MLP_NET_TOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} int8 net, M={x.shape[0]}: two "
                                     f"launches on the same input differ")
            if fused_mlp.mlp_run.launches - before != 2:
                raise AssertionError(f"{name} int8 net: not one launch a "
                                     f"call")
    print("  mlp_run, whole int8 nets (8 int8 layers and a bf16 head, one "
          "launch): max err "
          + ", ".join(f"{n} M={m} {e:.3g}" for (n, m), e in nets_err.items())
          + f" (tol {MLP_NET_TOL:g} decameters), two launches bit-equal")

    M = nets.shape[0]
    body = layers[:-1]
    acts = [True] * len(body)
    label, library = int8_yardstick(body, slope)
    bytes_, flops = mlp_costs(body, M)
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    bound_ms = 1e3 * max(t_b, t_f)
    bound_by = "bytes" if t_b > t_f else "operations"
    one_run = lambda: fused_mlp.run_layers(nets, body, slope, acts)  # noqa
    alone = lambda: [quant_matmul.int8_layer_matmul(h, layer, slope)  # noqa
                     for h, layer in inputs]
    plain_run = lambda: fused_mlp.run_plain(nets, body, slope, acts)  # noqa
    plain_alone = lambda: [fused_mlp.layer_plain(h, layer, slope, True)  # noqa
                           for h, layer in inputs]
    lib = lambda: library(nets)  # noqa: E731
    rows = []
    for replaces, kernel, plain in (
            ("mpe3d_tpu/ops/fused_mlp.py:80", one_run, plain_run),
            ("mpe3d_tpu/ops/quant_matmul.py:73", alone, plain_alone)):
        ms, lib_ms = in_turns(kernel, lib)
        rows.append({
            "name": "mlp_run", "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(nets_err.values()), "ms": ms,
            "plain_ms": median_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "device_ms": device_ms(kernel)})
    report.extend(rows)
    a, b = rows
    net_run = lambda: fused_mlp.fused_mlp_forward(  # noqa: E731
        nets, layers, slope, cfg.out_dim)
    clayers = compact_lifter.packed_layers()
    c_run = lambda: fused_mlp.run_layers(  # noqa: E731
        nets, clayers[:-1], slope, [True] * (len(clayers) - 1))
    c_bytes, _ = mlp_costs(clayers[:-1], M)
    print(f"  mlp_run (int8 kind): pan_irls, its 8 int8 layers as one run on "
          f"{M} rows: {a['ms']:.4f} ms, device {a['device_ms']:.4f} ms; "
          f"each a run of one layer (int8_layer_matmul, 8 launches): "
          f"{b['ms']:.4f} ms, device {b['device_ms']:.4f} ms; plain "
          f"{a['plain_ms']:.4f} / {b['plain_ms']:.4f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {bytes_} bytes); library ({label},"
          f" 8 chained) {a['library_ms']:.4f} / {b['library_ms']:.4f} ms (in "
          f"turns), device {device_ms(lib):.4f} ms; whole int8 net (one "
          f"launch) {median_ms(net_run):.4f} ms, device "
          f"{device_ms(net_run):.4f} ms, against the bf16 net of "
          f"pan_irls_bf16 (one run launch, the same recipe) {bf16_ms:.4f} "
          f"ms; pan_compact 8 int8 layers as one run {median_ms(c_run):.4f} "
          f"ms, device {device_ms(c_run):.4f} ms, bound "
          f"{1e3 * c_bytes / HBM_BYTES_PER_S:.5f} ms ({c_bytes} bytes)")


def proj_layer_inputs(x, pw, gtopo, m):
    """The five (x, w1, b1, w2, b2, alpha) calls the per-layer form makes
    on these GAT inputs (the plain stack's own layer inputs)."""
    from mpe3d_tpu_torch.ops import fused_proj, gat_kernel
    calls = []

    def record(*a):
        calls.append(a)
        return fused_proj.proj_plain(*a)

    gat_kernel.gat_stack_plain(x, pw, gtopo, m.flat, m.dims, m.cfg.alpha,
                               m.cfg.hidden_slope, proj=record)
    return calls


def check_proj_kernel(cases, report):
    """Phase 3, the fused projection kernel against its plain version on
    the trained matcher's five layer inputs of each case (label -> GAT
    inputs with incidence lists), with each one's distance from an fp64
    evaluation; the first case gives the report row."""
    import torch
    import torch.nn.functional as tf
    from mpe3d_tpu_torch.ops import fused_proj

    for label, (x, pw, gtopo, m) in cases.items():
        calls = proj_layer_inputs(x, pw, gtopo, m)
        errs, d_kernel, d_plain = [], 0.0, 0.0
        for i, a in enumerate(calls):
            got = fused_proj.fused_linear_leaky_linear(*a)
            again = fused_proj.fused_linear_leaky_linear(*a)
            ref = fused_proj.proj_plain(*a)
            exact = fused_proj.proj_plain(*(t.double() for t in a[:5]), a[5])
            torch.cuda.synchronize()
            scale = 1.0 + float(exact.abs().max())
            err = float((got - ref).abs().max())
            if not (bool(torch.isfinite(got).all())
                    and err <= PROJ_RTOL * (1.0 + float(ref.abs().max()))):
                raise AssertionError(
                    f"gat_fused_proj {label} layer {i} ({tuple(a[0].shape)} "
                    f"-> {tuple(a[3].shape)}): max err {err:.3g}")
            if not torch.equal(got, again):
                raise AssertionError(f"gat_fused_proj {label} layer {i}: two "
                                     f"calls on the same input differ")
            errs.append(err)
            d_kernel = max(d_kernel,
                           float((got.double() - exact).abs().max()) / scale)
            d_plain = max(d_plain,
                          float((ref.double() - exact).abs().max()) / scale)
        if not d_kernel <= PROJ_FP64_TOL:
            raise AssertionError(f"gat_fused_proj {label}: {d_kernel:.3g} x "
                                 f"(1 + max|out|) from fp64, past "
                                 f"{PROJ_FP64_TOL:g}")
        bytes_ = sum(4 * (a[0].numel() + a[1].numel() + a[2].numel()
                          + a[3].numel() + a[4].numel()
                          + a[0].shape[0] * a[3].shape[1]) for a in calls)
        flops = sum(2 * a[0].shape[0] * a[1].shape[0]
                    * (a[1].shape[1] + a[3].shape[1]) for a in calls)
        b_ms, b_by = bound(bytes_, flops)

        def library(calls=calls):
            return [torch.addmm(b2, tf.leaky_relu(torch.addmm(b1, x_, w1),
                                                  alpha), w2)
                    for x_, w1, b1, w2, b2, alpha in calls]

        ms, lib_ms = in_turns(lambda c=calls: [
            fused_proj.fused_linear_leaky_linear(*a) for a in c], library)
        row = {
            "name": "gat_fused_proj", "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/fused_proj.cu",
            "replaces": "mpe3d_tpu/ops/fused_proj.py:48",
            "launches": 0, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": median_ms(lambda c=calls: [
                fused_proj.proj_plain(*a) for a in c]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        plans = [fused_proj.proj_plan(a[0].shape[0], a[1].shape[0],
                                      a[3].shape[1]) for a in calls]
        per_call = [device_ms(lambda a=a: fused_proj.fused_linear_leaky_linear(
            *a)) for a in calls]
        dev_ms = row["device_ms"] = device_ms(lambda c=calls: [
            fused_proj.fused_linear_leaky_linear(*a) for a in c])
        if not any(r["name"] == "gat_fused_proj" for r in report):
            report.append(row)
        print(f"  gat_fused_proj {label}: {x.shape[0]} rows, 5 layers (a "
              f"call: 2 GEMM launches; blocks fc1/fc2 "
              f"{', '.join(f'{p.fc1.blocks}/{p.fc2.blocks}' for p in plans)}"
              f"), max err per layer {', '.join(f'{e:.3g}' for e in errs)} "
              f"(tol {PROJ_RTOL:g} x (1 + max|out|)), two calls bit-equal; "
              f"to fp64: kernel {d_kernel:.3g} (tol {PROJ_FP64_TOL:g}), "
              f"plain {d_plain:.3g} (x (1 + max|out|)); {row['ms']:.4f} ms, "
              f"library (torch.addmm -> leaky_relu -> torch.addmm a layer, "
              f"TF32 off) {row['library_ms']:.4f} ms (in turns), plain "
              f"{row['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{flops} operations); device time alone (profiler): "
              f"kernel {dev_ms:.4f} ms (calls "
              + ", ".join(f"{t:.4f}" for t in per_call)
              + f"), library {device_ms(library):.4f} ms")


def check_stack_trained(label, x, pw, gtopo, m, tiled_topo=None):
    """The stack GAT kernel (with ``edge_const``, as the pipeline serves it)
    against its plain version on the trained matcher, bit-equal across two
    calls, with each one's largest |d logit| / (1 + |logit|) from an fp64
    evaluation held to GAT_FP64_TOL (and the tiled kernels' on the same call
    when ``tiled_topo`` is given); prints the call ms, device ms and CUDA
    launches a call."""
    import torch
    from mpe3d_tpu_torch.ops import gat_kernel, gat_tiled
    args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope)
    got = gat_kernel.gat_stack(*args, edge_const=True)
    again = gat_kernel.gat_stack(*args, edge_const=True)
    ref = gat_kernel.gat_stack_plain(*args, edge_const=True)
    exact = gat_kernel.gat_stack_plain(x.double(), pw.double(), gtopo,
                                       m.flat.double(), m.dims, m.cfg.alpha,
                                       m.cfg.hidden_slope, edge_const=True)
    torch.cuda.synchronize()
    rel = lambda v: float(  # noqa: E731
        ((v.double() - exact).abs() / (1 + exact.abs())).max())
    err = (got - ref).abs()
    dist = {"gat_stack": rel(got)}
    note = f"to fp64: kernel {rel(got):.3g}, plain {rel(ref):.3g}"
    equal = torch.equal(got, again)
    if tiled_topo is not None:
        targs = (x, pw, tiled_topo, m.flat, m.dims, m.cfg.alpha,
                 m.cfg.hidden_slope)
        tiled = gat_tiled.gat_stack_tiled(*targs, edge_const=True)
        tiled2 = gat_tiled.gat_stack_tiled(*targs, edge_const=True)
        torch.cuda.synchronize()
        equal = equal and torch.equal(tiled, tiled2)
        dist["tiled kernels"] = rel(tiled)
        note += (f", tiled kernels {rel(tiled):.3g} (stack / tiled "
                 f"{rel(got) / max(rel(tiled), 1e-30):.3g})")
    call = lambda: gat_kernel.gat_stack(*args, edge_const=True)  # noqa: E731
    ms = median_ms(call)
    dev, n_k = device_profile(call)
    print(f"  gat_stack {label}, trained matcher, edge_const: H+E="
          f"{x.shape[0]}, max |d logit| {float(err.max()):.3g} (tol "
          f"{GAT_RTOL:g} x (1+|logit|)); {note} (tol {GAT_FP64_TOL:g}); "
          f"two calls bit-equal: {equal}; {ms:.4f} ms, device time alone "
          f"(profiler) {dev:.4f} ms, {n_k:g} CUDA launches a call")
    if not bool(torch.isfinite(got).all()) or bool(
            (err > GAT_RTOL * (1 + ref.abs())).any()):
        raise AssertionError(f"gat_stack {label}, trained matcher: disagrees "
                             f"with its plain version: max |d logit| "
                             f"{float(err.max()):.3g}")
    if not equal:
        raise AssertionError(f"GAT {label}: two calls on the same input "
                             f"differ")
    far = {k: v for k, v in dist.items() if not v <= GAT_FP64_TOL}
    if far:
        raise AssertionError(f"GAT {label}: distance from fp64 {far} past "
                             f"{GAT_FP64_TOL:g} x (1 + |logit|)")


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


def check_frame_kernel(pipe, frame, crowded_pipe, crowded_frame, report):
    """Phase 3, the decode + gather + pack kernel against its plain version,
    for every prior with and without the gate: on the serving bucket's
    random-matcher frame (timed at the pipeline's own prior and gate), and
    on a crowded S=16 frame (E=2560 pairs, P=16 rows) scored by geometric
    consistency with every eligible pair decoded; and, under the "mean"
    prior, that frame with every present pair eligible (more than 1024
    eligible pairs: the kernel's bitonic sort).  The crowded frame is not
    scored by the random matcher: it groups unrelated skeletons at S=16,
    and IRLS on such groups is ill-conditioned (the plain version's prior
    moved 0.047 decameters under a 1e-7 relative change of the pixels),
    so no fp32 tolerance holds there."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.ops import frame_kernel as fk
    from mpe3d_tpu_torch.tools import gat_timing

    cases = [(p, g) for p in fk.PRIORS for g in (None, 8.0)]
    args, kw = pipe.frame_stage_inputs(frame)
    max_err = check_frame_cases(args, kw, cases, "S=4")
    # scores on a grid of eighths: exact ties, which go to the lower pair
    tied = (torch.round(args[0] * 8) / 8,) + args[1:]
    check_frame_cases(tied, kw, [(kw["prior"], kw["gate_px"])],
                      "S=4, tied scores")
    cargs, ckw = gat_timing.crowded_decode_inputs(crowded_pipe,
                                                  crowded_frame)
    check_frame_cases(cargs, ckw, cases,
                      f"S=16 (E={ckw['k_cap']}, P={ckw['P']})")
    # every present pair eligible (numpy-seeded scores in (0.5, 1]): past
    # 1024 eligible pairs the kernel orders its keys by the bitonic sort;
    # random groupings, so the "mean" prior (module header)
    rng = np.random.default_rng(7)
    pmask = cargs[1]
    many = torch.tensor(0.5 + 0.5 * (1.0 - rng.random(pmask.numel())),
                        dtype=torch.float32, device=pmask.device)
    n_elig = int(((pmask > 0.5) & (many > ckw["threshold"])).sum())
    if n_elig <= 1024:
        raise AssertionError(f"only {n_elig} eligible pairs: the bitonic "
                             f"sort is not exercised")
    check_frame_cases((many,) + cargs[1:], ckw, [("mean", None)],
                      f"S=16, {n_elig} eligible pairs (bitonic sort)")
    crowded = lambda: fk.frame_decode_pack(*cargs, **ckw)  # noqa: E731
    print(f"  frame_decode_pack S=16 ({ckw['prior']}, gate "
          f"{ckw['gate_px']}, every eligible pair decoded): "
          f"{median_ms(crowded):.4f} ms, device {device_ms(crowded):.4f} ms,"
          f" plain "
          f"{median_ms(lambda: fk.frame_decode_pack_plain(*cargs, **ckw)):.4f}"
          f" ms")
    out = fk.frame_decode_pack(*args, **kw)
    bytes_, ops = frame_costs(args, kw, out)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS
    call = lambda: fk.frame_decode_pack(*args, **kw)  # noqa: E731
    # the kernel's times before the plain version's thousands of small
    # launches (a profiling window right after them dropped events)
    ms, dev_ms = median_ms(call), device_ms(call)
    report.append({
        "name": "frame_decode_pack", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/frame_decode_pack.cu",
        "replaces": "mpe3d_tpu/ops/frame_kernel.py:358",
        "launches": 0, "max_abs_err": max_err, "ms": ms,
        "plain_ms": median_ms(lambda: fk.frame_decode_pack_plain(*args,
                                                                 **kw)),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None, "device_ms": dev_ms})
    k = report[-1]
    print(f"  frame_decode_pack S=4 ({kw['prior']}, gate {kw['gate_px']}): "
          f"{k['ms']:.4f} ms, device {k['device_ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms, bound "
          f"{k['bound_ms']:.6f} ms ({k['bound_by']}: {bytes_} bytes, {ops} "
          f"operations), library None")


def tiled_costs(dims, H, E, edge_const):
    """((bytes, operations) of the K1 calls, the same of the K2 calls) of
    one tiled stack: each call's inputs read once and outputs written once;
    operations of the fc products (layer 0 projects H+1 rows under
    edge_const), attention terms, edge softmax, masked logits and head max
    (K1), exp-shifted weights, head sums and epilogue (K2)."""
    k1b = k1f = k2b = k2f = 0
    for l, (d_in, d, nh) in enumerate(dims):
        F, const = nh * d, edge_const and l == 0
        rows = H + (1 if const else E)
        k1f += 2 * rows * (d_in * d_in + d_in * F) + 4 * rows * F + 6 * E * F
        k1b += 4 * (rows * d_in + d_in * d_in + d_in + d_in * F + 3 * F
                    + 3 * E)
        if l == len(dims) - 1:
            k1b += 4 * E
            continue
        k1f += 6 * E * nh
        k1b += 4 * (E * F + 2 * E * nh + H * nh)
        k2f += 8 * E * nh + 4 * E * F + 4 * H * F
        k2b += 4 * (2 * E * nh + 3 * E + (1 if const else E) * F + 2 * H * F
                    + 3 * H * nh)
    return (k1b, k1f), (k2b, k2f)


def bound(bytes_, flops):
    """(bound ms, what bounds it) at the H100's fp32 and memory peaks."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b > t_f else "operations"


def check_tiled_case(label, x, pw, gtopo, m, stack_topo=None):
    """The tiled stack's kernels against its plain version on the card (and
    against the stack kernel when ``stack_topo`` is given); prints the call
    ms, the plain ms and the bound.  Returns (max |d logit|, logits)."""
    import torch
    from mpe3d_tpu_torch.ops import gat_kernel, gat_tiled
    args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope)
    got = gat_tiled.gat_stack_tiled(*args, edge_const=True)
    ref = gat_tiled.gat_stack_tiled_plain(*args, edge_const=True)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > GAT_RTOL * (1 + ref.abs())).any()):
        raise AssertionError(f"tiled GAT {label}: kernels disagree with the "
                             f"plain version: max |d logit| "
                             f"{float(err.max()):.3g}")
    # accuracy context (printed, not checked): each form's largest
    # |d logit| / (1 + |logit|) from an fp64 evaluation of the plain version
    exact = gat_tiled.gat_stack_tiled_plain(
        x.double(), pw.double(), gtopo, m.flat.double(), m.dims, m.cfg.alpha,
        m.cfg.hidden_slope, edge_const=True)
    rel = lambda v: float(  # noqa: E731
        ((v.double() - exact).abs() / (1 + exact.abs())).max())
    note = f"; to fp64: kernels {rel(got):.3g}, plain {rel(ref):.3g}"
    if stack_topo is not None:
        st = gat_kernel.gat_stack(x, pw, stack_topo, m.flat, m.dims,
                                  m.cfg.alpha, m.cfg.hidden_slope,
                                  edge_const=True)
        torch.cuda.synchronize()
        serr = (got - st).abs()
        if bool((serr > GAT_RTOL * (1 + st.abs())).any()):
            raise AssertionError(f"tiled GAT {label}: disagrees with the "
                                 f"stack kernel: max |d logit| "
                                 f"{float(serr.max()):.3g}")
        note += (f", gat_stack {rel(st):.3g}; against gat_stack max |d "
                 f"logit| {float(serr.max()):.3g}")
    (k1b, k1f), (k2b, k2f) = tiled_costs(m.dims, gtopo.n_heads,
                                         gtopo.n_pairs, True)
    ms = median_ms(lambda: gat_tiled.gat_stack_tiled(*args, edge_const=True))
    plain = median_ms(lambda: gat_tiled.gat_stack_tiled_plain(
        *args, edge_const=True))
    b_ms, b_by = bound(k1b + k2b, k1f + k2f)
    print(f"  gat_tiled {label}: H={gtopo.n_heads} E={gtopo.n_pairs}, max "
          f"|d logit| {float(err.max()):.3g} (tol {GAT_RTOL:g} x "
          f"(1+|logit|)){note}; stack {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, {k1f + k2f} operations)")
    return float(err.max())


def time_tiled_kernels(label, x, pw, gtopo, m):
    """Median ms of all K1 calls and of all K2 calls of one stack, and of
    their plain versions on the same inputs; K1 and K2 report rows."""
    from mpe3d_tpu_torch.ops import gat_tiled
    args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope)
    k1s, k2s, _ = gat_tiled.cuda_layer_calls(*args, edge_const=True)
    for i, k1 in enumerate(k1s):
        k1()
        if i < len(k2s):
            k2s[i]()
    p1, p2 = gat_tiled.plain_layer_calls(*args, edge_const=True)
    costs = tiled_costs(m.dims, gtopo.n_heads, gtopo.n_pairs, True)
    rows = []
    for name, calls, plain, (b, f) in (("gat_k1", k1s, p1, costs[0]),
                                       ("gat_k2", k2s, p2, costs[1])):
        b_ms, b_by = bound(b, f)
        rows.append({
            "name": name, "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/gat_tiled.cu",
            "replaces": ("mpe3d_tpu/ops/gat_tiled.py:86" if name == "gat_k1"
                         else "mpe3d_tpu/ops/gat_tiled.py:225"),
            "launches": 0, "max_abs_err": None,
            "ms": median_ms(lambda c=calls: [k() for k in c]),
            "plain_ms": median_ms(lambda c=plain: [k() for k in c]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        r = rows[-1]
        dev, n_k = device_profile(lambda c=calls: [k() for k in c])
        r["device_ms"] = dev
        print(f"  {name} {label} ({len(calls)} calls a stack): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}: {b} bytes, {f} operations), "
              f"library None; device time alone (profiler) {dev:.4f} ms, "
              f"{n_k / len(calls):g} CUDA launches a call")
    return rows


def check_tiled_kernels(pipes, frames, report):
    """Phase 3, the tiled GAT kernels: Panoptic S=10 and S=16 with the
    trained and the random matcher; S=16 against the stack kernel (D=64,
    where both serve); a pruned, compacted S=16 call; an ARPLAB-shaped
    6 x 16 topology (E=3840, head degree 80) with a numpy-seeded matcher of
    in_dim 1082.  The K1/K2 rows come from the trained S=16 case."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import MatcherConfig
    from mpe3d_tpu_torch.matching.features import (build_topology,
                                                   edge_node_features)
    from mpe3d_tpu_torch.models.gat import gat_topology

    max_err, rows = 0.0, None
    for (mlabel, S, prune), pipe in pipes.items():
        x, pw, gtopo, form = pipe.gat_stage_inputs(frames[S])
        if form != "tiled":
            raise AssertionError(f"S={S}: resolved form {form!r}")
        label = (f"Panoptic S={S}, {mlabel}"
                 + (f", pruned to {gtopo.n_pairs} pairs" if prune else ""))
        stack_topo = None
        if S == 16 and not prune and mlabel == "trained":
            stack_topo = gat_topology(pipe.topology(S), GPU, "stack")
        max_err = max(max_err, check_tiled_case(label, x, pw, gtopo,
                                                pipe.matcher, stack_topo))
        if mlabel == "trained" and not prune:
            r = time_tiled_kernels(f"S={S}", x, pw, gtopo, pipe.matcher)
            rows = r if S == 16 else rows
    cfg = MatcherConfig(in_dim=1082)
    m = weights.matcher_from_tree(
        weights.random_matcher_tree(cfg, ARPLAB_MATCHER_SEED), cfg, GPU)
    topo = build_topology(6, 16)
    rng = np.random.default_rng(ARPLAB_MATCHER_SEED)
    heads = torch.tensor(rng.normal(size=(topo.n_heads, 1082)),
                         dtype=torch.float32)
    x = torch.cat([heads, edge_node_features(topo.n_pairs, 1082)]).to(GPU)
    pw = torch.tensor(rng.random(topo.n_pairs) < 0.8,
                      dtype=torch.float32).to(GPU)
    max_err = max(max_err, check_tiled_case(
        "ARPLAB-shaped 6 x 16 (D=80), random matcher", x, pw,
        gat_topology(topo, GPU, "tiled"), m))
    for r in rows:
        r["max_abs_err"] = max_err
    report.extend(rows)


def launch_counters():
    """Kernel name -> the wrapper function that counts its launches."""
    from mpe3d_tpu_torch.ops import (fused_mlp, fused_proj, frame_kernel,
                                     gat_kernel, gat_tiled)
    return {"gat_stack": gat_kernel.gat_stack,
            "gat_k1": gat_tiled.gat_k1_layer,
            "gat_k2": gat_tiled.gat_k2_layer,
            "frame_decode_pack": frame_kernel.frame_decode_pack,
            "mlp_run": fused_mlp.mlp_run,
            "gat_fused_proj": fused_proj.fused_linear_leaky_linear}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in launch_counters().items()}


def frame_slots(pipe, frame) -> int:
    """The slot bucket ``submit_fused`` serves a frame in."""
    return pipe._bucket(max(1, int(frame.present.sum(axis=1).max())))


def expected_launches(pipe, frames):
    """Kernel launches the resolved serving paths give these frames."""
    from mpe3d_tpu_torch.ops.fused_mlp import launch_plan
    want = dict.fromkeys(launch_counters(), 0)
    n_gat = len(pipe.matcher.dims)
    steps = [kind for kind, _, _ in launch_plan(pipe.lifter.packed_layers())]
    for f in frames:
        form, frame_path = pipe.serving_path(frame_slots(pipe, f))
        if form == "stack":
            want["gat_stack"] += 1
        elif form == "layer":
            want["gat_fused_proj"] += n_gat
        else:
            want["gat_k1"] += n_gat
            want["gat_k2"] += n_gat - 1
        want["frame_decode_pack"] += int(frame_path)
        want["mlp_run"] += steps.count("run")
    return want


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
    """Phase 4 and 5 for one pipeline: counters, finiteness, CPU agreement.
    Returns the launches, the median frame ms, the buckets' paths and the
    outputs."""
    import numpy as np
    import torch

    buckets = sorted({frame_slots(gpu, f) for f in frames})
    paths = {S: gpu.serving_path(S) for S in buckets}
    if paths != {S: cpu.serving_path(S) for S in buckets}:
        raise AssertionError(f"{label}: the CPU reference runs another path")
    frame_path = any(fp for _, fp in paths.values())
    for f in frames[:N_WARMUP]:
        gpu.infer_fused(f)
    if frame_path:
        check_no_host_sync(gpu, next(f for f in frames
                                     if paths[frame_slots(gpu, f)][1]))
    reset_launches()
    outs, times = [], []
    for f in frames:
        t0 = time.perf_counter()
        outs.append(gpu.infer_fused(f))
        times.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    want = expected_launches(gpu, frames)
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
        if not (np.array_equal(o.persons, r.persons)
                and o.persons.dtype == r.persons.dtype == np.int32):
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
    per_frame = {k: v / len(frames) for k, v in launches.items() if v}
    print(f"  {label}: buckets "
          + ", ".join(f"S={S} -> {form} matcher, "
                      + ("frame path" if fp else "eager path")
                      for S, (form, fp) in paths.items())
          + f"; persons per frame {[len(o.persons) for o in outs]}, "
          f"launches {launches} ({per_frame} a frame)"
          + ("; submit_fused raised no sync error under "
             "set_sync_debug_mode('error')" if frame_path else "")
          + f"; vs CPU: persons equal, max |d score| {max_ds:.3g}, max "
          f"|d pose| {max_dp:.3g} m, {near} scores within 1e-5 of the "
          f"threshold")
    print(f"  {label}: median frame {ms:.3f} ms (host clock, "
          f"{len(frames)} frames)", flush=True)
    return launches, ms, paths, outs


def frame_stage_times(pipe, frame):
    """Host ms of each stage of one frame-path frame, each stage ended by a
    device synchronize (mirrors PoseEstimationPipeline._run_frame; the
    scatter of pruned scores back to the bucket's pairs is left out)."""
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
        x, pw, gtopo, pairs, _ = pipe._gat_inputs(S, *args)
        mark("features" + (" + prune" if pipe.pair_prune_dist > 0 else ""))
        scores = pipe._scores(pipe._bucket_state(S), x, pw, gtopo)
        mark("gat")
        fargs, kw = pipe._frame_decode_args(S, scores, pw, *args[:4],
                                            pairs=pairs)
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
    import numpy as np
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
    from mpe3d_tpu_torch.models.gat import gat_topology
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
    for name in ("f64_gemm_kernel", "stack_out", "mlp_run_kernel",
                 "frame_decode_pack_kernel"):
        print(f"  ptxas, {name}: " + "; ".join(ptxas_report(
            lib.compiler_output, name)), flush=True)
    phase("build", t0, f"nvcc {lib.build_seconds:.1f} s; ptxas: "
          + ("; ".join(spills) if spills else "no spills"))

    t0 = time.perf_counter()
    rig_config = PANOPTIC
    rig = synthetic_ring_rig(rig_config)
    mtree, mcfg, ltree, lcfg, prior = load_trees(rig_config)
    rtree = weights.random_matcher_tree(mcfg, RANDOM_MATCHER_SEED)
    frames = [parse_frame(f, rig_config) for f in generate_frames(
        rig_config, rig, N_FRAMES, n_people=(2, 3), seed=1)]
    frames10 = [parse_frame(f, rig_config) for f in generate_frames(
        rig_config, rig, N_CROWDED, n_people=(6, 9), seed=3)]
    frames16 = [parse_frame(f, rig_config, max_skeletons=16)
                for f in generate_frames(rig_config, rig, N_FRAMES,
                                         n_people=(10, 14), seed=2)]

    def pipeline(tree, device, use_frame_kernel=None, slots=(4,),
                 persons=(8,), lifter_prior=prior, lifter=(ltree, lcfg),
                 **kw):
        return PoseEstimationPipeline(
            rig_config, rig, weights.matcher_from_tree(tree, mcfg, device),
            weights.lifter_from_tree(*lifter, device),
            slot_buckets=slots, person_buckets=persons,
            lifter_prior=lifter_prior, use_frame_kernel=use_frame_kernel,
            device=device, **kw)

    def int8_pipeline(tree, device, use_frame_kernel=None):
        """The int8-stored pair models_demo/pan_irls through from_checkpoint,
        served with the given matcher (pan_irls ships the matcher of
        pan_irls_bf16)."""
        pipe = PoseEstimationPipeline.from_checkpoint(
            DEMO_INT8, rig, rig_config, device=device, slot_buckets=(4,),
            person_buckets=(8,), use_frame_kernel=use_frame_kernel)
        pipe.matcher = weights.matcher_from_tree(tree, mcfg, device)
        return pipe

    # pan_compact's lifter (its matcher, the same file again, is left out of
    # chip copies)
    ctree, ccfg, cprior = load_lifter(DEMO_COMPACT, rig_config)

    matchers = {"trained": mtree, "random": rtree}
    gpu_r = pipeline(rtree, GPU)
    trained4 = pipeline(mtree, GPU)
    trained16 = pipeline(mtree, GPU, slots=(16,), persons=(16,))
    report = []
    check_kernels(gpu_r, frames[0], report)
    irls_gpu = int8_pipeline(rtree, GPU)
    check_int8_kernels(gpu_r, frames[0], irls_gpu.lifter,
                       weights.lifter_from_tree(ctree, ccfg, GPU), report,
                       report[-1]["ms"])
    x4, pw4, topo4, _ = trained4.stage_inputs(frames[0])
    x16, pw16, tiled16, _ = trained16.gat_stage_inputs(frames16[0])
    stack16 = gat_topology(trained16.topology(16), GPU, "stack")
    check_proj_kernel({"S=4, trained matcher": (x4, pw4, topo4,
                                                trained4.matcher),
                       "S=16, trained matcher": (x16, pw16, stack16,
                                                 trained16.matcher)}, report)
    check_frame_kernel(gpu_r, frames[0], trained16, frames16[0], report)
    check_tiled_kernels(
        {(m, S, prune): trained16 if (m, S, prune) == ("trained", 16, False)
         else pipeline(matchers[m], GPU, slots=(S,), persons=(16,),
                       pair_prune_dist=PRUNE_DIST_M if prune else 0.0)
         for m, S, prune in (("trained", 10, False), ("random", 10, False),
                             ("trained", 16, False), ("random", 16, False),
                             ("trained", 16, True))},
        {10: frames10[0], 16: frames16[0]}, report)
    check_stack_trained("S=4", x4, pw4, topo4, trained4.matcher)
    check_stack_trained("S=16", x16, pw16, stack16, trained16.matcher,
                        tiled_topo=tiled16)
    phase("kernels", t0, f"all {len(report)} kernels match their plain "
          f"versions")

    t0 = time.perf_counter()
    print(f"  lifter weights: trained, models_demo/pan_irls_bf16; "
          f"prior {prior!r}")
    main_launches, frame_ms, bf16_outs = None, {}, {}
    for mlabel, tree in matchers.items():
        gpu = pipeline(tree, GPU)
        if not gpu.frame_path_on():
            raise AssertionError("the frame path is not the default on the "
                                 "card")
        launches, ms, _, bf16_outs[mlabel] = run_main_path(
            gpu, pipeline(tree, "cpu", True), frames,
            f"{mlabel} matcher, frame path")
        main_launches = main_launches or launches
        _, ms_eager, _, _ = run_main_path(pipeline(tree, GPU, False),
                                          pipeline(tree, "cpu", False),
                                          frames, f"{mlabel} matcher, eager "
                                          f"path")
        frame_ms[mlabel] = (ms, ms_eager)
        stage_table(gpu, frames, mlabel)
    phase("main path", t0, "infer_fused on the card agrees with the CPU on "
          "both paths; median frame ms (frame path / eager path): "
          + "; ".join(f"{m} matcher {a:.3f} / {b:.3f}"
                      for m, (a, b) in frame_ms.items()))

    t0 = time.perf_counter()
    print("  lifter weights: int8-stored models_demo/pan_irls (8 int8 "
          "layers, a bf16 head; the recipe of pan_irls_bf16) and "
          "models_demo/pan_compact")
    int8_launches, int8_ms = None, {}
    for mlabel, tree in matchers.items():
        gpu = irls_gpu if mlabel == "random" else int8_pipeline(tree, GPU)
        if gpu.serve_dtype != "int8" or not gpu.frame_path_on():
            raise AssertionError(f"pan_irls serves {gpu.serve_dtype}, frame "
                                 f"path {gpu.frame_path_on()}")
        launches, ms, _, outs = run_main_path(
            gpu, int8_pipeline(tree, "cpu", True), frames,
            f"pan_irls (int8), {mlabel} matcher, frame path")
        if launches["mlp_run"] != len(frames):
            raise AssertionError(f"pan_irls: lifter launches {launches}, "
                                 f"not one a frame")
        int8_launches = int8_launches or launches
        _, ms_eager, _, _ = run_main_path(
            int8_pipeline(tree, GPU, False), int8_pipeline(tree, "cpu", False),
            frames[:N_SHORT], f"pan_irls (int8), {mlabel} matcher, eager "
            f"path")
        d_pose = max([float(np.abs(a.poses - b.poses).max())
                      for a, b in zip(outs, bf16_outs[mlabel])
                      if len(a.poses)] or [0.0])
        print(f"  pan_irls (int8) against pan_irls_bf16 on the same frames, "
              f"{mlabel} matcher (information, not a check): max |d pose| "
              f"{d_pose:.4g} m")
        int8_ms[mlabel] = (ms, ms_eager)
        compact = dict(lifter=(ctree, ccfg), lifter_prior=cprior)
        run_main_path(pipeline(tree, GPU, **compact),
                      pipeline(tree, "cpu", True, **compact),
                      frames[:N_SHORT],
                      f"pan_compact (int8), {mlabel} matcher, frame path")
    phase("int8 path", t0, "int8 pairs on the card agree with the CPU; "
          "median frame ms, frame path / eager path (bf16 pair, frame path, "
          "same call): "
          + "; ".join(f"{m} matcher {a:.3f} / {b:.3f} ({frame_ms[m][0]:.3f})"
                      for m, (a, b) in int8_ms.items()))

    t0 = time.perf_counter()
    layer_launches, layer_ms = None, {}
    for (blabel, kw, lframes), mlabel in (
            (b, m) for b in (("S=4", {}, frames[:N_SHORT]),
                             ("S=10 buckets (2, 4, 10)/(4, 8, 16)",
                              dict(slots=(2, 4, 10), persons=(4, 8, 16),
                                   lifter_prior=CROWDED_PRIOR), frames10))
            for m in matchers):
        label = f"layer form {blabel}, {mlabel} matcher, eager path"
        launches, ms, paths, _ = run_main_path(
            pipeline(matchers[mlabel], GPU, False, use_layer_matcher=True,
                     **kw),
            pipeline(matchers[mlabel], "cpu", False, use_layer_matcher=True,
                     **kw), lframes, label)
        if (any(form != "layer" for form, _ in paths.values())
                or launches["gat_fused_proj"] != 5 * len(lframes)
                or launches["gat_stack"] + launches["gat_k1"]
                + launches["gat_k2"]):
            raise AssertionError(f"{label}: paths {paths}, launches "
                                 f"{launches}")
        layer_launches = layer_launches or launches
        layer_ms[label] = ms
    phase("layer path", t0, "the per-layer GAT form on the card agrees with "
          "the CPU; median frame ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in layer_ms.items()))

    t0 = time.perf_counter()
    print(f"  crowded runs: lifter prior {CROWDED_PRIOR!r}; pruning "
          f"pair_prune_dist={PRUNE_DIST_M} m, cap auto max(256, E // 2)")
    crowded_launches, crowded_ms = None, {}
    for (blabel, slots, persons, cframes), mlabel, prune in (
            (b, m, p) for b in (("S=16", (16,), (16,), frames16),
                                ("S=10", (2, 4, 10), (4, 8, 16), frames10))
            for m in ("trained", "random") for p in (False, True)):
        kw = dict(slots=slots, persons=persons, lifter_prior=CROWDED_PRIOR,
                  pair_prune_dist=PRUNE_DIST_M if prune else 0.0)
        gpu = pipeline(matchers[mlabel], GPU, **kw)
        run_frames = (cframes if (blabel, mlabel, prune)
                      == ("S=16", "trained", False) else cframes[:N_CROWDED])
        label = (f"{blabel} buckets {slots}/{persons}, {mlabel} matcher, "
                 f"pruning {'on' if prune else 'off'}")
        launches, ms, paths, _ = run_main_path(
            gpu, pipeline(matchers[mlabel], "cpu", True, **kw), run_frames,
            label)
        if not all(fp for _, fp in paths.values()):
            raise AssertionError(f"{label}: a bucket is off the frame path")
        if (blabel, mlabel, prune) == ("S=16", "trained", False):
            crowded_launches = launches
        crowded_ms[label] = ms
        if mlabel == "trained":
            stage_table(gpu, run_frames[:N_CROWDED], label)
    # each row's launches from the run of the path that serves it
    path_launches = {"mpe3d_tpu/ops/gat_tiled.py:86": crowded_launches,
                     "mpe3d_tpu/ops/gat_tiled.py:225": crowded_launches,
                     "mpe3d_tpu/ops/fused_mlp.py:80": int8_launches,
                     "mpe3d_tpu/ops/quant_matmul.py:73": int8_launches,
                     "mpe3d_tpu/ops/fused_proj.py:48": layer_launches}
    for k in report:
        k["launches"] = path_launches.get(k["replaces"],
                                          main_launches)[k["name"]]
    missing = [k["name"] for k in report if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    phase("crowded path", t0, "infer_fused on the card agrees with the CPU "
          "on every crowded bucket; median frame ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in crowded_ms.items()))

    # a device time the profiler did not record is not measured: null
    for k in report:
        if k["device_ms"] != k["device_ms"]:
            k["device_ms"] = None
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
