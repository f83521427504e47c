#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line with what it checked and its wall time; any
failure raises, and the script exits non-zero):

1. env: torch/CUDA versions, the card's name and power limit.
2. build: the ``nvcc`` calls that build the CUDA kernels of
   ``mpe3d_tpu_torch/csrc`` (one a source, all at once, and a link; 0 s
   when the build cache matches), the ``g++``
   build of the C++ wire parser (``mpe3d_tpu_torch/native``), and
   ptxas's registers, shared memory and spills of the fp64 tensor-core GEMM
   shared by the three GAT kernels (one copy in each of their sources), the
   stack kernel's output kernel, the lifter's run kernel (each of its row
   classes) and the decode + gather + pack kernel.
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the serving path gives it (Panoptic rig, S=4 slots, P=8
   persons), with median times over 50 launches (CUDA events) beside the
   plain version's, the card's bound and a PyTorch yardstick where one
   exists.  The decode + gather + pack kernel is checked for every prior
   (mean, median, IRLS) with and without the prior gate, and on a frame
   whose observations pass its shared-memory staging limit (the unstaged
   gather).  The tiled GAT kernels (K1, K2) are checked at Panoptic S=10
   and S=16 with the trained and a random matcher, on an ARPLAB-shaped
   6 x 16 topology (head degree 80, past the stack kernel's cap), on a
   pruned, compacted edge set, on a hand-made compacted set with heads of
   degree 0 and 300, and at S=16 against the stack kernel too; in each
   case the stack as one host call is bit-equal across two calls and to
   the per-layer calls run in order, the incidence list equals its plain
   version, and K2 of each layer alone (on the plain K1's state) is held
   to its plain version.  The lifter's run kernel
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
   calls.  The run kernel past 16 rows: the whole bf16 and int8 nets as
   one launch at M = 16, 32, 64 and 50 against ``run_plain``, two launches
   bit-equal, the M=64 launch's device time in turns against the four
   M=16 launches it replaces (it must be shorter), the int8 layers alone
   at M=64 (one launch a layer); the wide row classes (65-256 rows, wgmma)
   on the bf16 Panoptic, int8 ``pan_irls`` and bf16 ARPLAB nets at M = 96,
   250, 252 and 256 against ``run_plain``, two launches bit-equal, each
   in turns against the 64-row launches it replaces (it must be shorter)
   and with the library chain; the decode kernel over a batch (a block a
   frame) on 8 S=4 and 6 S=16 frames against its plain version frame by
   frame.  At the shapes of phase 8 (rows with a "case"): the stack kernel
   at ARPLAB S=4 (in_dim 1082, head degree 20; the trained matcher also
   against fp64), at BODY_25's in_dim 1252 and alt-2's 362; K1/K2 at
   ARPLAB S=10 (H=60, E=1500, D=50), both matchers; the run kernel on a
   bf16 ARPLAB lifter (K0=1512) at M=8 and M=16-64 (M=64 in turns against
   four M=16 launches) and on a BODY_25 lifter (K0=1750, a 75-wide head);
   ``arp_irls``'s 8 int8 layers as one run and one layer at a time; the
   decode at Cu=6 (IRLS and median priors: 15 camera pairs) and J=25,
   every prior and gate; the projection on a residual matcher's five
   layer inputs and on the layer inputs at ARPLAB S=4, BODY_25 and alt-2
   (timed in turns with the addmm chain).  Every kernel row also carries
   its device time
   (torch.profiler), and the GAT kernels print their CUDA launches a call.
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
   one lifter run launch a frame, beside the bf16 pair's frame time;
   ``pan_compact``, the shipping pair ``pan_res`` (int8 lifter, median
   prior) and ``pan_lowview_bf16`` (bf16 lifter, IRLS prior) on 6 frames
   of the frame path each, both matchers; and the per-layer
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
6. serve path: (a) ``python3 -m mpe3d_tpu_torch serve --modelsdir
   models_demo/pan_irls_bf16 --track --quality-gate G --warmup`` as a
   subprocess on the card at depth 3 and at depth 1, fed the 16 S=4 frames,
   the 6 S=10 frames, a malformed line, ping, stats, a reload to
   ``pan_lowview_bf16``, the S=10 frames again and close; every record must
   equal the port's PoseServer in this process on a CPU pipeline of the
   same pairs (seq order, persons, track ids, control, error and reload
   records; poses to ``POSE_TOL_M``, quality to ``QUALITY_TOL_PX`` +
   ``QUALITY_RTOL`` x q), the gate
   G (the middle of the widest gap of the CPU's qualities in their lower
   half) must drop some poses and keep some, and the C++ parser must have
   read every frame line; (b) ``PoseThreadingTCPServer`` on a card
   pipeline of ``pan_res`` with two clients at once (the S=10 frames twice,
   the S=4 frames), each client's records equal to the CPU's with a fresh
   tracker, the kernels' launches of the run as its buckets' paths give
   them; (c) ``infer_stream`` at depth 1 and 3 bit-equal to an
   ``infer_fused`` loop, with the trained matcher and, after
   ``reload_weights``, the random one; (d) prints the median ``latency_ms``
   at depth 1 and 3, the frames per second of ``infer_stream(depth=3)``
   against the ``infer_fused`` loop in turns, and the C++ parser's
   microseconds a frame line beside ``json.loads`` + ``parse_frame``, each
   with the card's name and power limit.

7. batch and staged paths: ``infer_batch`` of the 16 S=4 frames (buckets
   (4,) / (8,)) and of the 6 S=10 frames (default buckets, "mean" prior)
   for ``pan_irls_bf16`` and the int8 ``pan_irls``, trained and random
   matcher: the kernels' launches of the key's first (eager) batch as
   ``batch_plan`` gives them (one GAT call on the union of the frames'
   graphs, one decode launch, a lifter launch a group of 64 rows), the
   second (captured into a CUDA graph) under
   ``set_sync_debug_mode("error")``, the captured and the replayed batch
   bit-equal to the eager one, persons equal to the card's
   ``infer_fused`` and to the CPU's ``infer_batch``, scores within
   ``SCORE_TOL``, poses within ``POSE_TOL_M``; the batch graphs at each
   batch cell's shapes (Panoptic S=4 x 100 frames, ARPLAB S=4 x 84,
   Panoptic S=16 x 24), a ``pad_to=4`` micro-batch and a key after
   ``reload_weights``: the captured batch and replays with two batches in
   flight bit-equal to the eager body's, the lifter's cooperative
   ``mlp_run`` launch captured and replayed alone bit-equal, each key's
   capture seconds, graph pool bytes and submit host ms eager against
   replayed; ``pipe(frame)`` (the staged
   path) with host and device decode, the triangulation backend (median,
   IRLS) and geo rerank against the CPU; ``serve --batch-window 4`` over
   stdio against ``--batch-window 1``; then the frames per second of
   ``infer_batch`` of 8 frames against the ``infer_fused`` loop in turns,
   a batch's CUDA launches and device time (profiler), and the M=64 run's
   device time against four M=16 runs, each with the card's name and
   power limit.

8. second rig and graph variants: ARPLAB (6 cameras, a synthetic ring
   rig) with ``models_demo/arp_irls`` (int8 lifter, IRLS prior) and a
   bf16 lifter made from its weights (dequantized, the median prior),
   each with the trained matcher and a numpy-seeded one that decodes
   every present pair: ``infer_fused`` on 16 S=4 frames (stack form,
   frame path) and 6 S=10 frames (tiled form, "mean" prior) against the
   CPU, the kernels' launch counts, the frame path's stages and busy
   share; ``infer_batch`` of the 16 S=4 frames; ``python3 -m
   mpe3d_tpu_torch serve --rig ARPLAB`` over stdio (random matcher on
   ``arp_irls``'s lifter) against a CPU PoseServer.  Then BODY_25 (random
   weights at full width) on the frame path, and the alt-2 graph, the
   alt-1 graph and a residual matcher (random, full width, the Panoptic
   lifter) on the eager path the reference's gate gives them, each on 6
   frames against the CPU; ARPLAB, BODY_25 and alt-2 also through the
   layer form (eager path, ``use_layer_matcher``).  The rows of phase 3
   at these shapes take their launches from these runs.

9. evaluation and label-free lifter training: ``train_lifter`` at full
   width (Panoptic ring rig, in_dim 1260, 29.09 M weights) for two epochs
   of two batches of 256 (``shuffle=False``) on single-person samples, on
   the card and on the CPU from the same numpy init, per-epoch train and
   dev losses within ``TRAIN_RTOL``, then warm for the card's epoch times;
   then trained on, on the card, for 40 epochs toward the largest AP
   threshold (its MPJPE on the evaluation's 16 GT frames, random matcher,
   before and after, and the IRLS triangulation's on the same decoded
   groups, printed);
   the trained lifter saved, loaded by ``from_checkpoint`` (served bf16
   through ``mlp_run``) and evaluated by ``run_pose_metrics`` on 16 GT
   frames, ``fused`` and ``stream=3``, trained and random matcher, on the
   card and the CPU (counts equal, MPJPE within ``POSE_TOL_M``, AP and
   recall equal unless a pose lies within ``POSE_TOL_M`` of a threshold;
   the kernels' launches as the buckets' paths give them), and the
   triangulation backend the same way; ``sm-metrics`` and
   ``reprojection-error`` in this process on the card against ``--cpu``;
   ``train-lifter --epochs 2`` and ``metrics-from-model --fused`` as
   subprocesses on the card in a temporary models directory.  Reads no
   demo directory the earlier phases do not.

10. matcher training and the model files: ``train_matcher`` at full width
   (in_dim 902, hidden (40, 40, 40, 30), heads (10, 10, 8, 5)) on about
   150 train / 45 dev S=4 composite scenes of three single-person
   recordings, batch 15, 3 epochs, numpy's order (``scan_epoch=False``),
   on the card and on the CPU from one numpy init, per-epoch train and dev
   losses within ``TRAIN_RTOL`` (MSE, and BCE with ``prune_dist`` 0.2);
   warm, its epoch times and training scenes a second, and 10 steps alone
   with their device time; the shipped matcher fine-tuned on the card
   (the scan path) and served by ``infer_fused`` at S=4 (stack form) and
   at the default buckets on the S=10 frames (tiled form) with the
   shipped and a random lifter, persons equal to the CPU's;
   ``--device-synth`` training on the card and its scenes' marginals
   against the host and CPU synthesisers; ``export-torch`` /
   ``convert-torch`` in this process (``pan_irls_bf16``'s residual-prior
   lifter refused; its matcher with the phase 9 lifter converted both
   ways), the reference-format directory and the converted npz served
   against the CPU and equal to the npz pair on the card, a residual
   matcher's ``.tch`` through the layer form (``gat_fused_proj``);
   ``export-servable --dtype int8`` and ``bf16`` of the phase 9 lifter
   served in their kind (``mlp_run``) against the CPU; ``infer
   --profile-trace`` on the card, its trace naming the kernels the frames
   launched and its records those of the run without it.

11. the Panoptic conversor and the viewers: (a) seeded HD uint8 images
   through the card's ``resize_linear`` (cv2's INTER_LINEAR in integers)
   bit-equal to the CPU's; (b) ``Detector2D`` at full width
   (PoseResNet-50 on 960x512, numpy-seeded He weights, the head scaled per
   channel so that ``DETECT_HOT`` cells pass 0.15) against its plain run on
   the CPU: heatmaps within ``HEAT_RTOL``, peaks equal but where a cell
   lies within that of the threshold or of its window's maximum (counted),
   then its call ms, device ms, CUDA launches and bound; (c) Gaussian-blob
   heatmaps [18, 128, 240] through the peaks, counts and peaks equal to
   the CPU's, coordinates within ``REFINE_TOL``; (d) ``convert_sequence`` on a synthetic 5-camera HD sequence (the
   module's image reader replaced by seeded arrays, so OpenCV need not be
   installed), the first frame against the CPU's, the output parsed as
   wire frames, a frame's 5 cameras timed; (e) ``show-results --out
   .html`` on the card against ``--cpu`` (persons, track ids and GT equal,
   poses within ``POSE_TOL_M``), the stack GAT and lifter kernels
   launched, frames a second; (f) ``show-results --live 0`` as a
   subprocess, its SSE events read over HTTP against the CPU's
   ``infer_fused``, then SIGINT and exit code 0.  Each time is printed
   with the card's name and power limit.

12. checkpoints, parallel training and multi-device serving: probes
   (libzstd.so.1, tensorstore, the cards, NCCL); (b) phase 9's lifter
   trained with ``checkpoint_backend="orbax"`` (saves on the saver
   thread), its checkpoint and a params + Adam save read back bit for bit,
   a leg resumed from disk equal to one resumed from memory, and the
   committed JAX-written OCDBT fixture against its npz twin; (c) a 2-rank
   gloo world on cuda:0 (ranks: this script with ``--parallel-worker``)
   trains the lifter data- and tensor-parallel and the matcher
   data-parallel, and a 1-rank NCCL world the lifter, each against the
   one-process card run at the same global batch within ``PAR_TOL``; the
   same gloo world runs each task again with a planted fault
   (``FAULTS``), which must break both limits; epoch seconds and rates
   at 1 and 2 ranks; (d) two serving replicas on cuda:0 against one
   device, ``infer_batch`` over a 2-device mesh, ``serve --multi-device``
   against ``serve``.

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
# the shipping pair (int8, median prior) and a bf16 IRLS-prior pair
DEMO_PAIRS = {name: os.path.join(ROOT, "models_demo", name)
              for name in ("pan_res", "pan_lowview_bf16")}

N_FRAMES, N_WARMUP, N_TIMED = 16, 3, 50
N_CROWDED = 6              # frames of each crowded run but the reported one
N_SHORT = 6                # frames of the int8 eager, pan_compact and layer runs
RANDOM_MATCHER_SEED = 0    # its scores sit above the 0.5 threshold
ARPLAB_MATCHER_SEED = 1
COMPACT_SEED = 5           # the hand-made compacted tiled GAT case
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
# the decode kernel's shared-memory staging limit for a frame's observations
# (STAGE_LIMIT, csrc/frame_decode_pack.cu)
STAGE_LIMIT = 160 * 1024
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
    _, library = bf16_library(layers, slope)
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

        lib = lambda x=x: library(x)  # noqa: E731
        ms, lib_ms = in_turns(run, lib)
        bytes_, flops = run_costs(layers, x)
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
              f"{device_ms(lib):.4f} ms")
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


def run_costs(layers, x):
    """(bytes, operations) of the given packed lifter layers as ONE run
    launch on the rows x [M, K]: x read once, the last layer's M rows
    written once, every weight, scale and bias read once (what the function
    must move: the activations between its layers are its own); 2 M K N
    operations a layer."""
    from mpe3d_tpu_torch.ops.fused_mlp import layer_shape
    M = x.shape[0]
    shapes = [layer_shape(layer) for layer in layers]
    bytes_ = (4 * x.numel() + 4 * M * shapes[-1][1]
              + sum(t.numel() * t.element_size()
                    for layer in layers for t in layer))
    return bytes_, sum(2 * M * K * N for K, N in shapes)


def mlp_costs(layers, M):
    """(bytes, operations) of the given packed lifter layers on M rows as a
    launch a layer: each layer's input rows, weights, scales and bias read
    once, its output written once; 2 M K N operations a layer."""
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
    (``int8_layer_matmul``: a run of the one layer a group of at most 64
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
    lifter rows of a random-matcher frame) and at M=40 (one run a
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
    one_run = lambda: fused_mlp.run_layers(nets, body, slope, acts)  # noqa
    alone = lambda: [quant_matmul.int8_layer_matmul(h, layer, slope)  # noqa
                     for h, layer in inputs]
    plain_run = lambda: fused_mlp.run_plain(nets, body, slope, acts)  # noqa
    plain_alone = lambda: [fused_mlp.layer_plain(h, layer, slope, True)  # noqa
                           for h, layer in inputs]
    lib = lambda: library(nets)  # noqa: E731
    rows, bounds = [], []
    for replaces, kernel, plain, (bytes_, flops) in (
            ("mpe3d_tpu/ops/fused_mlp.py:80", one_run, plain_run,
             run_costs(body, nets)),
            ("mpe3d_tpu/ops/quant_matmul.py:73", alone, plain_alone,
             mlp_costs(body, M))):
        ms, lib_ms = in_turns(kernel, lib)
        t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
        bound_ms = 1e3 * max(t_b, t_f)
        bound_by = "bytes" if t_b > t_f else "operations"
        bounds.append(f"{bound_ms:.5f} ms ({bound_by}: {bytes_} bytes)")
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
    c_bytes, _ = run_costs(clayers[:-1], nets)
    print(f"  mlp_run (int8 kind): pan_irls, its 8 int8 layers as one run on "
          f"{M} rows: {a['ms']:.4f} ms, device {a['device_ms']:.4f} ms; "
          f"each a run of one layer (int8_layer_matmul, 8 launches): "
          f"{b['ms']:.4f} ms, device {b['device_ms']:.4f} ms; plain "
          f"{a['plain_ms']:.4f} / {b['plain_ms']:.4f} ms; bound "
          f"{bounds[0]} / {bounds[1]}; library ({label},"
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
                               m.cfg.hidden_slope, proj=record,
                               bias=m.cfg.bias, shortcuts=m.shortcuts())
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
    eligible pairs: the kernel's bitonic sort); and the consistency-scored
    frame with its slots padded with empty ones past the kernel's staging
    limit, for every prior and gate (the unstaged gather).  The crowded
    frame is not scored by the random matcher: it groups unrelated
    skeletons at S=16, and IRLS on such groups is ill-conditioned (the
    plain version's prior moved 0.047 decameters under a 1e-7 relative
    change of the pixels), so no fp32 tolerance holds there."""
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
    # the frame's slots padded with empty ones until its observations
    # (25 bytes a used camera, slot and joint) no longer fit the kernel's
    # shared-memory staging (STAGE_LIMIT in csrc/frame_decode_pack.cu): the
    # gather reads them from device memory instead (the unstaged gather)
    Cu, S, J = cargs[4].shape[:3]
    S_pad = STAGE_LIMIT // (25 * Cu * J) + 1
    if ckw["n_cameras"] * S_pad > fk.MAX_HEADS:
        raise AssertionError(f"{S_pad} slots exceed the kernel's heads")

    def pad_slots(t):
        return torch.cat([t, t.new_zeros((Cu, S_pad - S) + t.shape[2:])], 1)

    unstaged = cargs[:4] + tuple(map(pad_slots, cargs[4:8])) + cargs[8:]
    check_frame_cases(unstaged, ckw, cases,
                      f"S=16 padded to {S_pad} slots (unstaged gather, "
                      f"{25 * Cu * S_pad * J} bytes of observations)")
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
    edge_const), attention terms, edge softmax and masked logits (K1), and
    of the head max, exp-shifted weights, head sums and epilogue (K2).
    K2's bytes also count the incidence build, once a stack: the endpoints
    read, the list [2E] and its head offsets [H+1] written."""
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
        k1f += 4 * E * nh                          # masked logits
        k1b += 4 * (E * F + 2 * E * nh)
        k2f += 2 * E * nh + 3 * H * nh             # head max
        k2f += 8 * E * nh + 4 * E * F + 4 * H * F
        # l1m, l2m, pw, the list and its offsets, z's edge and head rows,
        # att's head rows read; the head rows written
        k2b += 4 * (2 * E * nh + E + 2 * E + H + 1
                    + (1 if const else E) * F + 2 * H * F + 2 * H * nh)
    k2b += 4 * (2 * E + 2 * E + H + 1)             # the incidence build
    return (k1b, k1f), (k2b, k2f)


def bound(bytes_, flops):
    """(bound ms, what bounds it) at the H100's fp32 and memory peaks."""
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b > t_f else "operations"


def check_k2_alone(label, x, pw, gtopo, m):
    """The incidence build against ``incidence_plain``, then K2 of each
    layer but the last alone, on the plain K1's state of that layer (z,
    the attention terms, l1m/l2m) and the built list, against
    ``k2_plain`` within GAT_RTOL x (1 + |out|).  Returns K2's largest
    |d out|."""
    import torch
    from mpe3d_tpu_torch.ops import gat_tiled
    from mpe3d_tpu_torch.ops.gat_kernel import layer_views
    H, E = gtopo.n_heads, gtopo.n_pairs
    alpha, slope = m.cfg.alpha, m.cfg.hidden_slope
    stream = torch.cuda.current_stream().cuda_stream
    inc = torch.empty(H + 1 + 2 * E, dtype=torch.int32, device=GPU)
    gat_tiled.gat_tiled_incidence(gtopo.e1.data_ptr(), gtopo.e2.data_ptr(),
                                  H, E, inc.data_ptr(),
                                  inc.data_ptr() + 4 * (H + 1), stream)
    ptr, ent = gat_tiled.incidence_plain(gtopo.e1, gtopo.e2, H)
    torch.cuda.synchronize()
    if not (torch.equal(inc[:H + 1], ptr) and torch.equal(inc[H + 1:], ent)):
        raise AssertionError(f"tiled GAT {label}: the incidence list differs "
                             f"from incidence_plain")
    e1, e2 = gtopo.e1.long(), gtopo.e2.long()
    xin, worst = x, 0.0
    for l, ((_, d, nh), lw) in enumerate(zip(m.dims[:-1],
                                             layer_views(m.flat, m.dims))):
        const = l == 0
        xe, state = gat_tiled.k1_plain(xin, pw, e1, e2, H, lw, nh, d, alpha,
                                       slope, False, const)
        z, a1, a2, l1m, l2m = state
        ref = gat_tiled.k2_plain(state, pw, e1, e2, H, nh, d, alpha, slope,
                                 const)
        z = z.reshape(z.shape[0], -1).contiguous()
        att = torch.cat([a1, a2], 1).contiguous()
        l1m, l2m = l1m.contiguous(), l2m.contiguous()
        out = torch.full((H + E, nh * d), float("nan"), device=GPU)
        gat_tiled.gat_k2_layer(l1m.data_ptr(), l2m.data_ptr(), pw.data_ptr(),
                               inc.data_ptr(), inc.data_ptr() + 4 * (H + 1),
                               z.data_ptr(), att.data_ptr(), H, nh, d,
                               int(const), alpha, slope, out.data_ptr(),
                               stream)
        torch.cuda.synchronize()
        got = out[:H]
        err = (got - ref).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > GAT_RTOL * (1 + ref.abs())).any()):
            raise AssertionError(f"K2 {label} layer {l}: max |d out| "
                                 f"{float(err.max()):.3g} from k2_plain")
        worst = max(worst, float(err.max()))
        xin = torch.cat([ref, xe])
    return worst


def check_tiled_case(label, x, pw, gtopo, m, stack_topo=None):
    """The tiled stack (one host call) against its plain version on the
    card, two calls bit-equal and bit-equal to the per-layer calls
    (``cuda_layer_calls``) run in order; the incidence list and K2 of each
    layer alone (``check_k2_alone``); against the stack kernel when
    ``stack_topo`` is given.  Prints the call ms, the plain ms and the
    bound.  Returns the largest |d logit| and K2's largest |d out|."""
    import torch
    from mpe3d_tpu_torch.ops import gat_kernel, gat_tiled
    args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope)
    got = gat_tiled.gat_stack_tiled(*args, edge_const=True)
    again = gat_tiled.gat_stack_tiled(*args, edge_const=True)
    k1s, k2s, by_layer = gat_tiled.cuda_layer_calls(*args, edge_const=True)
    for i, k1 in enumerate(k1s):
        k1()
        if i < len(k2s):
            k2s[i]()
    ref = gat_tiled.gat_stack_tiled_plain(*args, edge_const=True)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > GAT_RTOL * (1 + ref.abs())).any()):
        raise AssertionError(f"tiled GAT {label}: kernels disagree with the "
                             f"plain version: max |d logit| "
                             f"{float(err.max()):.3g}")
    if not (torch.equal(got, again) and torch.equal(got, by_layer)):
        raise AssertionError(f"tiled GAT {label}: two calls, or the call and "
                             f"the per-layer calls, differ")
    k2_err = check_k2_alone(label, x, pw, gtopo, m)
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
    call = lambda: gat_tiled.gat_stack_tiled(*args,  # noqa: E731
                                             edge_const=True)
    ms, (dev, n_k) = median_ms(call), device_profile(call)
    plain = median_ms(lambda: gat_tiled.gat_stack_tiled_plain(
        *args, edge_const=True))
    b_ms, b_by = bound(k1b + k2b, k1f + k2f)
    deg = torch.bincount(torch.cat([gtopo.e1, gtopo.e2]).long(),
                         minlength=gtopo.n_heads)
    print(f"  gat_tiled {label}: H={gtopo.n_heads} E={gtopo.n_pairs} (head "
          f"degree {int(deg.min())}-{int(deg.max())}), max |d logit| "
          f"{float(err.max()):.3g} (tol {GAT_RTOL:g} x (1+|logit|)); K2 "
          f"alone, each layer, max |d out| {k2_err:.3g}; incidence list "
          f"equal to incidence_plain; two calls and the per-layer calls "
          f"bit-equal{note}; stack (one host call) {ms:.4f} ms, device "
          f"{dev:.4f} ms, {n_k:g} CUDA launches a call; plain {plain:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}, {k1f + k2f} operations)")
    return float(err.max()), k2_err


def time_tiled_kernels(label, x, pw, gtopo, m):
    """Median ms of all K1 calls and of all K2 calls of one stack (the
    first K2 call builds the incidence list), of their plain versions on
    the same inputs, and of the whole stack as one host call; K1 and K2
    report rows."""
    from mpe3d_tpu_torch.ops import gat_tiled
    from mpe3d_tpu_torch.tools import gat_timing
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
        dev, n_k, by_name = gat_timing.device_profile(
            lambda c=calls: [k() for k in c])
        r["device_ms"] = dev
        print(f"  {name} {label} ({len(calls)} calls a stack): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}: {b} bytes, {f} operations), "
              f"library None; device time alone (profiler) {dev:.4f} ms, "
              f"{n_k / len(calls):g} CUDA launches a call; device ms by "
              f"kernel: " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in by_name.items()))
    call = lambda: gat_tiled.gat_stack_tiled(*args,  # noqa: E731
                                             edge_const=True)
    ms = median_ms(call)
    dev, n_k = device_profile(call)
    print(f"  gat_stack_tiled {label}, one host call: {ms:.4f} ms, device "
          f"{dev:.4f} ms ({n_k:g} CUDA launches), host overhead "
          f"{ms - dev:.4f} ms")
    return rows


def compacted_topology(H, E, seed, empty, busy, busy_deg):
    """A compacted edge set (random endpoints, in no edge order) in which
    head ``empty`` has no edge and head ``busy`` has ``busy_deg``."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.ops.gat_kernel import GatTopology
    rng = np.random.default_rng(seed)
    others = np.array([h for h in range(H) if h not in (empty, busy)])
    e1, e2 = rng.choice(others, E), rng.choice(others, E)
    hit = rng.choice(E, busy_deg, replace=False)
    side = rng.random(busy_deg) < 0.5
    e1[hit[side]], e2[hit[~side]] = busy, busy
    as_t = lambda a: torch.tensor(a, dtype=torch.int32,  # noqa: E731
                                  device=GPU)
    return GatTopology(as_t(e1), as_t(e2), H)


def check_tiled_kernels(pipes, frames, report):
    """Phase 3, the tiled GAT kernels: Panoptic S=10 and S=16 with the
    trained and the random matcher; S=16 against the stack kernel (D=64,
    where both serve); a pruned, compacted S=16 call; an ARPLAB-shaped
    6 x 16 topology (E=3840, head degree 80) with a numpy-seeded matcher of
    in_dim 1082; a hand-made compacted set of 1200 pairs on the S=16 heads
    with a head of degree 0 and one of degree 300 (past K2's 256-entry
    staging chunk), the random matcher.  The K1/K2 rows come from the
    trained S=16 case; their errors are the largest of all cases (K1: the
    logits; K2: each layer alone)."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.matching.features import edge_node_features
    from mpe3d_tpu_torch.models.gat import gat_topology
    from mpe3d_tpu_torch.tools import gat_timing

    max_err, k2_err, rows = 0.0, 0.0, None

    def case(*args, **kw):
        nonlocal max_err, k2_err
        err, k2 = check_tiled_case(*args, **kw)
        max_err, k2_err = max(max_err, err), max(k2_err, k2)

    for (mlabel, S, prune), pipe in pipes.items():
        x, pw, gtopo, form = pipe.gat_stage_inputs(frames[S])
        if form != "tiled":
            raise AssertionError(f"S={S}: resolved form {form!r}")
        label = (f"Panoptic S={S}, {mlabel}"
                 + (f", pruned to {gtopo.n_pairs} pairs" if prune else ""))
        stack_topo = None
        if S == 16 and not prune and mlabel == "trained":
            stack_topo = gat_topology(pipe.topology(S), GPU, "stack")
        case(label, x, pw, gtopo, pipe.matcher, stack_topo)
        if mlabel == "trained" and not prune:
            r = time_tiled_kernels(f"S={S}", x, pw, gtopo, pipe.matcher)
            rows = r if S == 16 else rows
    random16 = pipes["random", 16, False].matcher
    topo = compacted_topology(80, 1200, COMPACT_SEED, empty=3, busy=7,
                              busy_deg=300)
    rng = np.random.default_rng(COMPACT_SEED)
    in_dim = random16.cfg.in_dim
    x = torch.cat([torch.tensor(rng.normal(size=(80, in_dim)),
                                dtype=torch.float32),
                   edge_node_features(1200, in_dim)]).to(GPU)
    pw = torch.tensor(rng.random(1200) < 0.8, dtype=torch.float32).to(GPU)
    case("compacted 1200 pairs on 80 heads, degrees 0 and 300, random "
         "matcher", x, pw, topo, random16)
    case("ARPLAB-shaped 6 x 16 (D=80), random matcher",
         *gat_timing.arplab_tiled_inputs(GPU, ARPLAB_MATCHER_SEED))
    rows[0]["max_abs_err"], rows[1]["max_abs_err"] = max_err, k2_err
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
        elif form == "alt1":
            pass    # plain PyTorch, as the reference's XLA
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
    device synchronize (mirrors PoseEstimationPipeline._run_frames; the
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
        x, pw, gtopo, pairs, _ = pipe._gat_inputs(
            S, *(a[None] for a in args), pipe.pair_prune_dist > 0)
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


# ---------------------------------------------------------------------------
# phase 6: the serve path

# serve records on the card against the CPU's: poses to POSE_TOL_M; the
# quality column q (px, two decimals) to QUALITY_TOL_PX + QUALITY_RTOL * q.
# A pose moved by d (at most POSE_TOL_M) moves a joint's projection u by
# |u - c| d_z / z + f d_xy / z (c the principal point): a fraction of the
# projection's offset from c that reaches 2 % at a depth of 0.5 m.  Ghost
# proposals, joints of different people lifted together, project far off
# the image (q in the thousands of px), so their q is mostly that offset;
# 0.5 px is the tolerance the CPU tests hold q to against the JAX package.
QUALITY_TOL_PX = 0.5
QUALITY_RTOL = 0.02
TIMING_KEYS = ("latency_ms", "mean_latency_ms")
SERVE_TIMEOUT_S = 300      # one stdio serve subprocess
N_STREAM_PASSES = 4        # passes over the 16 frames in a turn of the fps
N_PARSE_REPS = 20          # parses of each frame line in the parser timing


def cli_pipeline(*argv):
    """(RigConfig, CameraRig, pipeline) as ``python -m mpe3d_tpu_torch
    serve`` builds them (the CLI's buckets (2, 4, 10) / (4, 8, 16))."""
    from mpe3d_tpu_torch import cli
    return cli.build_pipeline(cli.make_parser().parse_args(["serve",
                                                            *argv]))


def compare_records(got, ref, label):
    """Serve records of the card against the CPU's: the same keys in the
    same order, seqs in strict order, every value equal but the timing
    fields, poses and quality to tolerance.  Returns (records with
    persons, max |d pose| m, max |d quality| px)."""
    import numpy as np
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} records, the CPU gave "
                             f"{len(ref)}:\n{got}\n{ref}")
    dp = dq = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if list(g) != list(r):
            raise AssertionError(f"{label} record {i}: keys {list(g)}, the "
                                 f"CPU's {list(r)}")
        for k in g:
            if k == "poses_m" and g["n_persons"]:
                dp = max(dp, float(np.abs(np.subtract(g[k], r[k])).max()))
            elif k == "quality_px" and g["n_persons"]:
                d = np.abs(np.subtract(g[k], r[k]))
                dq = max(dq, float(d.max()))
                if (d > QUALITY_TOL_PX + QUALITY_RTOL
                        * np.abs(r[k])).any():
                    raise AssertionError(
                        f"{label} record {i}: quality {g[k]}, the CPU's "
                        f"{r[k]} (tol {QUALITY_TOL_PX} px + "
                        f"{QUALITY_RTOL} x q)")
            elif k not in TIMING_KEYS + ("poses_m", "quality_px") \
                    and g[k] != r[k]:
                raise AssertionError(f"{label} record {i}: {k} {g[k]!r}, "
                                     f"the CPU's {r[k]!r}")
    seqs = [g["seq"] for g in got if "seq" in g]
    if seqs != list(range(len(seqs))):
        raise AssertionError(f"{label}: seqs {seqs}")
    if dp > POSE_TOL_M:
        raise AssertionError(f"{label}: max |d pose| {dp:.4g} m (tol "
                             f"{POSE_TOL_M})")
    return sum(1 for g in got if g.get("n_persons")), dp, dq


def serve_in_process(pipe, rig_config, lines, depth, gate=None):
    """Records of ``lines`` through the port's PoseServer in this process,
    a fresh tracker a stream."""
    from mpe3d_tpu_torch.serve import PoseServer
    from mpe3d_tpu_torch.tracking import PoseTracker
    server = PoseServer(pipe, rig_config, depth=depth,
                        tracker_factory=PoseTracker, quality_gate=gate)
    out = []
    server.handle_stream(lines, out.append)
    return [json.loads(line) for line in out], server


def pick_gate(qualities):
    """A quality gate (px) that drops some poses and keeps some: the middle
    of the widest gap between consecutive qualities in the lower half, and
    its distance from the nearest quality."""
    import numpy as np
    q = np.sort(np.asarray(qualities)[np.asarray(qualities) >= 0])
    gaps = np.diff(q)[:len(q) // 2]
    i = int(np.argmax(gaps))
    return round(float(q[i] + q[i + 1]) / 2, 2), float(gaps[i]) / 2


def serve_stdio(lines, depth, gate, *extra):
    """``python3 -m mpe3d_tpu_torch serve`` (with the options ``extra``)
    on the card as a subprocess fed ``lines``: (records, stderr)."""
    cmd = [sys.executable, "-m", "mpe3d_tpu_torch", "serve", "--modelsdir",
           DEMO, "--depth", str(depth), "--track", "--quality-gate",
           repr(gate), "--warmup", *extra]
    proc = subprocess.run(cmd, input="\n".join(lines) + "\n",
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=SERVE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()], \
        proc.stderr


def check_stdio(wire4, wire10):
    """Phase 6a: the stdio server through the real entry point at depth 3
    and 1 against PoseServer on a CPU pipeline of the same pairs.  Returns
    the gate and each depth's median latency_ms."""
    import numpy as np
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.native import LIB_PATH

    lowview = os.path.join(ROOT, "models_demo", "pan_lowview_bf16")
    j10 = [json.dumps(f) for f in wire10]
    lines = ([json.dumps(f) for f in wire4] + j10
             + ["{not json", '{"cmd": "ping"}', '{"cmd": "stats"}',
                json.dumps({"cmd": "reload", "modelsdir": lowview})]
             + j10 + ['{"cmd": "close"}'])
    n_frames = len(wire4) + 2 * len(wire10)
    rc, _, cpu = cli_pipeline("--modelsdir", DEMO, "--cpu")
    _, _, cpu_low = cli_pipeline("--modelsdir", lowview, "--cpu")
    q = [o.quality for p, ws in ((cpu, wire4 + wire10), (cpu_low, wire10))
         for o in (p.infer_fused(parse_frame(w, rc)) for w in ws)]
    gate, margin = pick_gate(np.concatenate(q))
    if margin <= QUALITY_TOL_PX + QUALITY_RTOL * gate:
        raise AssertionError(f"gate {gate} px lies within {margin:.3g} px "
                             f"of a quality")
    print(f"  stdio serve: quality gate {gate} px ({margin:.3f} px from the "
          f"nearest CPU quality); lines: {len(wire4)} S=4 frames, "
          f"{len(wire10)} S=10 frames, a malformed line, ping, stats, "
          f"reload to pan_lowview_bf16, the S=10 frames again, close",
          flush=True)
    medians = {}
    for depth in (3, 1):
        got, err = serve_stdio(lines, depth, gate)
        if depth == 3:
            ref, _ = serve_in_process(cpu, rc, lines, depth, gate)
        else:
            _, _, cpu = cli_pipeline("--modelsdir", DEMO, "--cpu")
            ref, _ = serve_in_process(cpu, rc, lines, depth, gate)
        n, dp, dq = compare_records(got, ref, f"stdio serve, depth {depth}")
        dropped = sum(g.get("dropped_low_quality", 0) for g in got)
        kept = sum(g.get("n_persons", 0) for g in got)
        if not (dropped and kept):
            raise AssertionError(f"gate {gate}: dropped {dropped}, kept "
                                 f"{kept} poses")
        if got[-1].get("closed") is not True or not any(
                g.get("reloaded") for g in got):
            raise AssertionError(f"depth {depth}: no close or reload record")
        want = (f"frame lines parsed: native {n_frames}, python 0 (native "
                f"library: {LIB_PATH})")
        if want not in err:
            raise AssertionError(f"the C++ parser did not read every frame "
                                 f"line: {err[-2000:]}")
        lat = [g["latency_ms"] for g in got if "latency_ms" in g]
        medians[depth] = statistics.median(lat)
        print(f"  stdio serve, depth {depth}: {len(got)} records equal to "
              f"the CPU's ({n} frames with kept poses, {kept} kept, "
              f"{dropped} dropped by the gate), max |d pose| {dp:.3g} m, "
              f"max |d quality| {dq:.3g} px; every frame line through the "
              f"C++ parser ({LIB_PATH}); median latency_ms "
              f"{medians[depth]:.3f} of {len(lat)} frames", flush=True)
    return gate, medians


def check_tcp(wire4, wire10):
    """Phase 6b: PoseThreadingTCPServer on a card pipeline of pan_res with
    two clients at once (the S=10 frames twice, and the S=4 frames),
    against the CPU; the kernels' launches of the run."""
    import socket
    import threading
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.serve import PoseServer, PoseThreadingTCPServer
    from mpe3d_tpu_torch.tracking import PoseTracker

    models = DEMO_PAIRS["pan_res"]
    rc, _, gpu = cli_pipeline("--modelsdir", models)
    gpu.warmup()
    streams = {"S=10": [json.dumps(f) for f in wire10] * 2,
               "S=4": [json.dumps(f) for f in wire4]}
    server = PoseServer(gpu, rc, depth=3, tracker_factory=PoseTracker)
    srv = PoseThreadingTCPServer(server, "127.0.0.1", 0, max_clients=2)
    thread = threading.Thread(target=srv.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    thread.start()
    barrier = threading.Barrier(len(streams), timeout=60)
    got, failed = {}, []

    def client(name):
        try:
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=120) as s:
                f = s.makefile("rwb")
                barrier.wait()
                f.write(("\n".join(streams[name] + ['{"cmd": "close"}'])
                         + "\n").encode())
                f.flush()
                got[name] = [json.loads(f.readline())
                             for _ in range(len(streams[name]) + 1)]
        except Exception as e:      # reported below
            failed.append(f"{name}: {type(e).__name__}: {e}")

    reset_launches()
    clients = [threading.Thread(target=client, args=(n,)) for n in streams]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=240)
        launches = read_launches()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if failed or any(c.is_alive() for c in clients):
        raise AssertionError(f"TCP clients failed: {failed}")
    fas = [parse_frame(json.loads(line), rc) for lines in streams.values()
           for line in lines]
    want = expected_launches(gpu, fas)
    if launches != want or not all(
            launches[k] for k in ("gat_stack", "gat_k1", "gat_k2",
                                  "frame_decode_pack", "mlp_run")):
        raise AssertionError(f"TCP serve: launches {launches}, expected "
                             f"{want}")
    if server.parsed != {"native": len(fas), "python": 0}:
        raise AssertionError(f"TCP serve: frame lines parsed {server.parsed}")
    _, _, cpu = cli_pipeline("--modelsdir", models, "--cpu")
    for name, lines in streams.items():
        ref, _ = serve_in_process(cpu, rc, lines + ['{"cmd": "close"}'], 3)
        n, dp, dq = compare_records(got[name][:-1], ref[:-1],
                                    f"TCP client {name}")
        if got[name][-1].get("closed") is not True:
            raise AssertionError(f"TCP client {name}: no close record")
        print(f"  TCP, pan_res ({gpu.serve_dtype}, {gpu.lifter_prior} "
              f"prior), two clients at once: client {name} "
              f"{len(lines)} frames equal to the CPU's with a fresh tracker "
              f"({n} with persons), max |d pose| {dp:.3g} m, max "
              f"|d quality| {dq:.3g} px", flush=True)
    print(f"  TCP serve: buckets "
          + ", ".join(f"S={S} -> {form} matcher, "
                      + ("frame path" if fp else "eager path")
                      for S, (form, fp) in (
                          (S, gpu.serving_path(S)) for S in
                          sorted({frame_slots(gpu, f) for f in fas})))
          + f"; launches {launches}; all {len(fas)} frame lines through "
          f"the C++ parser", flush=True)
    return launches


def check_infer_stream(frames, rtree):
    """Phase 6c: infer_stream at depth 1 and 3 bit-equal to an infer_fused
    loop on the card, with the trained matcher and, after reload_weights,
    the random one; then frames per second of infer_stream(depth=3)
    against the loop in turns (loop, stream, stream, loop)."""
    import numpy as np
    import torch
    _, _, gpu = cli_pipeline("--modelsdir", DEMO)
    for label in ("trained", "random"):
        if label == "random":
            gpu.reload_weights(matcher_tree=rtree)
        loop = [gpu.infer_fused(f) for f in frames]
        for depth in (1, 3):
            reset_launches()
            got = list(gpu.infer_stream(frames, depth=depth))
            launches = read_launches()
            if launches != expected_launches(gpu, frames):
                raise AssertionError(f"infer_stream: launches {launches}")
            if len(got) != len(loop):
                raise AssertionError(f"infer_stream gave {len(got)} outputs")
            for i, (a, b) in enumerate(zip(got, loop)):
                if not (a.n_heads == b.n_heads and all(
                        np.array_equal(getattr(a, k), getattr(b, k))
                        for k in ("poses", "persons", "scores", "quality"))):
                    raise AssertionError(f"infer_stream depth {depth}, "
                                         f"{label} matcher, frame {i}: not "
                                         f"bit-equal to infer_fused")
        print(f"  infer_stream, {label} matcher: depth 1 and 3 bit-equal "
              f"to the infer_fused loop on {len(frames)} frames (persons "
              f"{[len(o.persons) for o in loop]}); launches {launches}",
              flush=True)

    def run(stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_STREAM_PASSES):
            if stream:
                for _ in gpu.infer_stream(frames, depth=3):
                    pass
            else:
                for f in frames:
                    gpu.infer_fused(f)
        torch.cuda.synchronize()
        return N_STREAM_PASSES * len(frames) / (time.perf_counter() - t0)

    run(True)
    turns = [run(False), run(True), run(True), run(False)]
    return turns


def time_parser(lines, rig_config):
    """Microseconds a frame line through PoseServer's C++ path and through
    json.loads + parse_frame (median of N_PARSE_REPS passes)."""
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.serve import PoseServer

    class _Pipe:            # PoseServer reads only the matching cameras
        match_idx = rig_config.matching_camera_indices()

    server = PoseServer(_Pipe(), rig_config)
    out = {}
    for name, fn in (("native", lambda ln: server._parse_line(ln, {"n": 0})),
                     ("python", lambda ln: parse_frame(json.loads(ln),
                                                       rig_config))):
        per = []
        for _ in range(N_PARSE_REPS):
            t0 = time.perf_counter()
            for ln in lines:
                fn(ln)
            per.append(1e6 * (time.perf_counter() - t0) / len(lines))
        out[name] = statistics.median(per)
    if server.parsed["python"]:
        raise AssertionError("the parser timing left the C++ path")
    return out


# ---------------------------------------------------------------------------
# phase 3 additions: the run kernel past 16 rows, the decode over a batch

RUN_ROWS = (16, 32, 64, 50)   # the whole nets' row counts (50: ragged)
# the wide classes' row counts: S=16's chunk (6 x 16), S=4's (25 x 10),
# ARPLAB's (21 x 12), a full group
WIDE_ROWS = (96, 250, 252, 256)
BATCH_DECODE = 8              # frames of the S=4 batched decode check
BATCH_DECODE16 = 6            # frames of the S=16 one (the union's limit)


def run_rows_input(nets, M, seed):
    """M lifter rows from the serving path's rows: repeated, each scaled by
    a numpy-seeded factor in [0.5, 1.5)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    reps = -(-M // nets.shape[0])
    x = nets.float().repeat(reps, 1)[:M]
    return (x * torch.tensor(rng.uniform(0.5, 1.5, (M, 1)),
                             dtype=torch.float32,
                             device=nets.device)).contiguous()


def check_run_rows(label, lifter, nets, report, replaces, library_of):
    """Phase 3: the whole net of ``lifter`` as ONE launch of the run kernel
    at M = 16, 32, 64 and 50 rows against ``run_plain`` (MLP_NET_TOL), two
    launches bit-equal; each M timed; the M=64 launch's device time in
    turns against the four M=16 launches it replaces (M=64, 4 x M=16,
    4 x M=16, M=64 in one call), which must be shorter.  Appends the M=64
    row (the batch path's row group) to ``report``.  Returns
    (ms by M, device ms by M, (M=64 device ms, 4 x M=16 device ms))."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp
    layers = lifter.packed_layers()
    if fused_mlp.launch_plan(layers) != [("run", 0, len(layers))]:
        raise AssertionError(f"{label}: the lifter is not one run")
    slope = lifter.cfg.negative_slope
    acts = [i < len(layers) - 1 for i in range(len(layers))]
    ms, dev, errs, xs = {}, {}, {}, {}
    for M in RUN_ROWS:
        x = xs[M] = run_rows_input(nets, M, M)
        run = lambda x=x: fused_mlp.mlp_run(x, layers, slope, acts)  # noqa
        before = fused_mlp.mlp_run.launches
        got, again = run(), run()
        ref = fused_mlp.run_plain(x, layers, slope, acts)
        torch.cuda.synchronize()
        err = errs[M] = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
            raise AssertionError(f"{label} run, M={M}: max err {err:.3g} > "
                                 f"{MLP_NET_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label} run, M={M}: two launches differ")
        if fused_mlp.mlp_run.launches - before != 2:
            raise AssertionError(f"{label} run, M={M}: not one launch a call")
        ms[M], dev[M] = median_ms(run, 20), device_ms(run)
    x64 = xs[64]
    one = lambda: fused_mlp.mlp_run(x64, layers, slope, acts)  # noqa: E731
    four = lambda: [fused_mlp.mlp_run(x64[i:i + 16], layers, slope,  # noqa
                                      acts) for i in range(0, 64, 16)]
    turns = [device_ms(f) for f in (one, four, four, one)]
    d64, d4x16 = (statistics.median([turns[0], turns[3]]),
                  statistics.median([turns[1], turns[2]]))
    if not d64 < d4x16:
        raise AssertionError(f"{label}: the M=64 launch's device time "
                             f"{d64:.4f} ms is not below four M=16 launches' "
                             f"{d4x16:.4f} ms")
    bytes_, flops = run_costs(layers, x64)
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    lib_label, library = library_of(layers, slope)
    k_ms, lib_ms = in_turns(one, lambda: library(x64))
    report.append({
        "name": "mlp_run", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu", "replaces": replaces,
        "launches": 0, "max_abs_err": max(errs.values()), "ms": k_ms,
        "plain_ms": median_ms(lambda: fused_mlp.run_plain(x64, layers, slope,
                                                          acts), 5),
        "bound_ms": 1e3 * max(t_b, t_f),
        "bound_by": "bytes" if t_b > t_f else "operations",
        "library_ms": lib_ms, "device_ms": dev[64], "case": "M=64",
        "path": "batch"})
    print(f"  mlp_run ({label}), the whole net as one launch against "
          f"run_plain: max err "
          + ", ".join(f"M={M} {errs[M]:.3g}" for M in RUN_ROWS)
          + f" (tol {MLP_NET_TOL:g}), two launches bit-equal; ms / device "
          f"ms: " + ", ".join(f"M={M} {ms[M]:.4f} / {dev[M]:.4f}"
                              for M in RUN_ROWS)
          + f"; in turns (M=64, 4 x M=16, 4 x M=16, M=64) device ms "
          + ", ".join(f"{t:.4f}" for t in turns)
          + f": M=64 {d64:.4f} against 4 x M=16 {d4x16:.4f}; bound at M=64 "
          f"{report[-1]['bound_ms']:.5f} ms ({report[-1]['bound_by']}); "
          f"library ({lib_label}) {lib_ms:.4f} ms in turns with "
          f"{k_ms:.4f}", flush=True)
    return ms, dev, (d64, d4x16)


def check_run_wide(label, lifter, nets, report, replaces, library_of):
    """Phase 3: the whole net of ``lifter`` as ONE launch of a wide row
    class at M = 96, 250, 252 and 256 rows against ``run_plain``
    (MLP_NET_TOL), two launches bit-equal; each M's device time in turns
    against the 64-row launches it replaces (wide, 64-row groups, 64-row
    groups, wide), which must be longer, and its call time in turns with
    the library chain.  Appends a row a M to ``report``; returns
    {M: (wide device ms, 64-row device ms)}."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp
    layers = lifter.packed_layers()
    slope = lifter.cfg.negative_slope
    acts = [i < len(layers) - 1 for i in range(len(layers))]
    lib_label, library = library_of(layers, slope)
    out = {}
    for M in WIDE_ROWS:
        x = run_rows_input(nets, M, M)
        wide = lambda x=x: fused_mlp.mlp_run(x, layers, slope, acts)  # noqa
        old = lambda x=x: [fused_mlp.mlp_run(x[m:m + 64], layers,  # noqa
                                             slope, acts)
                           for m in range(0, x.shape[0], 64)]
        before = fused_mlp.mlp_run.launches
        got, again = wide(), wide()
        ref = fused_mlp.run_plain(x, layers, slope, acts)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
            raise AssertionError(f"{label} wide run, M={M}: max err "
                                 f"{err:.3g} > {MLP_NET_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label} wide run, M={M}: two launches "
                                 f"differ")
        if fused_mlp.mlp_run.launches - before != 2:
            raise AssertionError(f"{label} wide run, M={M}: not one launch "
                                 f"a call")
        turns = [device_ms(f) for f in (wide, old, old, wide)]
        d_wide = statistics.median([turns[0], turns[3]])
        d_old = statistics.median([turns[1], turns[2]])
        if not d_wide < d_old:
            raise AssertionError(f"{label}: the M={M} launch's device time "
                                 f"{d_wide:.4f} ms is not below its 64-row "
                                 f"launches' {d_old:.4f} ms")
        bytes_, flops = run_costs(layers, x)
        t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
        k_ms, lib_ms = in_turns(wide, lambda x=x: library(x))
        report.append({
            "name": "mlp_run", "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": k_ms, "plain_ms": median_ms(
                lambda x=x: fused_mlp.run_plain(x, layers, slope, acts), 5),
            "bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b > t_f else "operations",
            "library_ms": lib_ms, "device_ms": d_wide,
            "case": f"{label}, M={M} (wide)", "path": "batch",
            "replaced_device_ms": d_old})
        out[M] = (d_wide, d_old)
        print(f"  mlp_run ({label}), wide class at M={M}: max err "
              f"{err:.3g} (tol {MLP_NET_TOL:g}), two launches bit-equal; "
              f"device ms in turns (wide, 64-row, 64-row, wide) "
              + ", ".join(f"{t:.4f}" for t in turns)
              + f"; call {k_ms:.4f} ms, library ({lib_label}) "
              f"{lib_ms:.4f} ms in turns; bound {1e3 * max(t_b, t_f):.5f} "
              f"ms ({report[-1]['bound_by']})", flush=True)
    return out


def bf16_library(layers, slope):
    """The bf16 nets' PyTorch yardstick: chained bf16 ``torch.matmul``."""
    import torch
    wb = [w.to(torch.bfloat16) for w, _ in layers]

    def run(x):
        hb = x.to(torch.bfloat16)
        for w in wb:
            hb = torch.matmul(hb, w)
        return hb
    return f"{len(wb)} chained bf16 torch.matmul", run


def int8_net_library(layers, slope):
    """The int8 nets' yardstick: ``int8_yardstick`` on the int8 layers,
    then the bf16 head as a bf16 ``torch.matmul``."""
    import torch
    label, body = int8_yardstick(layers[:-1], slope)
    head = layers[-1].w.to(torch.bfloat16)
    return (f"{label}, and a bf16 torch.matmul head",
            lambda x: torch.matmul(body(x).to(torch.bfloat16), head))


def check_int8_rows64(lifter, nets, report):
    """Phase 3: ``int8_layer_matmul`` on each int8 layer at M=64 (one run
    launch a layer: the 64-row groups), against its plain version."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, quant_matmul
    slope = lifter.cfg.negative_slope
    x = run_rows_input(nets, 64, 64)
    inputs, h, worst = [], x, 0.0
    for layer in lifter.packed_layers()[:-1]:
        before = fused_mlp.mlp_run.launches
        y = quant_matmul.int8_layer_matmul(h, layer, slope)
        ref = fused_mlp.layer_plain(h, layer, slope, True)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = MLP_LAYER_TOL * max(1.0, float(ref.abs().max()))
        if not (err <= tol and fused_mlp.mlp_run.launches - before == 1):
            raise AssertionError(f"int8 layer at M=64: max err {err:.3g} > "
                                 f"{tol:.3g}, or not one launch")
        worst = max(worst, err)
        inputs.append((h, layer))
        h = ref
    alone = lambda: [quant_matmul.int8_layer_matmul(a, layer, slope)  # noqa
                     for a, layer in inputs]
    plain = lambda: [fused_mlp.layer_plain(a, layer, slope, True)  # noqa
                     for a, layer in inputs]
    label, library = int8_yardstick([layer for _, layer in inputs], slope)
    bytes_, flops = mlp_costs([layer for _, layer in inputs], 64)
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    k_ms, lib_ms = in_turns(alone, lambda: library(x))
    report.append({
        "name": "mlp_run", "route": "cuda",
        "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "mpe3d_tpu/ops/quant_matmul.py:73", "launches": 0,
        "max_abs_err": worst, "ms": k_ms, "plain_ms": median_ms(plain, 5),
        "bound_ms": 1e3 * max(t_b, t_f),
        "bound_by": "bytes" if t_b > t_f else "operations",
        "library_ms": lib_ms, "device_ms": device_ms(alone), "case": "M=64",
        "path": "batch"})
    print(f"  int8_layer_matmul, the 8 int8 layers of pan_irls each alone "
          f"at M=64 (one launch a layer): max err {worst:.3g}, "
          f"{k_ms:.4f} ms, device {report[-1]['device_ms']:.4f} ms, library "
          f"({label}) {lib_ms:.4f} ms in turns", flush=True)


def batch_frame_costs(args, kw, out):
    """``frame_costs`` summed over the frames of a batched call."""
    from mpe3d_tpu_torch.ops.frame_kernel import FrameOutputs
    P, bytes_, ops = kw["P"], 0, 0
    shared = (2, 3, 8, 9)
    for b in range(args[0].shape[0]):
        fargs = tuple(a if i in shared else a[b] for i, a in enumerate(args))
        fout = FrameOutputs(*(t[b * P:(b + 1) * P] for t in out))
        nb, no = frame_costs(fargs, kw, fout)
        bytes_, ops = bytes_ + nb, ops + no
    return bytes_, ops


def check_batch_decode(pipe4, frames4, pipe16, frames16, report):
    """Phase 3: the decode + gather + pack kernel over a batch (a block a
    frame) against its plain version (frame by frame) on the inputs the
    batch path gives it: 8 S=4 frames (the pipeline's prior, and the IRLS
    prior with the gate), 6 S=16 frames (the "mean" prior: the trained
    matcher's crowded groups, as phase 5); persons, masks and gathered rows
    exactly equal, the lifter rows to FIELD_TOL / PRIOR_TOL.  Appends the
    B=8 row."""
    import torch
    from mpe3d_tpu_torch.ops import frame_kernel as fk
    cases = (("S=4", pipe4, frames4[:BATCH_DECODE],
              [(None, None), ("irls", 8.0)]),
             ("S=16", pipe16, frames16[:BATCH_DECODE16], [("mean", None)]))
    errs, row = [], None
    for label, pipe, frames, priors in cases:
        _, (args, kw) = pipe.union_stage_inputs(frames)
        for prior, gate in priors:
            k = dict(kw, prior=prior or kw["prior"], gate_px=gate)
            before = fk.frame_decode_pack.launches
            got = fk.frame_decode_pack(*args, **k)
            ref = fk.frame_decode_pack_plain(*args, **k)
            ungated = fk.frame_decode_pack_plain(*args, **dict(k,
                                                               gate_px=None))
            torch.cuda.synchronize()
            if fk.frame_decode_pack.launches - before != 1:
                raise AssertionError("the batched decode is not one launch")
            rig = fk.rig_from_consts(args[8], args[9])
            err, flips, near = compare_frame_outputs(got, ref, ungated, k,
                                                     rig)
            errs.append(err)
            print(f"  frame_decode_pack over {len(frames)} {label} frames "
                  f"(one launch, a block a frame), prior={k['prior']} "
                  f"gate={gate}: persons {int(ref.person_mask.sum())}, "
                  f"persons/gathers equal to the plain loop, net max |d| "
                  f"{err:.3g}, {flips} ok flags differ ({near} near the "
                  f"gate)", flush=True)
        if row is None:
            call = lambda a=args, k=kw: fk.frame_decode_pack(*a, **k)  # noqa
            out = call()
            bytes_, ops = batch_frame_costs(args, kw, out)
            t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS
            ms, dev = median_ms(call), device_ms(call)
            row = {"name": "frame_decode_pack", "route": "cuda",
                   "source": "mpe3d_tpu_torch/csrc/frame_decode_pack.cu",
                   "replaces": "mpe3d_tpu/ops/frame_kernel.py:358",
                   "launches": 0, "max_abs_err": 0.0, "ms": ms,
                   "plain_ms": median_ms(lambda a=args, k=kw:
                                         fk.frame_decode_pack_plain(*a, **k),
                                         5),
                   "bound_ms": 1e3 * max(t_b, t_o),
                   "bound_by": "bytes" if t_b > t_o else "operations",
                   "library_ms": None, "device_ms": dev,
                   "case": f"B={len(frames)}, S=4", "path": "batch"}
    row["max_abs_err"] = max(errs)
    report.append(row)
    print(f"  frame_decode_pack B={BATCH_DECODE} S=4: {row['ms']:.4f} ms, "
          f"device {row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})",
          flush=True)


# ---------------------------------------------------------------------------
# phase 7: the batch and staged paths

N_BATCH_TIMED = 8        # frames of the timed infer_batch
STAGED_FRAMES = 6        # frames of each staged check


def expected_batch_launches(pipe, frames):
    """Kernel launches ``infer_batch`` gives these frames (``batch_plan``):
    a chunk is one GAT call of the bucket's form, one decode launch, and a
    run launch a group of 256 lifter rows (``row_groups``) for each run of
    the lifter."""
    from mpe3d_tpu_torch.ops.fused_mlp import launch_plan, row_groups
    want = dict.fromkeys(launch_counters(), 0)
    S = pipe._batch_slots(frames)
    plan = pipe.batch_plan(S, len(frames))
    if not plan.union:
        raise AssertionError(f"S={S}: the batch is not on the batch body")
    form, n_gat, P = pipe._bucket_state(S).form, len(pipe.matcher.dims), \
        pipe._p_max(S)
    runs = [k for k, _, _ in launch_plan(pipe.lifter.packed_layers())
            ].count("run")
    for m in plan.chunks:
        if form == "stack":
            want["gat_stack"] += 1
        else:
            want["gat_k1"] += n_gat
            want["gat_k2"] += n_gat - 1
        want["frame_decode_pack"] += 1
        want["mlp_run"] += runs * len(row_groups(m * P))
    return want, plan


def compare_outputs(got, ref, label, score_tol=SCORE_TOL,
                    pose_tol=POSE_TOL_M):
    """Frame outputs against reference outputs: persons equal (int32),
    scores and poses within tolerance; returns (persons, max |d score|,
    max |d pose|)."""
    import numpy as np
    n = ds = dp = 0
    for i, (o, r) in enumerate(zip(got, ref)):
        for a in (o.poses, o.scores, o.quality):
            if not np.isfinite(a).all():
                raise AssertionError(f"{label} frame {i}: non-finite output")
        if not np.array_equal(o.persons, r.persons):
            raise AssertionError(f"{label} frame {i}: persons differ:\n"
                                 f"{o.persons}\n{r.persons}")
        if o.scores.size:
            ds = max(ds, float(np.abs(o.scores - r.scores).max()))
        if len(o.poses):
            dp = max(dp, float(np.abs(o.poses - r.poses).max()))
        n += len(o.persons)
    if len(got) != len(ref) or ds > score_tol or dp > pose_tol:
        raise AssertionError(f"{label}: {len(got)} / {len(ref)} frames, max "
                             f"|d score| {ds:.3g} (tol {score_tol}), max "
                             f"|d pose| {dp:.3g} m (tol {pose_tol})")
    return n, ds, dp


def run_batch_path(gpu, cpu, frames, label):
    """``infer_batch`` of the frames on the card: its launches as
    ``batch_plan`` gives them (the counts set to 0 just before, read just
    after), persons equal to the card's ``infer_fused`` and the CPU's
    ``infer_batch``, scores within SCORE_TOL, poses within POSE_TOL_M;
    ``submit_batch`` raises no sync error.  The launches are the key's
    first batch's (eager); its second (the CUDA graph's capture, under the
    sync check) and third (a replay) are bit-equal to it.  Returns the
    launches."""
    import torch
    want, plan = expected_batch_launches(gpu, frames)
    gpu.infer_batch(frames[:2])                    # plans and tables
    reset_launches()
    eager = gpu.infer_batch(frames)                # the key's first: eager
    launches = read_launches()
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ticket = gpu.submit_batch(frames)          # captured, replayed
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_bits(gpu.collect_batch(ticket), eager, f"{label}, captured")
    outs = gpu.infer_batch(frames)                 # replayed
    same_bits(outs, eager, f"{label}, replayed")
    single = [gpu.infer_fused(f) for f in frames]
    n, ds1, dp1 = compare_outputs(outs, single, f"{label}, against "
                                  f"infer_fused on the card")
    _, ds2, dp2 = compare_outputs(outs, cpu.infer_batch(frames),
                                  f"{label}, against the CPU's infer_batch")
    print(f"  {label}: {len(frames)} frames, plan {plan.chunks}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, {n} persons; "
          f"submit_batch raised no sync error; against infer_fused on the "
          f"card max |d score| {ds1:.3g}, |d pose| {dp1:.3g} m; against the "
          f"CPU's infer_batch {ds2:.3g}, {dp2:.3g} m", flush=True)
    return launches


def same_bits(got, ref, label):
    """Frame outputs bit-equal to reference outputs (poses, persons,
    scores, quality)."""
    import numpy as np
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} / {len(ref)} frames")
    for i, (o, r) in enumerate(zip(got, ref)):
        for name in ("poses", "persons", "scores", "quality"):
            a, b = getattr(o, name), getattr(r, name)
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"{label} frame {i}: {name} differ "
                                     f"from the eager body's")


def graph_case(label, make, frames_a, frames_b, slots, pad_to=None):
    """One key of the batch graphs on the card: on a pipeline of ``make()``
    the frames_a batch eagerly (the key's first), captured and replayed
    (its second), then frames_b and frames_a as two batches in flight (two
    replays on the one static input and output set); the captured batch
    and both replays bit-equal to the eager body's (frames_b's on a fresh
    pipeline).  Returns {capture_s, pool_bytes, eager_ms, replay_ms}: the
    capture's host seconds, the graph's pool bytes, and the median host
    ms of submit_batch on the eager body (graphs off) and on replays."""
    import statistics
    import torch
    from mpe3d_tpu_torch.pipeline import _Graph

    def run(p, fr):
        return p.collect_batch(p.submit_batch(fr, slots=slots, pad_to=pad_to))

    def submit_ms(p, fr, n=5):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ticket = p.submit_batch(fr, slots=slots, pad_to=pad_to)
            ms.append(1e3 * (time.perf_counter() - t))
            p.collect_batch(ticket)
        return statistics.median(ms)

    pipe = make()
    n = max(len(frames_a), pad_to or 0)
    if not pipe.batch_plan(slots, n).union:
        raise AssertionError(f"{label}: the batch is not on the batch body")
    eager_a = run(pipe, frames_a)
    captured = run(pipe, frames_a)
    graph = pipe._graphs.entries.get(pipe._graph_key(slots, n))
    if not isinstance(graph, _Graph):
        raise AssertionError(f"{label}: the second batch did not capture "
                             f"({graph!r})")
    tb = pipe.submit_batch(frames_b, slots=slots, pad_to=pad_to)
    ta = pipe.submit_batch(frames_a, slots=slots, pad_to=pad_to)
    if tb[3] is not graph or ta[3] is not graph:
        raise AssertionError(f"{label}: a later batch did not replay")
    replay_b, replay_a = pipe.collect_batch(tb), pipe.collect_batch(ta)
    same_bits(captured, eager_a, f"{label}, captured batch")
    same_bits(replay_a, eager_a, f"{label}, replay in flight")
    same_bits(replay_b, run(make(), frames_b), f"{label}, replay of other "
              f"frames in flight")
    eager = make()
    eager._graphs.graph_type = None             # the eager body alone
    run(eager, frames_a)
    return {"capture_s": graph.capture_s,
            "pool_bytes": graph.graph.pool_bytes,
            "eager_ms": submit_ms(eager, frames_a),
            "replay_ms": submit_ms(pipe, frames_a),
            "persons": sum(len(o.persons) for o in eager_a)}


def check_run_capture(lifter, K0, label):
    """The lifter's cooperative ``mlp_run`` launch (after its sync words'
    memset) captured alone in a CUDA graph: the replay bit-equal to the
    eager launch on the captured input and, after the input is refilled,
    on another."""
    import torch
    from mpe3d_tpu_torch.pipeline import _CudaGraph
    gen = torch.Generator(device=GPU).manual_seed(7)
    x = torch.randn(64, K0, device=GPU, generator=gen)
    other = torch.randn(64, K0, device=GPU, generator=gen)
    with torch.inference_mode():
        want, want2 = lifter(x).clone(), lifter(other).clone()
        g = _CudaGraph(torch.cuda.Stream())
        y = g.capture(lambda: lifter(x))
        g.replay()
        got = y.clone()
        x.copy_(other)
        g.replay()
        got2 = y.clone()
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got2, want2)):
        raise AssertionError(f"{label}: the captured mlp_run differs from "
                             f"the eager launch")
    print(f"  {label}: mlp_run (cooperative launch after a memset) captured "
          f"in a CUDA graph, two replays bit-equal to eager launches, "
          f"pool {g.pool_bytes} B", flush=True)


def check_batch_graphs(pipeline, arplab, mtree, rtree, rig_config, rig,
                       smi):
    """The batch graphs on the card (module header, phase 7).
    ``pipeline(tree, device, **kw)`` builds a Panoptic pipeline of the
    bf16 lifter; ``arplab`` is phase 8's bf16 ARPLAB variant."""
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import generate_frames

    def frames(rc, rg, n, people, seed, slots):
        return [parse_frame(f, rc, max_skeletons=slots)
                for f in generate_frames(rc, rg, n, n_people=people,
                                         seed=seed)]

    s4 = dict(slots=(4,), persons=(4, 8, 16))
    s16 = dict(slots=(16,), persons=(16,), lifter_prior=CROWDED_PRIOR)
    a_rig = arplab.rig
    cases = {
        "Panoptic S=4 x 100": (
            lambda: pipeline(rtree, GPU, **s4),
            frames(rig_config, rig, 100, (2, 4), 21, 4),
            frames(rig_config, rig, 100, (2, 4), 22, 4), 4, None),
        "ARPLAB S=4 x 84": (
            lambda: arplab.pipeline("random", GPU, persons=(4, 8, 16)),
            frames(arplab.rc, a_rig, 84, (2, 4), 23, 4),
            frames(arplab.rc, a_rig, 84, (2, 4), 24, 4), 4, None),
        "Panoptic S=16 x 24": (
            lambda: pipeline(rtree, GPU, **s16),
            frames(rig_config, rig, 24, (10, 14), 25, 16),
            frames(rig_config, rig, 24, (10, 14), 26, 16), 16, None),
        "Panoptic S=4, 3 frames pad_to=4": (
            lambda: pipeline(rtree, GPU, **s4),
            frames(rig_config, rig, 3, (2, 4), 27, 4),
            frames(rig_config, rig, 3, (2, 4), 28, 4), 4, 4)}
    out = {}
    for label, (make, fa, fb, slots, pad_to) in cases.items():
        out[label] = graph_case(label, make, fa, fb, slots, pad_to)
        r = out[label]
        print(f"  batch graph, {label}: {r['persons']} persons; captured "
              f"and replayed bit-equal to the eager body (two in flight); "
              f"capture {r['capture_s']:.3f} s, graph pool "
              f"{r['pool_bytes']} B; submit_batch host ms eager "
              f"{r['eager_ms']:.3f}, replayed {r['replay_ms']:.3f} ({smi})",
              flush=True)
    # after reload_weights: the graphs dropped, the key eager again, then
    # captured and replayed with the new weights
    fa = cases["Panoptic S=4 x 100"][1]
    pipe = pipeline(mtree, GPU, **s4)
    old = [pipe.collect_batch(pipe.submit_batch(fa, slots=4))
           for _ in range(3)][-1]
    pipe.reload_weights(matcher_tree=rtree)
    if pipe._graphs.entries:
        raise AssertionError("reload_weights left batch graphs")
    ref = pipeline(rtree, GPU, **s4)
    want = ref.collect_batch(ref.submit_batch(fa, slots=4))
    tickets = []
    for i in range(3):
        ticket = pipe.submit_batch(fa, slots=4)
        tickets.append(ticket[3] is not None)
        same_bits(pipe.collect_batch(ticket), want,
                  f"after reload_weights, batch {i}")
    if tickets != [False, True, True]:
        raise AssertionError(f"after reload_weights: replays {tickets}")
    if all(o.scores.tobytes() == w.scores.tobytes()
           for o, w in zip(old, want)):
        raise AssertionError("after reload_weights: the old and new "
                             "matchers score alike")
    print("  batch graph after reload_weights (trained -> random matcher, "
          "S=4 x 100): the cache emptied, eager, captured and replayed "
          "bit-equal to a fresh pipeline of the new weights", flush=True)
    check_run_capture(pipeline(rtree, GPU).lifter,
                      rig_config.lifter_input_dim,
                      "pan_irls_bf16 lifter, M=64")
    return out


def check_staged(gpu_of, frames):
    """``pipe(frame)`` on the card against the CPU: host decode, device
    decode, the triangulation backend (median, IRLS) and geo rerank; the
    random matcher (live persons at S=4).  ``gpu_of(device, **kw)`` builds
    the pipeline.  Returns {case: (persons, max |d score|, max |d pose|)}."""
    cases = {"host decode": {}, "device decode": dict(decode_on_device=True),
             "triangulation median": dict(backend="triangulation"),
             "triangulation irls": dict(backend="triangulation",
                                        tri_variant="irls"),
             "geo rerank 0.3": dict(geo_rerank=0.3)}
    out = {}
    for name, kw in cases.items():
        gpu, cpu = gpu_of(GPU, **kw), gpu_of("cpu", **kw)
        got = [gpu(f) for f in frames]
        out[name] = compare_outputs(got, [cpu(f) for f in frames],
                                    f"staged, {name}")
        if name == "geo rerank 0.3":
            fused = [gpu.infer_fused(f) for f in frames]
            compare_outputs(fused, [cpu.infer_fused(f) for f in frames],
                            "geo rerank 0.3, infer_fused (eager path)")
    print("  staged pipe(frame) on the card against the CPU, "
          f"{len(frames)} S=4 frames, random matcher: "
          + "; ".join(f"{k}: {n} persons, max |d score| {ds:.3g}, max "
                      f"|d pose| {dp:.3g} m" for k, (n, ds, dp)
                      in out.items()), flush=True)
    return out


def check_stdio_batch(wire4, wire10, gate):
    """``serve --batch-window 4`` over stdio on the card: records equal to
    ``--batch-window 1`` on the same lines (control lines flush the
    window); poses to POSE_TOL_M, quality to tolerance.  Returns the
    windows' median latency_ms."""
    lines = ([json.dumps(f) for f in wire4 + wire10] + ['{"cmd": "stats"}']
             + [json.dumps(f) for f in wire10] + ['{"cmd": "close"}'])
    recs = {w: serve_stdio(lines, 3, gate, "--batch-window", str(w),
                           "--batch-linger-ms", "20")[0] for w in (4, 1)}
    n, dp, dq = compare_records(
        [{k: v for k, v in r.items() if k != "batch_window"}
         for r in recs[4]], recs[1], "stdio serve --batch-window 4")
    lat = {w: statistics.median(r["latency_ms"] for r in recs[w]
                                if "latency_ms" in r) for w in recs}
    print(f"  serve --batch-window 4 over stdio on the card: "
          f"{len(recs[4])} records equal to --batch-window 1 ({n} frames "
          f"with kept poses), max |d pose| {dp:.3g} m, max |d quality| "
          f"{dq:.3g} px; median latency_ms window 4 {lat[4]:.3f}, window 1 "
          f"{lat[1]:.3f}", flush=True)
    return lat


def batch_fps(gpu, frames):
    """Frames per second of ``infer_batch`` of N_BATCH_TIMED frames against
    the ``infer_fused`` loop on the same frames, in turns (loop, batch,
    batch, loop), and the CUDA launches of one batch (profiler)."""
    import torch
    frames = frames[:N_BATCH_TIMED]

    def fps(fn, reps=4):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return reps * len(frames) / (time.perf_counter() - t0)

    loop = lambda: [gpu.infer_fused(f) for f in frames]  # noqa: E731
    batch = lambda: gpu.infer_batch(frames)  # noqa: E731
    turns = [fps(f) for f in (loop, batch, batch, loop)]
    dev, n_k = device_profile(batch, 10)
    dev_loop, n_loop = device_profile(loop, 10)
    return turns, (dev, n_k), (dev_loop, n_loop)


# ---------------------------------------------------------------------------
# phase 3 additions and phase 8: the second rig and the graph variants

DEMO_ARP = os.path.join(ROOT, "models_demo", "arp_irls")
ARPLAB_LIVE_SEED = 2       # the random ARPLAB matcher: every present pair
#                            scores above the threshold on these frames
N_VARIANT = 6              # frames of the BODY_25, alt-2, alt-1, residual runs
# BODY_25 accuracy joints (tests/test_alternatives.py's choice)
B25_USED_JOINTS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14)


class Variant:
    """One configuration of phase 8: its rig, synthetic rig and frames (and
    the wire frames they were parsed from), its matcher trees (label ->
    tree) and config, and its lifter tree (served in the dtype it is
    stored in: int8 trees int8, others bf16), config and prior."""

    def __init__(self, name, rig_config, matchers, mcfg, lifter, prior,
                 frames, wire=None):
        from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
        self.name, self.rc = name, rig_config
        self.rig = synthetic_ring_rig(rig_config)
        self.matchers, self.mcfg = matchers, mcfg
        self.ltree, self.lcfg = lifter
        self.prior, self.frames, self.wire = prior, frames, wire

    def pipeline(self, matcher, device, use_frame_kernel=None, slots=(4,),
                 persons=(8,), prior=None, **kw):
        from mpe3d_tpu_torch import weights
        from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
        return PoseEstimationPipeline(
            self.rc, self.rig,
            weights.matcher_from_tree(self.matchers[matcher], self.mcfg,
                                      device),
            weights.lifter_from_tree(self.ltree, self.lcfg, device),
            slot_buckets=slots, person_buckets=persons,
            lifter_prior=prior or self.prior,
            use_frame_kernel=use_frame_kernel, device=device, **kw)


def variant_setups(panoptic_lifter, panoptic_prior):
    """The configurations of phase 8, on synthetic ring rigs, weights from
    the checkout or numpy seeds: ARPLAB with ``models_demo/arp_irls``
    (int8, IRLS prior; its trained matcher and a random one) and a bf16
    ARPLAB lifter (``arp_irls``'s weights dequantized, served bf16, the
    median prior), 16 S=4 frames and 6 S=10 frames; BODY_25 (random
    matcher at in_dim 1252 and lifter 1750 -> 75 at full width); the alt-2
    and alt-1 graphs and a residual matcher (random, full width) with the
    Panoptic lifter of ``pan_irls_bf16``."""
    import dataclasses
    import torch
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
    from mpe3d_tpu_torch.config import (ARPLAB, PANOPTIC, LifterConfig,
                                        MatcherConfig)
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.models.mlp import dequantize_lifter_weights

    def frames(rc, n, people, seed):
        return [parse_frame(f, rc) for f in generate_frames(
            rc, synthetic_ring_rig(rc), n, n_people=people, seed=seed)]

    am, amcfg = load_matcher_checkpoint(
        os.path.join(DEMO_ARP, "skeleton_matching"),
        MatcherConfig(in_dim=ARPLAB.matcher_feature_dim))
    altree, alcfg, aprior = load_lifter(DEMO_ARP, ARPLAB)
    amatchers = {"trained": am, "random": weights.random_matcher_tree(
        amcfg, ARPLAB_LIVE_SEED)}
    arp_wire = generate_frames(ARPLAB, synthetic_ring_rig(ARPLAB), N_FRAMES,
                               n_people=(2, 3), seed=1)
    arp_frames = ([parse_frame(f, ARPLAB) for f in arp_wire],
                  frames(ARPLAB, N_CROWDED, (6, 8), 3))
    deq = dequantize_lifter_weights({"layers": [
        {k: torch.as_tensor(v) for k, v in layer.items()}
        for layer in altree["layers"]]})
    V = {"arplab": Variant("ARPLAB arp_irls (int8)", ARPLAB, amatchers,
                           amcfg, (altree, alcfg), aprior, arp_frames,
                           arp_wire),
         "arplab_bf16": Variant("ARPLAB bf16 lifter (arp_irls dequantized)",
                                ARPLAB, amatchers, amcfg, (deq, alcfg),
                                "median", arp_frames)}
    b25 = dataclasses.replace(PANOPTIC, joint_format="BODY_25",
                              used_joints=B25_USED_JOINTS)
    bm = MatcherConfig(in_dim=b25.matcher_feature_dim)
    bl = LifterConfig(in_dim=b25.lifter_input_dim, out_dim=b25.n_joints * 3)
    V["body25"] = Variant(
        "BODY_25", b25, {"random": weights.random_matcher_tree(
            bm, RANDOM_MATCHER_SEED)}, bm,
        (weights.random_lifter_tree(bl, 1), bl), "irls",
        (frames(b25, N_VARIANT, (2, 3), 1),))
    for name, rc, residual in (
            ("alt2", dataclasses.replace(PANOPTIC, graph_alternative="2"),
             False),
            ("alt1", dataclasses.replace(PANOPTIC, graph_alternative="1"),
             False),
            ("residual", PANOPTIC, True)):
        mc = MatcherConfig(in_dim=rc.matcher_feature_dim_alt(
            rc.graph_alternative), residual=residual)
        V[name] = Variant(
            {"alt2": "alt-2 graph", "alt1": "alt-1 graph",
             "residual": "residual matcher"}[name], rc,
            {"random": weights.random_matcher_tree(mc, RANDOM_MATCHER_SEED)},
            mc, panoptic_lifter, panoptic_prior,
            (frames(rc, N_VARIANT, (2, 3), 1),))
    return V


def gat_stack_entry(label, x, pw, gtopo, m, path):
    """A report row of the stack GAT kernel at these inputs (with
    ``edge_const``, as the pipeline serves it): held to its plain version,
    two calls bit-equal, timed, its bound from ``gat_costs``."""
    import torch
    from mpe3d_tpu_torch.ops import gat_kernel
    args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope)
    call = lambda: gat_kernel.gat_stack(*args, edge_const=True)  # noqa
    got, again = call(), call()
    ref = gat_kernel.gat_stack_plain(*args, edge_const=True)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > GAT_RTOL * (1 + ref.abs())).any()):
        raise AssertionError(f"gat_stack {label}: max |d logit| "
                             f"{float(err.max()):.3g}")
    if not torch.equal(got, again):
        raise AssertionError(f"gat_stack {label}: two calls differ")
    b_ms, b_by = bound(*gat_costs(x, m.flat.numel(), m.dims, gtopo.n_pairs,
                                  gtopo.inc.shape[1], True))
    dev, n_k = device_profile(call)
    row = {"name": "gat_stack", "route": "cuda",
           "source": "mpe3d_tpu_torch/csrc/gat_stack.cu",
           "replaces": "mpe3d_tpu/ops/gat_kernel.py:206", "launches": 0,
           "max_abs_err": float(err.max()), "ms": median_ms(call),
           "plain_ms": median_ms(lambda: gat_kernel.gat_stack_plain(
               *args, edge_const=True)), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "device_ms": dev,
           "case": label, "path": path}
    print(f"  gat_stack {label}: H={gtopo.n_heads} E={gtopo.n_pairs} head "
          f"degree {gtopo.inc.shape[1]} in_dim {x.shape[1]}, max |d logit| "
          f"{row['max_abs_err']:.3g} (tol {GAT_RTOL:g} x (1+|logit|)), two "
          f"calls bit-equal; {row['ms']:.4f} ms, device {dev:.4f} ms "
          f"({n_k:g} CUDA launches a call), plain {row['plain_ms']:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by})", flush=True)
    return row


def proj_entry(label, x, pw, gtopo, m, path):
    """A report row of the fused projection on the five layer inputs the
    layer form gives these GAT inputs (``check_proj_kernel``: against its
    plain version and fp64, timed in turns with the addmm chain)."""
    row = []
    check_proj_kernel({label: (x, pw, gtopo, m)}, row)
    row[0].update(case=label, path=path)
    return row[0]


def run_entry(label, lifter, nets, replaces, library_of, path):
    """A report row of the whole lifter net as one run launch on the
    serving path's rows: against its plain version (MLP_NET_TOL), two
    launches bit-equal, timed in turns with its PyTorch yardstick."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp
    layers = lifter.packed_layers()
    if fused_mlp.launch_plan(layers) != [("run", 0, len(layers))]:
        raise AssertionError(f"{label}: the lifter is not one run")
    slope, out_dim = lifter.cfg.negative_slope, lifter.cfg.out_dim
    x = nets.float().contiguous()
    run = lambda: fused_mlp.fused_mlp_forward(x, layers, slope,  # noqa
                                              out_dim)
    got, again = run(), run()
    ref = fused_mlp.fused_mlp_plain(x, layers, slope, out_dim)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= MLP_NET_TOL):
        raise AssertionError(f"{label}: max err {err:.3g} > {MLP_NET_TOL}")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    lib_label, library = library_of(layers, slope)
    ms, lib_ms = in_turns(run, lambda: library(x))
    bytes_, flops = run_costs(layers, x)
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    row = {"name": "mlp_run", "route": "cuda",
           "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": median_ms(lambda: fused_mlp.fused_mlp_plain(
               x, layers, slope, out_dim)),
           "bound_ms": 1e3 * max(t_b, t_f),
           "bound_by": "bytes" if t_b > t_f else "operations",
           "library_ms": lib_ms, "device_ms": device_ms(run),
           "case": f"{label}, M={x.shape[0]}", "path": path}
    K0 = fused_mlp.layer_shape(layers[0])[0]
    print(f"  mlp_run {label}: whole net ({len(layers)} layers, K0={K0}, "
          f"head {out_dim}, one launch) on {x.shape[0]} rows: max err "
          f"{err:.3g} (tol {MLP_NET_TOL:g}), two launches bit-equal; "
          f"{ms:.4f} ms, device {row['device_ms']:.4f} ms, library "
          f"({lib_label}) {lib_ms:.4f} ms in turns, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}: {bytes_} bytes)", flush=True)
    return row


def int8_entries(label, lifter, nets, path):
    """Report rows of an int8 lifter's int8 layers on the serving path's
    rows: as one run launch (fused_mlp.py:80) and each alone through
    ``int8_layer_matmul`` (quant_matmul.py:73), each layer alone held to
    its plain version (``check_int8_layers``), both timed in turns with the
    int8 yardstick."""
    import torch
    from mpe3d_tpu_torch.ops import fused_mlp, quant_matmul
    x = nets.float().contiguous()
    inputs = check_int8_layers(label, lifter, x)
    layers = lifter.packed_layers()
    slope = lifter.cfg.negative_slope
    body = layers[:-1]
    acts = [True] * len(body)
    one = lambda: fused_mlp.run_layers(x, body, slope, acts)  # noqa: E731
    got, again = one(), one()
    ref = fused_mlp.run_plain(x, body, slope, acts)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not (err <= MLP_NET_TOL and torch.equal(got, again)):
        raise AssertionError(f"{label}: int8 run max err {err:.3g}, or two "
                             f"launches differ")
    alone = lambda: [quant_matmul.int8_layer_matmul(h, layer, slope)  # noqa
                     for h, layer in inputs]
    lib_label, library = int8_yardstick(body, slope)
    rows = []
    for replaces, kernel, plain, (bytes_, flops) in (
            ("mpe3d_tpu/ops/fused_mlp.py:80", one,
             lambda: fused_mlp.run_plain(x, body, slope, acts),
             run_costs(body, x)),
            ("mpe3d_tpu/ops/quant_matmul.py:73", alone,
             lambda: [fused_mlp.layer_plain(h, layer, slope, True)
                      for h, layer in inputs],
             mlp_costs(body, x.shape[0]))):
        ms, lib_ms = in_turns(kernel, lambda: library(x))
        t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
        rows.append({
            "name": "mlp_run", "route": "cuda",
            "source": "mpe3d_tpu_torch/csrc/fused_mlp.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": median_ms(plain),
            "bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b > t_f else "operations",
            "library_ms": lib_ms, "device_ms": device_ms(kernel),
            "case": f"{label}, M={x.shape[0]}", "path": path})
    a, b = rows
    print(f"  mlp_run (int8 kind) {label}: its {len(body)} int8 layers "
          f"(K0={fused_mlp.layer_shape(body[0])[0]}) as one run on "
          f"{x.shape[0]} rows: max err {err:.3g}, two launches bit-equal, "
          f"{a['ms']:.4f} ms, device {a['device_ms']:.4f} ms, bound "
          f"{a['bound_ms']:.5f} ms; each alone (int8_layer_matmul): "
          f"{b['ms']:.4f} ms, device {b['device_ms']:.4f} ms, bound "
          f"{b['bound_ms']:.5f} ms; library ({lib_label}) "
          f"{a['library_ms']:.4f} / {b['library_ms']:.4f} ms in turns",
          flush=True)
    return rows


def frame_entry(label, args, kw, path):
    """A report row of the decode + gather + pack kernel on one frame's
    inputs at its pipeline's prior and gate, after every prior with and
    without the gate is held to the plain version."""
    from mpe3d_tpu_torch.ops import frame_kernel as fk
    cases = [(p, g) for p in fk.PRIORS for g in (None, 8.0)]
    max_err = check_frame_cases(args, kw, cases, label)
    out = fk.frame_decode_pack(*args, **kw)
    bytes_, ops = frame_costs(args, kw, out)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS
    call = lambda: fk.frame_decode_pack(*args, **kw)  # noqa: E731
    ms, dev_ms = median_ms(call), device_ms(call)
    row = {"name": "frame_decode_pack", "route": "cuda",
           "source": "mpe3d_tpu_torch/csrc/frame_decode_pack.cu",
           "replaces": "mpe3d_tpu/ops/frame_kernel.py:358", "launches": 0,
           "max_abs_err": max_err, "ms": ms,
           "plain_ms": median_ms(lambda: fk.frame_decode_pack_plain(*args,
                                                                    **kw)),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes > t_ops else "operations",
           "library_ms": None, "device_ms": dev_ms,
           "case": f"{label}, {kw['prior']} prior", "path": path}
    Cu, S, J = args[4].shape[:3]
    print(f"  frame_decode_pack {label} (Cu={Cu}, S={S}, J={J}, "
          f"{kw['prior']} prior, {Cu * (Cu - 1) // 2} camera pairs): "
          f"{ms:.4f} ms, device {dev_ms:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})", flush=True)
    return row


def check_variant_kernels(V, report):
    """Phase 3 at the shapes of phase 8, each held to its plain version on
    the card: ``gat_stack`` at ARPLAB S=4 (in_dim 1082, head degree 20;
    the random matcher, and the trained one against fp64), at BODY_25's
    in_dim 1252 and alt-2's 362; K1/K2 at ARPLAB S=10 (H=60, E=1500,
    D=50), both matchers; ``mlp_run`` bf16 at K0=1512 (M=8, and M=16-64
    through ``check_run_rows``) and K0=1750 with the 75-wide head; the int8
    ``arp_irls`` layers as one run and one layer at a time; the decode at
    Cu=6 (IRLS, median: 15 camera pairs) and J=25; the projection on a
    residual matcher's layer inputs."""
    arp, arpb, b25 = V["arplab"], V["arplab_bf16"], V["body25"]
    f4, f10 = arp.frames
    rows = []
    # the stack GAT kernel
    a4 = arp.pipeline("random", GPU, True)
    x, pw, gtopo, form = a4.gat_stage_inputs(f4[0])
    if form != "stack" or gtopo.inc.shape[1] != 20:
        raise AssertionError(f"ARPLAB S=4: form {form}, head degree "
                             f"{gtopo.inc.shape}")
    rows.append(gat_stack_entry("ARPLAB S=4, random matcher", x, pw, gtopo,
                                a4.matcher, "arplab"))
    rows.append(proj_entry("ARPLAB S=4, random matcher", x, pw, gtopo,
                           a4.matcher, "arplab_layer"))
    t4 = arp.pipeline("trained", GPU, True)
    check_stack_trained("ARPLAB S=4", *t4.gat_stage_inputs(f4[0])[:3],
                        t4.matcher)
    bp = b25.pipeline("random", GPU, True)
    x, pw, gtopo, _ = bp.gat_stage_inputs(b25.frames[0][0])
    rows.append(gat_stack_entry("BODY_25 S=4, in_dim 1252", x, pw, gtopo,
                                bp.matcher, "body25"))
    rows.append(proj_entry("BODY_25 S=4, in_dim 1252", x, pw, gtopo,
                           bp.matcher, "body25_layer"))
    alt2 = V["alt2"].pipeline("random", GPU)
    x, pw, gtopo, _ = alt2.stage_inputs(V["alt2"].frames[0][0])
    rows.append(gat_stack_entry("alt-2 S=4, in_dim 362", x, pw, gtopo,
                                alt2.matcher, "alt2"))
    rows.append(proj_entry("alt-2 S=4, in_dim 362", x, pw, gtopo,
                           alt2.matcher, "alt2_layer"))
    # the tiled GAT kernels at ARPLAB S=10
    errs = []
    for m in ("trained", "random"):
        p10 = arp.pipeline(m, GPU, True, slots=(10,), persons=(16,),
                           prior=CROWDED_PRIOR)
        x, pw, gtopo, form = p10.gat_stage_inputs(f10[0])
        if form != "tiled":
            raise AssertionError(f"ARPLAB S=10: form {form}")
        errs.append(check_tiled_case(f"ARPLAB S=10, {m} matcher", x, pw,
                                     gtopo, p10.matcher))
        if m == "trained":
            tiled = time_tiled_kernels("ARPLAB S=10", x, pw, gtopo,
                                       p10.matcher)
    for r, e in zip(tiled, (max(e[0] for e in errs),
                            max(e[1] for e in errs))):
        r.update(max_abs_err=e, case="ARPLAB S=10", path="arplab10")
    rows += tiled
    # the lifter run kernel
    ab = arpb.pipeline("random", GPU, True)
    nets = ab.stage_inputs(f4[0])[3]
    rows.append(run_entry("bf16 ARPLAB", ab.lifter, nets,
                          "mpe3d_tpu/ops/fused_mlp.py:57", bf16_library,
                          "arplab_bf16"))
    _, _, turns = check_run_rows("bf16 ARPLAB", ab.lifter, nets, rows,
                                 "mpe3d_tpu/ops/fused_mlp.py:57",
                                 bf16_library)
    rows[-1].update(case="bf16 ARPLAB, M=64", path="arplab_bf16_batch")
    check_run_wide("bf16 ARPLAB", ab.lifter, nets, rows,
                   "mpe3d_tpu/ops/fused_mlp.py:57", bf16_library)
    rows.append(run_entry("bf16 BODY_25", bp.lifter,
                          bp.stage_inputs(b25.frames[0][0])[3],
                          "mpe3d_tpu/ops/fused_mlp.py:57", bf16_library,
                          "body25"))
    rows += int8_entries("arp_irls", a4.lifter, a4.stage_inputs(f4[0])[3],
                         "arplab")
    # the decode + gather + pack kernel
    rows.append(frame_entry("ARPLAB S=4", *a4.frame_stage_inputs(f4[0]),
                            "arplab"))
    rows.append(frame_entry("ARPLAB S=4", *ab.frame_stage_inputs(f4[0]),
                            "arplab_bf16"))
    rows.append(frame_entry("BODY_25 S=4",
                            *bp.frame_stage_inputs(b25.frames[0][0]),
                            "body25"))
    # the projection on a residual matcher (the layer form's inputs)
    res = V["residual"].pipeline("random", GPU)
    x, pw, gtopo, _ = res.stage_inputs(V["residual"].frames[0][0])
    rows.append(proj_entry("S=4, residual matcher", x, pw, gtopo,
                           res.matcher, "residual"))
    report.extend(rows)
    return turns


def run_variant(v, matcher, frames, label, **kw):
    """One phase 8 run: the card against the CPU on ``frames``
    (``run_main_path``); the CPU takes the same path (the frame path's
    plain versions where the card serves it)."""
    gpu = v.pipeline(matcher, GPU, **kw)
    frame_path = any(gpu.serving_path(S)[1] for S in gpu.slot_buckets)
    cpu = v.pipeline(matcher, "cpu", True if frame_path else None, **kw)
    return gpu, run_main_path(gpu, cpu, frames, f"{v.name}, {label}")


def write_matcher_npz(stem, tree, cfg):
    """A matcher checkpoint in the JAX package's npz layout
    (``checkpoint.py``): the leaves in flatten (sorted-key) order and the
    meta with the architecture."""
    import dataclasses
    import numpy as np
    leaves = [np.asarray(layer[k]) for layer in tree["layers"]
              for k in sorted(layer)]
    meta = json.dumps({"matcher_config": dataclasses.asdict(cfg)}).encode()
    np.savez(stem + ".npz", __meta_json__=np.frombuffer(meta, np.uint8),
             **{f"p.leaf_{i:05d}": a for i, a in enumerate(leaves)})


def check_serve_arplab(v, lines):
    """``python3 -m mpe3d_tpu_torch serve --rig ARPLAB`` on the card over
    stdio, on ``arp_irls``'s lifter with the random matcher (a models
    directory in a temporary directory: the lifter linked, the matcher
    written in the npz layout), against PoseServer on a CPU pipeline of
    the same directory.  Returns the median latency_ms."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        for name in ("pose_estimator.npz", "pose_estimator.json"):
            if os.path.exists(os.path.join(DEMO_ARP, name)):
                os.symlink(os.path.join(DEMO_ARP, name),
                           os.path.join(d, name))
        write_matcher_npz(os.path.join(d, "skeleton_matching"),
                          v.matchers["random"], v.mcfg)
        argv = ("--rig", "ARPLAB", "--modelsdir", d)
        got, err = serve_stdio(lines, 1, 1e6, *argv)
        rc, _, cpu = cli_pipeline(*argv, "--cpu")
        ref, _ = serve_in_process(cpu, rc, lines, 1, 1e6)
    n, dp, dq = compare_records(got, ref, "serve --rig ARPLAB")
    n_frames = len(lines) - 1
    if n < n_frames // 2 or f"native {n_frames}, python 0" not in err:
        raise AssertionError(f"serve --rig ARPLAB: {n} records with persons, "
                             f"or the parser missed lines: {err[-2000:]}")
    lats = [g["latency_ms"] for g in got if "latency_ms" in g]
    print(f"  serve --rig ARPLAB (stdio, depth 1, random matcher on "
          f"arp_irls's lifter): {len(got)} records equal to the CPU's, {n} "
          f"with persons, max |d pose| {dp:.3g} m, max |d quality| "
          f"{dq:.3g} px, latency_ms {lats}; the server's stderr ends: "
          f"{err.strip()[-600:]!r}", flush=True)
    return statistics.median(lats)


def run_variants(V):
    """Phase 8: each configuration on the card against the CPU.  Returns
    (launches by report path, median frame ms by run)."""
    from mpe3d_tpu_torch.ops.frame_kernel import frame_kernel_supported
    arp, arpb = V["arplab"], V["arplab_bf16"]
    f4, f10 = arp.frames
    launches, ms = {}, {}
    for v, key in ((arp, "arplab"), (arpb, "arplab_bf16")):
        for m in ("trained", "random"):
            gpu, (n, t, paths, _) = run_variant(v, m, f4, f"{m} matcher, "
                                                f"S=4 frame path")
            want = "int8" if key == "arplab" else "bf16"
            if paths != {4: ("stack", True)} or gpu.serve_dtype != want:
                raise AssertionError(f"{v.name}: paths {paths}, lifter "
                                     f"{gpu.serve_dtype}")
            ms[f"{v.name}, {m}, S=4"] = t
            if m == "random":
                launches[key] = n
                stage_table(gpu, f4, f"{v.name}, random matcher, S=4")
            gpu, (n, t, paths, _) = run_variant(
                v, m, f10, f"{m} matcher, S=10 (mean prior)", slots=(4, 10),
                persons=(8, 16), prior=CROWDED_PRIOR)
            if paths != {10: ("tiled", True)}:
                raise AssertionError(f"{v.name} S=10: paths {paths}")
            ms[f"{v.name}, {m}, S=10"] = t
            if (key, m) == ("arplab", "trained"):
                launches["arplab10"] = n
        launches[key + "_batch"] = run_batch_path(
            v.pipeline("random", GPU), v.pipeline("random", "cpu", True), f4,
            f"infer_batch, {v.name}, random matcher, {len(f4)} S=4 frames")
    ms["serve --rig ARPLAB latency_ms"] = check_serve_arplab(
        arp, [json.dumps(f) for f in arp.wire[:N_SHORT]]
        + ['{"cmd": "close"}'])
    for key, want in (("body25", ("stack", True)), ("alt2", ("stack", False)),
                      ("alt1", ("alt1", False)),
                      ("residual", ("layer", False))):
        v = V[key]
        gpu, (n, t, paths, _) = run_variant(v, "random", v.frames[0],
                                            "random matcher")
        if paths != {4: want} or frame_kernel_supported(gpu) != want[1]:
            raise AssertionError(f"{v.name}: paths {paths}")
        launches[key], ms[f"{v.name}, random"] = n, t
    # the layer form (eager path) at the shapes of the projection's rows
    for key in ("arplab", "body25", "alt2"):
        v = V[key]
        kw = dict(use_frame_kernel=False, use_layer_matcher=True)
        n, t, paths, _ = run_main_path(
            v.pipeline("random", GPU, **kw), v.pipeline("random", "cpu",
                                                        **kw),
            v.frames[0][:N_VARIANT], f"{v.name}, random matcher, layer form")
        if paths != {4: ("layer", False)}:
            raise AssertionError(f"{v.name} layer form: paths {paths}")
        launches[key + "_layer"] = n
        ms[f"{v.name}, random, layer form"] = t
    return launches, ms


# ---------------------------------------------------------------------------
# phase 9: evaluation and label-free lifter training
# ---------------------------------------------------------------------------

TRAIN_SEED = 3             # the numpy init of the full-width lifter
N_TRAIN, N_DEV, TRAIN_BATCH, TRAIN_EPOCHS = 512, 128, 256, 2
# per-epoch train and dev losses, card against CPU from the same init: the
# same fp32 steps (TF32 off) summed in other orders; Adam's normalised
# steps (lr 1e-4) keep the drift to about that size per step
TRAIN_RTOL = 1e-3
N_EVAL_FRAMES, EVAL_STREAM = 16, 3
# the evaluation's thresholds (mm): an AP or recall entry may differ between
# the card and the CPU only where a matched pose's error lies within the
# poses' tolerance (POSE_TOL_M) of a threshold; MPJPE within POSE_TOL_M
AP_THRESHOLDS_MM = tuple(range(25, 155, 25))
# the lifter trained on for a chunk of epochs toward the largest AP
# threshold (so AP and recall would compare hits), at the reference's lr
# (1e-3 diverged: the poses left the cameras' fronts, where the clipped
# loss has no gradient); the ring rig's matching keeps MPJPE above it (the
# IRLS triangulation of the same groups reads about 342 mm), so one chunk
MORE_EPOCHS, MORE_LR = 40, 1e-4


def train_full_width(rig_config, rig, smi):
    """Phase 9 (a): the full-width lifter (``LifterConfig`` defaults, in_dim
    1260) trained for two epochs of two batches of 256 (``shuffle=False``)
    on single-person samples, on the card and on the CPU from the same
    numpy init; per-epoch train and dev losses within ``TRAIN_RTOL``.  Then
    the card's run again, warm, for its epoch times.  Returns (the card's
    trained tree, its LifterConfig)."""
    import dataclasses

    from mpe3d_tpu_torch.config import LifterTrainConfig
    from mpe3d_tpu_torch.train.lifter import train_lifter

    data, cfg, init = phase9_lifter_data(rig_config, rig)
    tcfg = LifterTrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                             eval_every=1, shuffle=False)
    runs = {}
    for device in (GPU, "cpu"):
        t = time.perf_counter()
        runs[device] = (train_lifter(*data, rig_config, rig, cfg, tcfg,
                                     params=init, log=lambda s: None,
                                     device=device),
                        time.perf_counter() - t)
    hist = {d: [(h["train_loss"], h["val_loss"]) for h in r.history]
            for d, (r, _) in runs.items()}
    worst = max(abs(a / b - 1.0) for g, c in zip(hist[GPU], hist["cpu"])
                for a, b in zip(g, c))
    if len(hist[GPU]) != TRAIN_EPOCHS or worst > TRAIN_RTOL:
        raise AssertionError(f"train_lifter: card {hist[GPU]} against CPU "
                             f"{hist['cpu']} (max rel {worst:.3g}, tol "
                             f"{TRAIN_RTOL})")
    card = runs[GPU][0]

    def epoch_seconds(res):
        ends = [h["elapsed_s"] for h in res.history]
        return [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]

    # the same training again, warm (the allocator's pool and cuBLAS
    # started by the first call), for the card's steady epoch time
    warm = train_lifter(*data, rig_config, rig, cfg,
                        dataclasses.replace(tcfg, epochs=TRAIN_EPOCHS + 2),
                        params=init, log=lambda s: None, device=GPU)
    n_weights = sum(a * b for a, b in cfg.layer_dims())
    warm_s = epoch_seconds(warm)
    print(f"  train_lifter at full width ({n_weights} weights), {N_TRAIN} "
          f"train / {N_DEV} dev samples, batch {TRAIN_BATCH}, "
          f"{TRAIN_EPOCHS} epochs: losses (train, dev) card {hist[GPU]}, "
          f"CPU {hist['cpu']}, max rel difference {worst:.3g}; card seconds "
          f"a epoch (dev evaluation included) "
          f"{[round(t, 4) for t in epoch_seconds(card)]}, whole call "
          f"{runs[GPU][1]:.2f} s; warm, {TRAIN_EPOCHS + 2} epochs: "
          f"{[round(t, 4) for t in warm_s]} s a epoch, train samples a "
          f"second {[round(N_TRAIN / t, 1) for t in warm_s]}; CPU whole "
          f"call {runs['cpu'][1]:.2f} s ({smi})", flush=True)
    return card.params, cfg


def borderline_poses(cpu, frames, gts, used_joints) -> int:
    """Matched poses of the CPU's ``infer_fused`` whose error (m) lies
    within ``POSE_TOL_M`` of an AP threshold."""
    import numpy as np
    from mpe3d_tpu_torch.eval.pose_metrics import (best_permutation,
                                                   pose_error_table)
    near = 0
    for fa, gt in zip(frames, gts):
        poses = cpu.infer_fused(fa).poses
        table = pose_error_table(gt.gt3d, gt.gt_valid, poses, used_joints)
        for g, r in enumerate(best_permutation(table)):
            if r < len(poses):
                near += int(any(abs(table[g, r] * 1e3 - th)
                                < POSE_TOL_M * 1e3
                                for th in AP_THRESHOLDS_MM))
    return near


def compare_pose_reports(got, ref, near, label):
    """Counts equal, MPJPE within POSE_TOL_M, AP and recall a threshold
    equal unless ``near`` poses lie near a threshold."""
    for k in ("n_gt", "n_poses", "n_matched", "n_frames"):
        if got[k] != ref[k]:
            raise AssertionError(f"{label}: {k} {got[k]} != CPU {ref[k]}")
    d_mpjpe = abs(got["mpjpe_mm"] - ref["mpjpe_mm"])
    if not d_mpjpe <= POSE_TOL_M * 1e3:
        raise AssertionError(f"{label}: MPJPE {got['mpjpe_mm']} against CPU "
                             f"{ref['mpjpe_mm']}")
    d_ap = max(abs(got["ap_per_threshold"][t][m]
                   - ref["ap_per_threshold"][t][m])
               for t in ref["ap_per_threshold"] for m in ("ap", "recall"))
    if near == 0 and d_ap > 1e-9:
        raise AssertionError(f"{label}: AP/recall differ by {d_ap} with no "
                             f"pose near a threshold")
    return d_mpjpe, d_ap


def eval_on_card(rig_config, rig, ltree, lcfg, matchers, mcfg, smi, d):
    """Phase 9 (b)-(d) in the models directory ``d``: the trained lifter
    served bf16 through the kernels by ``run_pose_metrics`` (fused and
    stream), ``sm-metrics`` and ``reprojection-error`` in this process,
    then ``train-lifter`` and ``metrics-from-model --fused`` as
    subprocesses.  Returns the launches of the fused evaluation run."""
    import contextlib
    import io
    import shutil

    import numpy as np
    from mpe3d_tpu_torch import cli, weights
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.data.frames import load_eval_frames
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                generate_single_person_frames,
                                                write_frames)
    from mpe3d_tpu_torch.eval.runners import run_pose_metrics
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    models = os.path.join(d, "models")
    save_checkpoint(os.path.join(models, "pose_estimator"), ltree,
                    meta={"lifter_config": lcfg, "prior": "mean"})
    write_matcher_npz(os.path.join(models, "skeleton_matching"),
                      matchers["random"], mcfg)
    test = os.path.join(d, "test.json")
    write_frames(generate_frames(rig_config, rig, N_EVAL_FRAMES,
                                 n_people=(2, 3), seed=21), test)
    fas, gts = load_eval_frames([test], rig_config)

    def pipe(tree, device, **kw):
        p = PoseEstimationPipeline.from_checkpoint(
            models, rig, rig_config, device=device, serve_dtype=None,
            slot_buckets=(4,), person_buckets=(8,), **kw)
        p.matcher = weights.matcher_from_tree(tree, mcfg, device)
        return p

    fused_launches, lines = None, []
    for mlabel, tree in matchers.items():
        gpu, cpu = pipe(tree, GPU), pipe(tree, "cpu", use_frame_kernel=True)
        if gpu.serve_dtype != "bf16" or not gpu.frame_path_on():
            raise AssertionError(f"the trained lifter serves "
                                 f"{gpu.serve_dtype}, frame path "
                                 f"{gpu.frame_path_on()}")
        near = borderline_poses(cpu, fas, gts, rig_config.used_joints)
        for mode in (dict(fused=True), dict(stream=EVAL_STREAM)):
            label = f"run_pose_metrics {mode}, {mlabel} matcher"
            reset_launches()
            got = run_pose_metrics((fas, gts), rig_config, gpu, datastep=1,
                                   **mode)
            launches = read_launches()
            want = expected_launches(gpu, fas)
            if launches != want:
                raise AssertionError(f"{label}: launches {launches}, "
                                     f"expected {want}")
            ref = run_pose_metrics((fas, gts), rig_config, cpu, datastep=1,
                                   **mode)
            d_mpjpe, d_ap = compare_pose_reports(got, ref, near, label)
            fused_launches = fused_launches or launches
            lines.append(
                f"{label}: n_gt {got['n_gt']}, n_poses {got['n_poses']}, "
                f"n_matched {got['n_matched']} (= CPU), MPJPE "
                f"{got['mpjpe_mm']:.3f} mm (CPU {ref['mpjpe_mm']:.3f}), mAP "
                f"{got['mAP']:.3f} (CPU {ref['mAP']:.3f}), max |d AP/recall| "
                f"{d_ap:.3g} with {near} poses within {POSE_TOL_M * 1e3:g} "
                f"mm of a threshold, t_e2e_ms {got['t_e2e_ms']:.3f}, "
                f"launches {launches}")
    # the triangulation backend (median filter) on the eager path: some
    # poses within centimetres of the GT, so the AP comparison has hits
    tri = {dev: PoseEstimationPipeline(
        rig_config, rig, weights.matcher_from_tree(matchers["random"], mcfg,
                                                   dev), None,
        slot_buckets=(4,), person_buckets=(8,), device=dev,
        backend="triangulation", tri_variant="median")
        for dev in (GPU, "cpu")}
    near = borderline_poses(tri["cpu"], fas, gts, rig_config.used_joints)
    label = "run_pose_metrics fused, triangulation backend, random matcher"
    reset_launches()
    got = run_pose_metrics((fas, gts), rig_config, tri[GPU], datastep=1,
                           fused=True)
    launches = read_launches()
    if launches["gat_stack"] != len(fas):
        raise AssertionError(f"{label}: launches {launches}")
    ref = run_pose_metrics((fas, gts), rig_config, tri["cpu"], datastep=1,
                           fused=True)
    d_mpjpe, d_ap = compare_pose_reports(got, ref, near, label)
    if got["mAP"] <= 0:
        raise AssertionError(f"{label}: no hit at any threshold")
    lines.append(f"{label}: n_poses {got['n_poses']}, n_matched "
                 f"{got['n_matched']} (= CPU), MPJPE {got['mpjpe_mm']:.3f} mm "
                 f"(CPU {ref['mpjpe_mm']:.3f}), mAP {got['mAP']:.3f} (CPU "
                 f"{ref['mAP']:.3f}), max |d AP/recall| {d_ap:.3g} with "
                 f"{near} poses near a threshold, launches {launches}")
    for ln in lines:
        print(f"  {ln} ({smi})", flush=True)

    def report(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        text = out.getvalue()
        return json.loads(text[text.index("{"):])

    for command in (["sm-metrics", "--datastep", "1"],
                    ["reprojection-error", "--showgt"]):
        argv = [*command, "--modelsdir", models, "--testfiles", test]
        got, ref = report(argv), report([*argv, "--cpu"])
        if got["n_frames"] != ref["n_frames"] or got["n_frames"] == 0:
            raise AssertionError(f"{command[0]}: n_frames {got['n_frames']}"
                                 f" against CPU {ref['n_frames']}")
        if command[0] == "sm-metrics":
            diff = max(abs(got[k] - ref[k]) for k in ("ari", "homogeneity",
                                                      "completeness",
                                                      "v_measure"))
            tol = 1e-9
        else:
            a = np.array([got[s][m] for s in ("mlp", "triangulation", "gt")
                          for m in ("mean_px", "median_px")], np.float64)
            b = np.array([ref[s][m] for s in ("mlp", "triangulation", "gt")
                          for m in ("mean_px", "median_px")], np.float64)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"{command[0]}: cameras without "
                                     f"errors differ from the CPU's")
            diff = float(np.abs(np.nan_to_num(a - b)).max())
            tol = QUALITY_TOL_PX
        if not diff <= tol:
            raise AssertionError(f"{command[0]} on the card against the CPU:"
                                 f" max difference {diff} (tol {tol})")
        print(f"  python -m mpe3d_tpu_torch {' '.join(command)} on the card "
              f"(in this process): {json.dumps(got)[:400]}; against --cpu: "
              f"max difference {diff:.3g} (tol {tol})", flush=True)

    sub = os.path.join(d, "cli_models")
    for name, n, seed in (("train", 64, 12), ("dev", 16, 13)):
        write_frames(generate_single_person_frames(rig_config, rig, n,
                                                   seed=seed),
                     os.path.join(d, f"{name}.json"))
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mpe3d_tpu_torch", "train-lifter",
         "--modelsdir", sub, "--trainset", os.path.join(d, "train.json"),
         "--devset", os.path.join(d, "dev.json"), "--epochs", "2",
         "--batch-size", str(TRAIN_BATCH)], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    t_train = time.perf_counter() - t
    if (r.returncode != 0 or "best dev loss" not in r.stdout
            or not os.path.exists(os.path.join(sub, "pose_estimator.npz"))):
        raise AssertionError(f"train-lifter: rc {r.returncode}\n{r.stdout}"
                             f"\n{r.stderr[-3000:]}")
    for f in ("skeleton_matching.npz",):
        shutil.copy(os.path.join(models, f), os.path.join(sub, f))
    t = time.perf_counter()
    m = subprocess.run(
        [sys.executable, "-m", "mpe3d_tpu_torch", "metrics-from-model",
         "--modelsdir", sub, "--testfiles", test, "--fused", "--datastep",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_metrics = time.perf_counter() - t
    rep = (json.loads(m.stdout[m.stdout.index("{"):])
           if m.returncode == 0 and "{" in m.stdout else None)
    if (rep is None or rep["n_frames"] != N_EVAL_FRAMES
            or rep["n_poses"] == 0 or not np.isfinite(rep["mpjpe_mm"])):
        raise AssertionError(f"metrics-from-model: rc {m.returncode}\n"
                             f"{m.stdout}\n{m.stderr[-3000:]}")
    print(f"  python -m mpe3d_tpu_torch train-lifter --epochs 2 (subprocess, "
          f"full width, {t_train:.1f} s): "
          f"{' | '.join(r.stdout.strip().splitlines()[-2:])}; "
          f"metrics-from-model --fused on its checkpoint (subprocess, "
          f"{t_metrics:.1f} s): n_frames {rep['n_frames']}, n_poses "
          f"{rep['n_poses']}, MPJPE {rep['mpjpe_mm']:.1f} mm, t_e2e_ms "
          f"{rep['t_e2e_ms']:.3f} ({smi})", flush=True)
    return fused_launches


def train_toward_thresholds(rig_config, rig, ltree, lcfg, matchers, mcfg,
                            d, smi):
    """Phase 9 (a'): the card's lifter trained on for ``MORE_EPOCHS``
    epochs (the phase's samples shuffled, lr ``MORE_LR``, each epoch
    evaluated, the best kept), and its MPJPE on the 16 GT frames of the
    evaluation (random matcher, ``run_pose_metrics`` fused on the card)
    before and after, beside the IRLS triangulation of the same decoded
    groups.  Returns the tree."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import LifterTrainConfig
    from mpe3d_tpu_torch.data.frames import load_eval_frames
    from mpe3d_tpu_torch.data.synthetic import generate_frames, write_frames
    from mpe3d_tpu_torch.eval.runners import run_pose_metrics
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch.train.lifter import train_lifter

    data, _, _ = phase9_lifter_data(rig_config, rig)
    test = os.path.join(d, "test.json")
    write_frames(generate_frames(rig_config, rig, N_EVAL_FRAMES,
                                 n_people=(2, 3), seed=21), test)
    fas, gts = load_eval_frames([test], rig_config)
    matcher = weights.matcher_from_tree(matchers["random"], mcfg, GPU)

    def mpjpe(tree):
        pipe = PoseEstimationPipeline(
            rig_config, rig, matcher, weights.lifter_from_tree(tree, lcfg,
                                                               GPU),
            slot_buckets=(4,), person_buckets=(8,), device=GPU)
        return run_pose_metrics((fas, gts), rig_config, pipe, datastep=1,
                                fused=True)["mpjpe_mm"]

    tcfg = LifterTrainConfig(epochs=MORE_EPOCHS, batch_size=TRAIN_BATCH,
                             eval_every=1, lr=MORE_LR,
                             patience=MORE_EPOCHS, seed=TRAIN_SEED)
    trail = [(TRAIN_EPOCHS, mpjpe(ltree))]
    t = time.perf_counter()
    ltree = train_lifter(*data, rig_config, rig, lcfg, tcfg, params=ltree,
                         log=lambda s: None, device=GPU).params
    spent = time.perf_counter() - t
    trail.append((TRAIN_EPOCHS + MORE_EPOCHS, mpjpe(ltree)))
    under = trail[-1][1] < AP_THRESHOLDS_MM[-1]
    # the matching's share: the triangulation backend on the same groups
    tri = PoseEstimationPipeline(rig_config, rig, matcher, None,
                                 slot_buckets=(4,), person_buckets=(8,),
                                 device=GPU, backend="triangulation",
                                 tri_variant="irls")
    floor = run_pose_metrics((fas, gts), rig_config, tri, datastep=1,
                             fused=True)["mpjpe_mm"]
    print(f"  the card's lifter trained on ({spent:.1f} s, lr {MORE_LR}, "
          f"{MORE_EPOCHS} epochs): MPJPE (epochs, mm) "
          f"{[(e, round(float(m), 1)) for e, m in trail]}; "
          + ("under" if under else "NOT under")
          + f" the largest AP threshold {AP_THRESHOLDS_MM[-1]} mm"
          + f"; the IRLS triangulation of the same decoded groups: MPJPE "
          f"{floor:.1f} mm ({smi})", flush=True)
    return ltree


def run_eval_and_training(rig_config, rig, matchers, mcfg, smi):
    """Phase 9: ``train_full_width``, ``train_toward_thresholds``, then
    ``eval_on_card`` in a temporary directory.  Returns the fused
    evaluation's launches and the trained lifter (tree, LifterConfig)."""
    import tempfile
    ltree, lcfg = train_full_width(rig_config, rig, smi)
    with tempfile.TemporaryDirectory() as d:
        ltree = train_toward_thresholds(rig_config, rig, ltree, lcfg,
                                        matchers, mcfg, d, smi)
    with tempfile.TemporaryDirectory() as d:
        return (eval_on_card(rig_config, rig, ltree, lcfg, matchers, mcfg,
                             smi, d), ltree, lcfg)


# ---------------------------------------------------------------------------
# phase 10: matcher training and the model files
# ---------------------------------------------------------------------------

MATCHER_SEED = 5           # the numpy init of the full-width matcher
N_M_TRAIN, N_M_DEV, M_BATCH, M_EPOCHS = 150, 45, 15, 3
# the shipped matcher fine-tuned on the ring rig's scenes decodes 2-3
# persons a S=4 frame there (0-1 before); from the numpy init it decodes
# none after as many epochs
M_TUNE_EPOCHS = 10
M_PRUNE_DIST = 0.2
N_STEPS_TIMED = 10         # warm training steps timed alone
N_SYNTH, SYNTH_SLOTS = 1024, 6
RESIDUAL_SEED = 6


def matcher_scene_sets(rig_config, rig):
    """Three single-person recordings and the (train, dev) composite scenes
    built from them on the S=4 topology of the matching cameras."""
    from mpe3d_tpu_torch.data.synthetic import generate_single_person_frames
    from mpe3d_tpu_torch.matching.features import build_topology
    from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes

    files = [generate_single_person_frames(rig_config, rig, 40, seed=s)
             for s in (31, 32, 33)]
    topo = build_topology(rig_config.n_matching_cameras, 4)
    train = build_matcher_scenes(files, rig_config, topo, limit=N_M_TRAIN,
                                 seed=0)
    dev = build_matcher_scenes(files[::-1], rig_config, topo,
                               limit=N_M_DEV, seed=1)
    return files, topo, train, dev


def train_matcher_full_width(rig_config, rig, demo_tree, demo_cfg, smi):
    """Phase 10 (a): ``train_matcher`` at the reference's width (in_dim
    902, hidden (40, 40, 40, 30), heads (10, 10, 8, 5)) on S=4 composite
    scenes, batch 15, ``scan_epoch=False`` (both devices take numpy's
    order), dropout off, 3 epochs each evaluated, on the card and on the
    CPU from one numpy init: per-epoch train and dev losses within
    ``TRAIN_RTOL``, with MSE and with BCE under ``prune_dist``.  Then the
    MSE run warm for its epoch times, and ``N_STEPS_TIMED`` training steps
    alone (loss, autograd, AdamW) for scenes a second and the device's busy
    share.  And the shipped matcher (``demo_tree``) fine-tuned on the card
    for ``M_TUNE_EPOCHS`` epochs.  Returns (the fine-tuned tree, the
    MatcherConfig, the recordings, topology and dev scenes, the init)."""
    import dataclasses

    import numpy as np
    import torch
    from mpe3d_tpu_torch.config import MatcherConfig, MatcherTrainConfig
    from mpe3d_tpu_torch.train.lifter import Adam
    from mpe3d_tpu_torch.train.matcher import (MatcherObjective,
                                               scene_tensors, train_matcher)
    from mpe3d_tpu_torch.weights import (random_matcher_tree,
                                         trainable_matcher_from_tree)

    files, topo, train, dev = matcher_scene_sets(rig_config, rig)
    if len(train) < 100 or len(dev) < 30:
        raise AssertionError(f"matcher scenes: {len(train)} train, "
                             f"{len(dev)} dev")
    cfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    init = random_matcher_tree(cfg, MATCHER_SEED)
    card = None
    for label, loss in (("MSE", {}),
                        (f"BCE, prune_dist {M_PRUNE_DIST}",
                         dict(use_bce=True, prune_dist=M_PRUNE_DIST))):
        tcfg = MatcherTrainConfig(epochs=M_EPOCHS, batch_size=M_BATCH,
                                  eval_every=1, scan_epoch=False, **loss)
        runs = {}
        for device in (GPU, "cpu"):
            t = time.perf_counter()
            runs[device] = (train_matcher(train, dev, rig_config, rig, topo,
                                          cfg, tcfg, params=init,
                                          log=lambda s: None, device=device),
                            time.perf_counter() - t)
        hist = {d: [(h["train_loss"], h["val_loss"]) for h in r.history]
                for d, (r, _) in runs.items()}
        worst = max(abs(a / b - 1.0) for g, c in zip(hist[GPU], hist["cpu"])
                    for a, b in zip(g, c))
        if len(hist[GPU]) != M_EPOCHS or worst > TRAIN_RTOL:
            raise AssertionError(f"train_matcher ({label}): card "
                                 f"{hist[GPU]} against CPU {hist['cpu']} "
                                 f"(max rel {worst:.3g}, tol {TRAIN_RTOL})")
        card = card or (runs[GPU][0], tcfg)
        print(f"  train_matcher at full width ({label}), {len(train)} train "
              f"/ {len(dev)} dev S=4 scenes, batch {M_BATCH}, {M_EPOCHS} "
              f"epochs: losses (train, dev) card {hist[GPU]}, CPU "
              f"{hist['cpu']}, max rel difference {worst:.3g}; whole call "
              f"card {runs[GPU][1]:.2f} s, CPU {runs['cpu'][1]:.2f} s",
              flush=True)
    _, tcfg = card
    warm = train_matcher(train, dev, rig_config, rig, topo, cfg,
                         dataclasses.replace(tcfg, epochs=M_EPOCHS + 1),
                         params=init, log=lambda s: None, device=GPU)
    ends = [h["elapsed_s"] for h in warm.history]
    epoch_s = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
    # training steps alone: the scenes resident, no evaluation
    obj = MatcherObjective(rig.select(rig_config.matching_camera_indices()),
                           rig_config, topo, cfg, GPU)
    model = trainable_matcher_from_tree(init, cfg, GPU)
    opt = Adam(model.tree_params(), tcfg.lr, None,
               weight_decay=tcfg.weight_decay)
    batches = [scene_tensors(train, GPU, np.arange(i * M_BATCH,
                                                   (i + 1) * M_BATCH))
               for i in range(len(train) // M_BATCH)]
    state = {"i": 0}

    def step():
        b = batches[state["i"] % len(batches)]
        state["i"] += 1
        loss = obj.loss(model, b)
        opt.step(list(torch.autograd.grad(loss, model.tree_params())))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(N_STEPS_TIMED):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / N_STEPS_TIMED
    try:
        dev_ms, launches = device_profile(step, N_STEPS_TIMED)
        share = (f"{dev_ms:.4f} ms of device time and {launches:g} CUDA "
                 f"launches a step, busy share {dev_ms / step_ms:.3f}")
    except Exception as exc:    # a measurement, not a check
        share = f"device time not measured ({type(exc).__name__}: {exc})"
    # the shipped matcher fine-tuned on the ring rig's scenes (the scan
    # path): the matcher phase 10 serves, which decodes persons there
    tuned = train_matcher(train, dev, rig_config, rig, topo, demo_cfg,
                          MatcherTrainConfig(epochs=M_TUNE_EPOCHS,
                                             eval_every=2,
                                             patience=M_TUNE_EPOCHS),
                          params=demo_tree, log=lambda s: None, device=GPU)
    print(f"  train_matcher, pan_irls_bf16's matcher fine-tuned on the card "
          f"({M_TUNE_EPOCHS} epochs, scan path, lr 1e-4): dev loss "
          f"{[round(h['val_loss'], 5) for h in tuned.history]}, "
          f"{tuned.history[-1]['elapsed_s']:.2f} s", flush=True)
    print(f"  train_matcher warm, {M_EPOCHS + 1} epochs: "
          f"{[round(x, 4) for x in epoch_s]} s a epoch (dev evaluation "
          f"included), {[round(len(train) / x, 1) for x in epoch_s]} train "
          f"scenes a second; {N_STEPS_TIMED} steps alone (batch {M_BATCH}, "
          f"union graph of {M_BATCH * topo.n_heads} heads and "
          f"{M_BATCH * topo.n_pairs} pairs): {step_ms:.3f} ms a step, "
          f"{1e3 * M_BATCH / step_ms:.1f} train scenes a second; {share} "
          f"({smi})", flush=True)
    return tuned.params, cfg, files, topo, dev, init


def synth_marginals(labels, weight, present):
    """(positive-label share of live pairs, share of duplicated pairs,
    populated slots a scene, live-scene share) of a set of scenes, the
    marginals of tests/test_torch_matcher_synth.py."""
    import numpy as np
    live = weight.sum(axis=1) > 0
    labels, weight, present = labels[live], weight[live], present[live]
    pos = labels.sum(axis=1) / np.maximum((weight > 0).sum(axis=1), 1)
    dup = (weight == 2.0).sum() / max((weight > 0).sum(), 1)
    return (float(pos.mean()), float(dup),
            float(present.sum(axis=(1, 2)).mean()), float(live.mean()))


def check_device_synth(rig_config, rig, files, topo, dev, cfg, init, smi):
    """Phase 10 (b): ``train_matcher(synth_bank=...)`` on the card, two
    epochs of ``N_M_TRAIN`` scenes synthesised on the device (the second
    warm), finite losses, and one batch's synthesis timed alone;
    ``N_SYNTH`` scenes synthesised on the card at S=6
    held to the host synthesiser's marginals in the CPU test's bands, and
    their null-scene share to the CPU synthesiser's."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.config import MatcherTrainConfig
    from mpe3d_tpu_torch.matching.features import build_topology
    from mpe3d_tpu_torch.train.matcher import train_matcher
    from mpe3d_tpu_torch.train.matcher_data import build_matcher_scenes
    from mpe3d_tpu_torch.train.matcher_synth import (build_scene_bank,
                                                     synth_scenes)

    bank = build_scene_bank(files, rig_config)
    res = train_matcher(None, dev, rig_config, rig, topo, cfg,
                        MatcherTrainConfig(epochs=2, batch_size=M_BATCH,
                                           eval_every=1, limit=N_M_TRAIN),
                        params=init, synth_bank=bank, log=lambda s: None,
                        device=GPU)
    losses = [(h["train_loss"], h["val_loss"]) for h in res.history]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"train_matcher(synth_bank): losses {losses}")
    ends = [h["elapsed_s"] for h in res.history]
    topo6 = build_topology(rig_config.n_matching_cameras, SYNTH_SLOTS)

    def synth(device):
        gen = torch.Generator(device=device).manual_seed(7)
        out = synth_scenes(bank.tensors(device, topo6), gen, N_SYNTH)
        return [t.cpu().numpy() for t in out]

    card, cpu = synth(GPU), synth("cpu")
    # one batch's synthesis alone, the bank resident (CUDA events)
    bank_t = bank.tensors(GPU, topo)
    gen_t = torch.Generator(device=GPU).manual_seed(11)
    synth_ms = median_ms(lambda: synth_scenes(bank_t, gen_t, M_BATCH))
    host = build_matcher_scenes(files, rig_config, topo6, limit=400, seed=3)
    got = synth_marginals(card[5], card[6], card[4])
    want = synth_marginals(host.labels, host.pair_weight, host.present)
    ref = synth_marginals(cpu[5], cpu[6], cpu[4])
    if not (abs(got[0] - want[0]) < 0.25 * want[0]
            and abs(got[1] - want[1]) < 0.15
            and abs(got[2] - want[2]) < 0.25 * want[2]
            and abs(got[3] - ref[3]) < 0.1
            and np.all((card[5] == 0) | (card[6] > 0))):
        raise AssertionError(f"device synthesis marginals {got}, host "
                             f"{want}, CPU synthesis {ref}")
    print(f"  train_matcher --device-synth: {bank.kp.shape[0]} bank frames, "
          f"{bank.aug_frame.shape[0]} augmented entries, {N_M_TRAIN} scenes "
          f"an epoch synthesised on the card: losses {losses}, epoch seconds "
          f"{[round(ends[0], 4), round(ends[1] - ends[0], 4)]} (the second "
          f"warm), synthesis of a batch of {M_BATCH} scenes "
          f"{synth_ms:.4f} ms (median of {N_TIMED}); {N_SYNTH} card scenes "
          f"at S={SYNTH_SLOTS}: (positive share, duplicated share, slots a "
          f"scene, live share) "
          f"{tuple(round(v, 4) for v in got)}, host synthesiser "
          f"{tuple(round(v, 4) for v in want)}, CPU synthesiser "
          f"{tuple(round(v, 4) for v in ref)} ({smi})", flush=True)


def serve_trained_matcher(rig_config, rig, mtree, mcfg, lifters, frames,
                          frames10):
    """Phase 10 (c): the card-tuned matcher served by ``infer_fused`` at
    S=4 (stack form) and at the default buckets on the S=10 frames (tiled
    form, "mean" prior) with each lifter, against the CPU.  Returns the
    launches of all runs."""
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    total = dict.fromkeys(launch_counters(), 0)
    for lname, (lt, lc, prior) in lifters.items():
        for blabel, slots, persons, fr, pr in (
                ("S=4", (4,), (8,), frames, prior),
                ("S=10 buckets (2, 4, 10)/(4, 8, 16)", (2, 4, 10),
                 (4, 8, 16), frames10, CROWDED_PRIOR)):
            def mk(device, fk):
                return PoseEstimationPipeline(
                    rig_config, rig,
                    weights.matcher_from_tree(mtree, mcfg, device),
                    weights.lifter_from_tree(lt, lc, device),
                    slot_buckets=slots, person_buckets=persons,
                    lifter_prior=pr, use_frame_kernel=fk, device=device)
            launches, _, _, _ = run_main_path(
                mk(GPU, None), mk("cpu", True), fr,
                f"card-tuned matcher, {lname} lifter, {blabel}")
            for k, v in launches.items():
                total[k] += v
    if not (total["gat_stack"] and total["gat_k1"] and total["gat_k2"]
            and total["frame_decode_pack"] and total["mlp_run"]):
        raise AssertionError(f"the trained matcher's runs: launches {total}")
    return total


def check_conversions(rig_config, rig, frames, rtree, ltree9, lcfg9, d):
    """Phase 10 (d): ``export-torch`` and ``convert-torch`` in this process
    of the pair of ``pan_irls_bf16``'s matcher and the phase 9 lifter (the
    shipped lifter predicts a correction to its prior, which the reference
    format cannot hold: ``export-torch`` of ``pan_irls_bf16`` itself writes
    the matcher and refuses the lifter); the reference-format directory
    (served as it is, ``cli.load_models``) and the converted npz each
    served on the card against the CPU, trained and random matcher, persons
    and poses equal to the npz pair's on the card; a residual matcher
    written as a ``.tch`` by the port's exporter served through the layer
    form."""
    import shutil

    import numpy as np
    from mpe3d_tpu_torch import cli, weights
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.config import MatcherConfig
    from mpe3d_tpu_torch.convert.torch_export import export_reference_matcher
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    pair = os.path.join(d, "pair")
    os.makedirs(pair)
    shutil.copy(os.path.join(DEMO, "skeleton_matching.npz"), pair)
    save_checkpoint(os.path.join(pair, "pose_estimator"), ltree9,
                    meta={"lifter_config": lcfg9, "prior": "mean"})
    t = time.perf_counter()
    demo_out = os.path.join(d, "demo_torch")
    cli.main(["export-torch", "--modelsdir", DEMO, "--out", demo_out])
    if sorted(os.listdir(demo_out)) != ["skeleton_matching.prms",
                                        "skeleton_matching.tch"]:
        raise AssertionError(f"export-torch of pan_irls_bf16 wrote "
                             f"{os.listdir(demo_out)}")
    tdir, cdir = os.path.join(d, "torch"), os.path.join(d, "converted")
    cli.main(["export-torch", "--modelsdir", pair, "--out", tdir])
    cli.main(["convert-torch", "--lifter",
              os.path.join(tdir, "pose_estimator.pytorch"), "--matcher",
              os.path.join(tdir, "skeleton_matching.tch"), "--prms",
              os.path.join(tdir, "skeleton_matching.prms"),
              "--modelsdir", cdir])
    t_files = time.perf_counter() - t
    base = cli.load_models(pair, rig_config)

    def pipe(trees, mtree, device, fk):
        _, mc, lt, lc = trees[:4]
        return PoseEstimationPipeline(
            rig_config, rig, weights.matcher_from_tree(mtree, mc, device),
            weights.lifter_from_tree(lt, lc, device), slot_buckets=(4,),
            person_buckets=(8,), lifter_prior="mean", use_frame_kernel=fk,
            device=device)

    lines = []
    for source in (tdir, cdir):
        trees = cli.load_models(source, rig_config)
        for mlabel, mtree in (("trained", trees[0]), ("random", rtree)):
            label = (f"{'reference files' if source == tdir else 'converted'}"
                     f" (pan_irls_bf16's matcher, phase 9 lifter), {mlabel} "
                     f"matcher")
            _, _, _, outs = run_main_path(
                pipe(trees, mtree, GPU, None),
                pipe(trees, mtree, "cpu", True), frames[:N_SHORT], label)
            npz = pipe(base, base[0] if mlabel == "trained" else rtree, GPU,
                       None)
            d_pose = 0.0
            for f, o in zip(frames[:N_SHORT], outs):
                r = npz.infer_fused(f)
                if not np.array_equal(o.persons, r.persons):
                    raise AssertionError(f"{label}: persons differ from the "
                                         f"npz pair's")
                if len(o.poses):
                    d_pose = max(d_pose, float(np.abs(o.poses
                                                      - r.poses).max()))
            if d_pose > POSE_TOL_M:
                raise AssertionError(f"{label}: poses {d_pose} m from the "
                                     f"npz pair's")
            lines.append(f"{label}: persons equal to the npz pair's on the "
                         f"card, max |d pose| {d_pose:.3g} m")
    # a residual matcher through the port's exporter, served from its .tch
    rdir = os.path.join(d, "residual")
    os.makedirs(rdir)
    rcfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim,
                         residual=True)
    export_reference_matcher(weights.random_matcher_tree(rcfg,
                                                         RESIDUAL_SEED),
                             rcfg, os.path.join(rdir, "skeleton_matching.tch"),
                             os.path.join(rdir, "skeleton_matching.prms"))
    shutil.copy(os.path.join(tdir, "pose_estimator.pytorch"), rdir)
    trees = cli.load_models(rdir, rig_config)
    if not trees[1].residual:
        raise AssertionError("the residual .tch read as a plain matcher")
    launches, _, paths, _ = run_main_path(
        pipe(trees, trees[0], GPU, None), pipe(trees, trees[0], "cpu", None),
        frames[:N_SHORT], "residual matcher from a port-written .tch")
    if (any(form != "layer" for form, _ in paths.values())
            or launches["gat_fused_proj"] != 5 * N_SHORT):
        raise AssertionError(f"residual .tch: paths {paths}, launches "
                             f"{launches}")
    for ln in lines:
        print(f"  {ln}")
    print(f"  export-torch (pan_irls_bf16: the matcher, its residual-prior "
          f"lifter refused; the pair) and convert-torch, in this process: "
          f"{t_files:.1f} s", flush=True)
    return launches


def check_servable(rig_config, rig, frames, rtree, mcfg, ltree, lcfg, d):
    """Phase 10 (e): ``export-servable --dtype int8`` and ``--dtype bf16``
    of the phase 9 lifter (random matcher beside it), each served by
    ``from_checkpoint`` on the card against the CPU: the lifter in its
    stored kind, one ``mlp_run`` launch a frame, persons equal and poses
    within ``POSE_TOL_M``."""
    from mpe3d_tpu_torch import cli
    from mpe3d_tpu_torch.checkpoint import save_checkpoint
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    models = os.path.join(d, "phase9")
    save_checkpoint(os.path.join(models, "pose_estimator"), ltree,
                    meta={"lifter_config": lcfg, "prior": "mean"})
    write_matcher_npz(os.path.join(models, "skeleton_matching"), rtree,
                      mcfg)
    total = dict.fromkeys(launch_counters(), 0)
    for dtype in ("int8", "bf16"):
        out = os.path.join(d, f"servable_{dtype}")
        cli.main(["export-servable", "--modelsdir", models, "--dtype", dtype,
                  "--out", out])

        def mk(device, fk):
            return PoseEstimationPipeline.from_checkpoint(
                out, rig, rig_config, device=device, slot_buckets=(4,),
                person_buckets=(8,), use_frame_kernel=fk)
        gpu = mk(GPU, None)
        if gpu.serve_dtype != dtype:
            raise AssertionError(f"the {dtype} export serves "
                                 f"{gpu.serve_dtype}")
        launches, _, _, _ = run_main_path(gpu, mk("cpu", True),
                                          frames[:N_SHORT],
                                          f"export-servable --dtype {dtype}")
        if launches["mlp_run"] != N_SHORT:
            raise AssertionError(f"{dtype} export: launches {launches}")
        for k, v in launches.items():
            total[k] += v
    return models, total


def check_profile_trace(models, wire4, d, smi):
    """Phase 10 (f): ``infer --profile-trace`` on the card in this process:
    the trace names the CUDA kernels the frames launched (the stack GAT's
    ``f64_gemm_kernel`` and ``stack_out``, ``frame_decode_pack_kernel``,
    ``mlp_run_kernel``), and the records equal those without the trace."""
    import contextlib
    import io

    from mpe3d_tpu_torch import cli
    from mpe3d_tpu_torch.data.synthetic import write_frames

    path = os.path.join(d, "frames.json")
    write_frames(wire4, path)
    tdir = os.path.join(d, "trace")
    recs = {}
    for name, extra in (("plain", []), ("traced", ["--profile-trace",
                                                    tdir])):
        out = os.path.join(d, f"{name}.json")
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["infer", "--modelsdir", models, "--testfiles", path,
                      "--out", out, *extra])
        with open(out) as f:
            recs[name] = json.load(f)
    compare_records(recs["traced"], recs["plain"], "infer --profile-trace")
    (trace,) = os.listdir(tdir)
    with open(os.path.join(tdir, trace)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    want = ("f64_gemm_kernel", "stack_out", "frame_decode_pack_kernel",
            "mlp_run_kernel")
    missing = [k for k in want if not any(k in n for n in kernels)]
    if missing:
        raise AssertionError(f"infer --profile-trace: no {missing} among the "
                             f"traced kernels {sorted(kernels)[:20]}")
    print(f"  infer --profile-trace on the card: {trace} "
          f"({os.path.getsize(os.path.join(tdir, trace))} bytes, "
          f"{len(events)} events, {len(kernels)} kernel names) names "
          f"{', '.join(want)}; {len(recs['plain'])} records equal to the "
          f"run without the trace ({smi})", flush=True)


def run_matcher_training_and_files(rig_config, rig, matchers, mcfg, lifters,
                                   frames, frames10, wire4, ltree9, lcfg9,
                                   prior, smi):
    """Phase 10: (a)-(f) above in a temporary directory.  Returns the
    launches of the card-trained matcher's runs."""
    import tempfile
    tuned, cfg, files, topo, dev, init = train_matcher_full_width(
        rig_config, rig, matchers["trained"], mcfg, smi)
    check_device_synth(rig_config, rig, files, topo, dev, cfg, init, smi)
    launches = serve_trained_matcher(rig_config, rig, tuned, mcfg,
                                     lifters, frames, frames10)
    with tempfile.TemporaryDirectory() as d:
        check_conversions(rig_config, rig, frames, matchers["random"],
                          ltree9, lcfg9, d)
        models, _ = check_servable(rig_config, rig, frames,
                                   matchers["random"], mcfg, ltree9, lcfg9,
                                   d)
        check_profile_trace(models, wire4, d, smi)
    return launches


# ---------------------------------------------------------------------------
# phase 11: the Panoptic conversor and the viewers
# ---------------------------------------------------------------------------

N_RESIZE_IMAGES = 3        # seeded HD images through the card's resize
DETECT_SEED = 0            # the He-normal backbone (he_normal_state)
DETECT_HOT = 40            # heatmap cells a channel above the threshold
N_DETECT_TIMED = 20        # detector calls a timing
N_SEQ_FRAMES = 2           # frames of the synthetic 5-camera sequence
N_SHOW_FRAMES = 8          # frames of show-results
# heatmaps, card (cuDNN, fp32 without TF32) against the CPU's plain run on
# the same image: fp32 sums in other orders through 53 convolutions, about
# 1e-6 of the heatmaps' scale (the CPU tests see 1.7e-6 against JAX);
# bounded at 1e-4 x (1 + max |heatmap|).  A peak may differ only where its
# cell lies within that of the threshold or of its window's maximum, and
# the refined coordinates of equal peaks within 1e-4 (normalised).  On the
# same heatmaps the card's peaks equal the CPU's and the refined
# coordinates, weighted sums of 25 fp32 terms in another order, lie within
# 1e-6 (normalised, a few ulps of 1).
HEAT_RTOL = 1e-4
PEAK_XY_TOL = 1e-4
REFINE_TOL = 1e-6


def hot_head(state, cmap, hot=DETECT_HOT):
    """``state`` with its head scaled per channel so that the ``hot``
    largest cells of ``cmap`` (its heatmaps [J, h, w] on some image) pass
    0.15: the midpoint between a channel's hot-th and next value maps to
    0.15, its least value to 0.  Returns (state, per-channel scale)."""
    import numpy as np
    top = -np.sort(-cmap.reshape(len(cmap), -1), axis=1)
    cut = (top[:, hot - 1].astype(np.float64) + top[:, hot]) / 2
    low = top[:, -1].astype(np.float64)
    s = 0.15 / (cut - low)
    out = dict(state)
    w = np.asarray(state["final_layer.weight"])
    out["final_layer.weight"] = (w * s[:, None, None, None]).astype(
        np.float32)
    out["final_layer.bias"] = ((np.asarray(state["final_layer.bias"]) - low)
                               * s).astype(np.float32)
    return out, s


def compare_peaks(det, got, ref, tol):
    """Peaks of the card's heatmaps ``got`` (on the card) against the
    CPU's of its heatmaps ``ref``: counts and (row, col) equal but where a
    cell lies within ``tol`` of the threshold or of its window's maximum
    (counted), refined coordinates of equal channels within PEAK_XY_TOL.
    Returns (differing peaks, max |d xy|)."""
    import torch
    import torch.nn.functional as F
    from mpe3d_tpu_torch.convert.peaks import find_peaks, refine_peaks
    cg, pg = det.peaks(got)[0].cpu(), find_peaks(
        got, det.threshold, det.window, det.max_peaks)[1]
    ng = refine_peaks(pg, got, det.window).cpu()
    pg = pg.cpu()
    cr, pr = find_peaks(ref, det.threshold, det.window, det.max_peaks)
    nr = refine_peaks(pr, ref, det.window)
    pooled = F.max_pool2d(ref[None], det.window, 1, det.window // 2)[0]
    n_diff, d_xy = 0, 0.0
    for j in range(ref.shape[0]):
        a = {tuple(p) for p in pg[j, :int(cg[j])].tolist()}
        b = {tuple(p) for p in pr[j, :int(cr[j])].tolist()}
        for r, c in a ^ b:
            v = float(ref[j, r, c])
            if not (abs(v - det.threshold) <= tol
                    or float(pooled[j, r, c]) - v <= tol):
                raise AssertionError(f"detector peaks, channel {j}: ({r}, "
                                     f"{c}) at {v:.6g} differs from the "
                                     f"CPU's, away from the threshold and "
                                     f"its window's maximum")
            n_diff += 1
        if torch.equal(pg[j], pr[j]):
            d_xy = max(d_xy, float((ng[j] - nr[j]).abs().max()))
    if not d_xy <= PEAK_XY_TOL:
        raise AssertionError(f"detector refined peaks: {d_xy:.3g} from the "
                             f"CPU's (tol {PEAK_XY_TOL})")
    return n_diff, d_xy


def check_resize_and_peaks(smi):
    """Phase 11 (a), (c): seeded HD uint8 images (1920x1080, and 3840x2160
    and 1280x720) through the card's ``resize_linear`` bit-equal to the
    CPU's; Gaussian-blob heatmaps [18, 128, 240] through ``find_peaks`` /
    ``refine_peaks`` on the card: counts and peaks equal to the CPU's,
    coordinates within ``REFINE_TOL``."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.config import DETECTOR_INPUT
    from mpe3d_tpu_torch.convert.panoptic import resize_linear
    from mpe3d_tpu_torch.convert.peaks import find_peaks, refine_peaks
    rng = np.random.default_rng(11)
    shapes = [(1080, 1920)] * N_RESIZE_IMAGES + [(2160, 3840), (720, 1280)]
    for h, w in shapes:
        img = torch.from_numpy(rng.integers(0, 256, (h, w, 3),
                                            dtype=np.uint8))
        got = resize_linear(img.to(GPU), DETECTOR_INPUT).cpu()
        if not torch.equal(got, resize_linear(img, DETECTOR_INPUT)):
            raise AssertionError(f"resize_linear {w}x{h}: the card's "
                                 f"differs from the CPU's")
    hd = torch.from_numpy(rng.integers(0, 256, (1080, 1920, 3),
                                       dtype=np.uint8)).to(GPU)
    resize_ms = median_ms(lambda: resize_linear(hd, DETECTOR_INPUT))
    yy, xx = np.mgrid[0:128, 0:240].astype(np.float32)
    cm = np.zeros((18, 128, 240), np.float32)
    for j in range(18):
        for _ in range(int(rng.integers(2, 9))):
            r, c = rng.uniform(0, 128), rng.uniform(0, 240)
            s = rng.uniform(1.0, 3.0)
            cm[j] = np.maximum(cm[j], rng.uniform(0.1, 1.0) * np.exp(
                -((yy - r) ** 2 + (xx - c) ** 2) / (2 * s * s)))
    cm = torch.from_numpy(cm)
    outs = []
    for dev in (GPU, "cpu"):
        c, p = find_peaks(cm.to(dev))
        outs.append((c.cpu(), p.cpu(), refine_peaks(p, cm.to(dev)).cpu()))
    (cg, pg, ng), (cr, pr, nr) = outs
    d_xy = float((ng - nr).abs().max())
    if not (torch.equal(cg, cr) and torch.equal(pg, pr)
            and d_xy <= REFINE_TOL):
        raise AssertionError(f"peaks of the Gaussian heatmaps: the card's "
                             f"differ from the CPU's (max |d xy| "
                             f"{d_xy:.3g}, tol {REFINE_TOL:g})")
    cmg = cm.to(GPU)
    peaks_ms = median_ms(lambda: refine_peaks(find_peaks(cmg)[1], cmg))
    print(f"  resize_linear (cv2's INTER_LINEAR in integers): "
          f"{len(shapes)} seeded images (1920x1080 x {N_RESIZE_IMAGES}, "
          f"3840x2160, 1280x720) -> 960x512 on the card bit-equal to the "
          f"CPU's; 1920x1080 {resize_ms:.4f} ms.  find_peaks + refine_peaks "
          f"on Gaussian-blob heatmaps [18, 128, 240] ({int(cr.sum())} peaks):"
          f" counts and peaks equal to the CPU's, coordinates within "
          f"{d_xy:.3g} (tol {REFINE_TOL:g}); {peaks_ms:.4f} ms ({smi})",
          flush=True)


def check_detector(smi):
    """Phase 11 (b): ``Detector2D`` at full width (PoseResNet-50, 960x512,
    numpy-seeded He weights, the head scaled by ``hot_head`` on this
    image) on the card against its plain run on the CPU, timed."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch.convert.panoptic import Detector2D
    from mpe3d_tpu_torch.convert.pose_resnet import (he_normal_state,
                                                     pose_resnet_flops)
    rng = np.random.default_rng(12)
    image = rng.integers(0, 256, (512, 960, 3), dtype=np.uint8)
    state = he_normal_state(DETECT_SEED)
    raw = Detector2D(state, device=GPU).heatmaps(image).cpu().numpy()
    state, scale = hot_head(state, raw)
    cpu, gpu = Detector2D(state, device="cpu"), Detector2D(state, device=GPU)
    t = time.perf_counter()
    ref = cpu.heatmaps(image)
    t_cpu = time.perf_counter() - t
    got = gpu.heatmaps(image)
    err = float((got.cpu() - ref).abs().max())
    tol = HEAT_RTOL * (1.0 + float(ref.abs().max()))
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"detector heatmaps on the card: max |d| "
                             f"{err:.3g} from the CPU's (tol {tol:.3g})")
    n_diff, d_xy = compare_peaks(gpu, got, ref, tol)
    want, have = cpu(image, (1920, 1080)), gpu(image, (1920, 1080))
    counts = [len(have.get(j, [])) for j in sorted(want)]
    if sorted(have) != sorted(want) or not all(counts):
        raise AssertionError(f"detector joints on the card {sorted(have)}, "
                             f"the CPU's {sorted(want)}")
    call = lambda: gpu(image, (1920, 1080))  # noqa: E731
    ms = median_ms(call, N_DETECT_TIMED)
    dev, n_k = device_profile(call, 10)
    net_dev, _ = device_profile(lambda: gpu.heatmaps(image), 10)
    flops = pose_resnet_flops(gpu.net, (512, 960))
    n_w = sum(t.numel() for t in gpu.net.state_dict().values()
              if t.is_floating_point())
    bytes_ = 4 * n_w + image.size + 4 * 18 * (1 + 2 * gpu.max_peaks)
    b_ms, b_by = bound(bytes_, flops)
    print(f"  Detector2D, PoseResNet-50 at 960x512 (seed {DETECT_SEED} "
          f"He-normal, {n_w / 1e6:.2f} M weights, head scaled by "
          f"{float(scale.min()):.3g}-{float(scale.max()):.3g} so that "
          f"{DETECT_HOT} cells a channel pass 0.15): heatmaps max |d| "
          f"{err:.3g} from the CPU's plain run (tol {tol:.3g}); peaks "
          f"{sum(counts)} in {len(counts)} joints, {n_diff} differ (within "
          f"the tolerance of the threshold or of a window's maximum), "
          f"refined max |d xy| {d_xy:.3g}; the CPU's call {t_cpu:.2f} s",
          flush=True)
    print(f"  Detector2D call (upload, resize, net, peaks, one download): "
          f"{ms:.4f} ms; device {dev:.4f} ms ({n_k:g} CUDA launches a "
          f"call), the net alone {net_dev:.4f} ms device; bound {b_ms:.4f} "
          f"ms ({b_by}: {flops / 1e9:.2f} GFLOP at {FP32_FLOPS / 1e12:g} "
          f"TFLOP/s fp32, {bytes_ / 1e6:.1f} MB) ({smi})", flush=True)


def synthetic_sequence(d, rng):
    """A CMU Panoptic sequence directory: five HD cameras (panel 0, the
    conversor's nodes) on a 3 m ring facing its centre, ``N_SEQ_FRAMES``
    frames of three people (COCO-19 joints, cm), an empty image file a
    camera and frame.  Returns (sequence dir, image path -> 1080x1920x3
    uint8, projected GT joints in all): a grey of ImageNet's mean (the net's zero input) with seeded
    noise and a white disc at each projected GT joint, so that a random
    backbone's heatmaps have their extremes near the joints."""
    import numpy as np
    from mpe3d_tpu_torch.config import PANOPTIC_HD_NODES
    from mpe3d_tpu_torch.convert.panoptic import (load_calibration,
                                                  project_gt_people)
    seq = os.path.join(d, "171204_pose_synth")
    os.makedirs(os.path.join(seq, "hdPose3d_stage1_coco19"))
    cams = []
    for i, node in enumerate(PANOPTIC_HD_NODES):
        yaw = 2 * np.pi * i / len(PANOPTIC_HD_NODES)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = -R @ np.array([300.0 * s, -20.0, -300.0 * c])
        cams.append({"panel": 0, "node": node, "name": f"00_{node:02d}",
                     "resolution": [1920, 1080],
                     "K": [[1400.0, 0.0, 960.0], [0.0, 1400.0, 540.0],
                           [0.0, 0.0, 1.0]],
                     "R": R.tolist(), "t": [[float(v)] for v in t],
                     "distCoef": [-0.2, 0.05, 1e-4, -1e-4, 0.0]})
        os.makedirs(os.path.join(seq, "hdImgs", f"00_{node:02d}"))
    with open(os.path.join(seq, "calibration_171204_pose_synth.json"),
              "w") as f:
        json.dump({"cameras": cams}, f)
    calib = load_calibration(seq)
    yy, xx = np.mgrid[0:1080, 0:1920]
    images, n_projected = {}, 0
    for k in range(N_SEQ_FRAMES):
        fid = f"{100 + k:08d}"
        bodies = []
        for pid in range(3):
            off = rng.uniform(-60, 60, 3) * (1, 0, 1)
            joints = []
            for _ in range(19):
                joints += [*(rng.uniform((-25, -90, -25), (25, 30, 25))
                             + off).tolist(), 1.0]
            bodies.append({"id": pid, "joints19": joints})
        with open(os.path.join(seq, "hdPose3d_stage1_coco19",
                               f"body3DScene_{fid}.json"), "w") as f:
            json.dump({"bodies": bodies}, f)
        for node in PANOPTIC_HD_NODES:
            path = os.path.join(seq, "hdImgs", f"00_{node:02d}",
                                f"00_{node:02d}_{fid}.jpg")
            open(path, "wb").close()
            img = (np.array([124, 116, 104]) + rng.integers(
                -3, 4, (1080, 1920, 3))).astype(np.uint8)
            projected, _ = project_gt_people(bodies, calib[(0, node)])
            for joint in (v for kps in projected.values()
                          for v in kps.values()):
                n_projected += 1
                x, y = joint[1], joint[2]
                ys = slice(max(0, int(y) - 8), int(y) + 9)
                xs = slice(max(0, int(x) - 8), int(x) + 9)
                disc = (xx[ys, xs] - x) ** 2 + (yy[ys, xs] - y) ** 2 <= 49
                img[ys, xs][disc] = 255
            images[path] = img
    return seq, images, n_projected


def check_conversion(d, smi):
    """Phase 11 (d): ``convert_sequence`` on a synthetic 5-camera HD
    sequence with a card detector (the phase's backbone, its head scaled by
    ``hot_head`` on the sequence's first image), the module's image reader
    replaced by the seeded arrays; the first frame against the CPU's plain
    run, the output parsed as wire frames; a frame's five cameras
    timed."""
    import importlib.util
    import numpy as np
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.convert import panoptic
    from mpe3d_tpu_torch.convert.pose_resnet import he_normal_state
    from mpe3d_tpu_torch.data.frames import parse_frame, parse_frame_gt
    from mpe3d_tpu_torch.geometry.calib_io import load_transform_manager
    seq, images, n_projected = synthetic_sequence(d,
                                                  np.random.default_rng(13))
    state = he_normal_state(DETECT_SEED)
    first = images[min(images)]
    state, _ = hot_head(state, panoptic.Detector2D(state, device=GPU)
                        .heatmaps(first).cpu().numpy())
    det = panoptic.Detector2D(state, device=GPU)
    reader = panoptic.read_image_rgb
    panoptic.read_image_rgb = images.__getitem__
    try:
        t = time.perf_counter()
        path = panoptic.convert_sequence(seq, det, out_dir=d)
        t_seq = time.perf_counter() - t
        cdir = os.path.join(d, "cpu")
        os.makedirs(cdir)
        ref_path = panoptic.convert_sequence(
            seq, panoptic.Detector2D(state, device="cpu"), out_dir=cdir,
            max_frames=1)
        frame_imgs = [images[p] for p in sorted(images)
                      if p.endswith("_00000100.jpg")]
        frame_ms = []
        for _ in range(5):
            t = time.perf_counter()
            for img in frame_imgs:
                det(img, (1920, 1080))
            frame_ms.append(1e3 * (time.perf_counter() - t))
    finally:
        panoptic.read_image_rgb = reader
    with open(path) as f:
        frames = json.load(f)
    with open(ref_path) as f:
        ref = json.load(f)

    def masked(frame):
        return {cam: [e[0], *e[2:]] for cam, e in frame.items()}

    names = {f"tracker{c}" for c in "abcde"}
    if len(frames) != N_SEQ_FRAMES or any(set(f) != names for f in frames):
        raise AssertionError(f"convert_sequence: {len(frames)} frames, "
                             f"cameras {[sorted(f) for f in frames]}")
    d_px = 0.0
    got0, ref0 = masked(frames[0]), masked(ref[0])
    for cam in sorted(ref0):
        g, r = got0[cam], ref0[cam]
        gp, rp = json.loads(g[0]), json.loads(r[0])
        if g[1:] != r[1:] or [sorted(p) for p in gp] != [sorted(p)
                                                         for p in rp]:
            raise AssertionError(f"convert_sequence {cam}: the card's "
                                 f"people or GT differ from the CPU's")
        for pg, pr in zip(gp, rp):
            for j in pg:
                d_px = max(d_px, float(np.abs(np.subtract(pg[j][1:3],
                                                          pr[j][1:3])).max()))
    if not d_px <= PEAK_XY_TOL * 1920:
        raise AssertionError(f"convert_sequence: detections {d_px:.3g} px "
                             f"from the CPU's")
    n_joints = sum(len(p) for f in frames for e in f.values()
                   for p in json.loads(e[0]))
    if not n_joints:
        raise AssertionError("convert_sequence: no detection was associated "
                             "with a projected GT joint")
    fas = [parse_frame(f, PANOPTIC) for f in frames]
    gts = [parse_frame_gt(f, PANOPTIC) for f in frames]
    T = load_transform_manager(os.path.join(
        d, "tm_171204_pose_synth.pickle")).get_transform("root", "trackerc")
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("cv2", "matplotlib", "tensorstore")}
    print(f"  convert_sequence: 5 HD cameras x {N_SEQ_FRAMES} frames of 3 "
          f"people (installed: {present}; the module's read_image_rgb "
          f"replaced by seeded 1080x1920 arrays, a white disc at each GT "
          f"joint) in {t_seq:.2f} s; {n_joints} of {n_projected} projected "
          f"GT joints associated with a detection within 25 px; the first "
          f"frame equal "
          f"to the CPU's plain run (people and GT; detections within "
          f"{d_px:.3g} px); parsed as wire frames "
          f"({sum(int(fa.present.sum()) for fa in fas)} skeletons, GT in "
          f"{sum(g is not None for g in gts)} frames); the tm_ pickle read "
          f"back (trackerc t {np.round(T[:3, 3], 3).tolist()} m)",
          flush=True)
    print(f"  a frame's 5 HD cameras through Detector2D on the card: median "
          f"{statistics.median(frame_ms):.3f} ms ({smi})", flush=True)


def html_payload(path):
    import re
    with open(path) as f:
        text = f.read()
    return json.loads(re.search(r"const D=(\{.*?\});\n", text,
                                re.S).group(1))


def read_sse(url, n, timeout=60.0):
    """The data of the first ``n`` SSE events of ``url`` + "events"."""
    import urllib.request
    out = []
    with urllib.request.urlopen(url + "events", timeout=timeout) as r:
        while len(out) < n:
            line = r.readline()
            if not line:
                raise AssertionError(f"{url}events closed after "
                                     f"{len(out)} events")
            if line.startswith(b"data: "):
                out.append(json.loads(line[6:]))
    return out


def check_show_results(rtree, mcfg, rig_config, rig, d, smi):
    """Phase 11 (e), (f): ``show-results --out .html`` on the card (the
    staged ``pipe(frame)``: the stack GAT and lifter run kernels) against
    ``--cpu``, then ``--live 0`` as a subprocess on the card
    (``infer_fused``), its SSE events read over HTTP against the CPU's
    ``infer_fused`` and tracker, closed by SIGINT."""
    import queue
    import re
    import signal
    import threading
    import numpy as np
    from mpe3d_tpu_torch import cli
    from mpe3d_tpu_torch.data.frames import load_eval_frames
    from mpe3d_tpu_torch.data.synthetic import generate_frames, write_frames
    from mpe3d_tpu_torch.serve import gate_and_track
    from mpe3d_tpu_torch.viz.viewer import remap_axes
    models = os.path.join(d, "models")
    os.makedirs(models)
    for name in ("pose_estimator.npz", "pose_estimator.json"):
        if os.path.exists(os.path.join(DEMO, name)):
            os.symlink(os.path.join(DEMO, name), os.path.join(models, name))
    write_matcher_npz(os.path.join(models, "skeleton_matching"), rtree, mcfg)
    test = os.path.join(d, "show.json")
    write_frames(generate_frames(rig_config, rig, N_SHOW_FRAMES,
                                 n_people=(2, 3), seed=21), test)
    argv = ["show-results", "--modelsdir", models, "--testfiles", test,
            "--showgt", "--show-quality", "--track"]
    cpu_html = os.path.join(d, "cpu.html")
    cli.main([*argv, "--cpu", "--out", cpu_html])
    times = []
    for k in range(2):
        reset_launches()
        t = time.perf_counter()
        cli.main([*argv, "--out", os.path.join(d, f"card{k}.html")])
        times.append(time.perf_counter() - t)
        launches = read_launches()
    got, ref = html_payload(os.path.join(d, "card1.html")), \
        html_payload(cpu_html)
    n_p, dp = 0, 0.0
    for i, (g, r) in enumerate(zip(got["frames"], ref["frames"])):
        if len(g["p"]) != len(r["p"]) or g.get("id") != r.get("id") \
                or g.get("g") != r.get("g"):
            raise AssertionError(f"show-results frame {i}: the card's "
                                 f"persons, ids or GT differ from --cpu's")
        if r["p"]:
            n_p += len(r["p"])
            dp = max(dp, float(np.abs(np.subtract(g["p"], r["p"])).max()))
    if len(got["frames"]) != N_SHOW_FRAMES or not n_p or dp > POSE_TOL_M \
            or not (launches["gat_stack"] and launches["mlp_run"]):
        raise AssertionError(f"show-results: {len(got['frames'])} frames, "
                             f"{n_p} poses, max |d pose| {dp:.3g} m, "
                             f"launches {launches}")
    print(f"  show-results --out .html on the card (random matcher, "
          f"pan_irls_bf16's lifter, --showgt --show-quality --track): "
          f"{N_SHOW_FRAMES} frames, {n_p} poses, persons, ids and GT equal "
          f"to --cpu's, max |d pose| {dp:.3g} m (display axes); launches "
          f"{launches}; the command {times[0]:.2f} s, then {times[1]:.2f} s "
          f"({N_SHOW_FRAMES / times[1]:.1f} frames a second with the "
          f"pipeline's build and the file's write) ({smi})", flush=True)

    # the live stream's reference: the CPU's infer_fused and tracker
    args = cli.make_parser().parse_args([*argv, "--cpu"])
    _, _, cpu = cli.build_pipeline(args, args.backend)
    tracker = cli._make_tracker(args)
    fused = []
    for fa in load_eval_frames([test], rig_config)[0]:
        out = cpu.infer_fused(fa)
        p, _, _, ids, _ = gate_and_track(out.poses, out.quality,
                                         tracker=tracker)
        fused.append((remap_axes(p, rig_config) if len(p) else p, ids))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpe3d_tpu_torch", *argv, "--live", "0",
         "--live-fps", "50"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln)
                                              for ln in proc.stderr],
                              daemon=True)
    reader.start()
    try:
        t = time.perf_counter()
        url = None
        while url is None:
            m = re.search(r"live viewer at (http://\S+/)",
                          lines.get(timeout=SERVE_TIMEOUT_S))
            url = m and m.group(1)
        events = read_sse(url, N_SHOW_FRAMES)
        t_live = time.perf_counter() - t
        dl = 0.0
        for i, (e, (p, ids)) in enumerate(zip(events, fused)):
            if len(e["p"]) != len(p) or e.get("id", []) != ids.tolist():
                raise AssertionError(f"show-results --live event {i}: "
                                     f"{len(e['p'])} poses, ids "
                                     f"{e.get('id')}; the CPU's "
                                     f"{len(p)}, {ids.tolist()}")
            if len(p):
                dl = max(dl, float(np.abs(np.subtract(e["p"], p)).max()))
        if dl > POSE_TOL_M:
            raise AssertionError(f"show-results --live: max |d pose| "
                                 f"{dl:.3g} m from the CPU's")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"show-results --live exited {rc} after "
                                 f"SIGINT")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    print(f"  show-results --live 0 (subprocess on the card, infer_fused): "
          f"{N_SHOW_FRAMES} SSE events over HTTP from {url} in {t_live:.2f} "
          f"s of the process's life, persons and track ids equal to the "
          f"CPU's infer_fused, max |d pose| {dl:.3g} m; SIGINT, exit code 0 "
          f"({smi})", flush=True)


def run_conversion_and_viewers(rtree, mcfg, rig_config, rig, smi):
    """Phase 11: (a)-(f) in a temporary directory."""
    import tempfile
    check_resize_and_peaks(smi)
    check_detector(smi)
    with tempfile.TemporaryDirectory() as d:
        check_conversion(d, smi)
        check_show_results(rtree, mcfg, rig_config, rig, d, smi)


# ---------------------------------------------------------------------------
# phase 12: checkpoints, parallel training and multi-device serving
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_lifter")
PAR_EPOCHS = 4             # epochs of each parallel run (the first warms)
PAR_M_BATCH = 14           # the matcher's global batch: even, so 2 ranks
# split it as one process takes it
# (loss, parameter) limits of a world against the one-process card run at
# the same global batch, a task each: the max relative per-epoch loss
# difference and the max |d param| after PAR_EPOCHS epochs.  A sound world
# takes the same steps with the gradient summed in another order (two
# half-batch sums, then their sum), which Adam's normalised steps turn into
# lr-sized moves where a gradient is near 0: on an H100 at 700 W the lifter
# read 2.44e-5 / 9.82e-5 (8 steps), the matcher 2.67e-4 / 6.89e-4 (44
# steps).  The limits are 3-4x those, well under the 2 x lr x steps
# (1.6e-3, 8.8e-3) by which any two Adam runs from one init may part
PAR_TOL = {"lifter": (1e-4, 3e-4), "matcher": (1e-3, 2e-3)}
# planted faults, run in the same world, each of which must break both
# limits (on that H100 the faulty runs read 1.8e-2 to 0.18 in loss and
# 1.17e-3 to 2.81e-3 in parameters):
# "unsummed", the gradients' all-reduce skipped (every sum of more than one
# tensor; each rank steps on its own block, the losses are still summed);
# "twice", every rank takes the first data block of each batch
FAULTS = ("unsummed", "twice")
WORLD_TIMEOUT_S = 420      # a world's processes, start to exit
PG_TIMEOUT_S = 300         # any collective


def probes():
    """What the machine offers phase 12: libzstd, tensorstore (found, not
    imported: the port does without it), the cards, NCCL."""
    import importlib.util

    import torch
    import torch.distributed as dist
    from mpe3d_tpu_torch.checkpoint_orbax import zstd_library
    return {"libzstd.so.1": zstd_library() is not None,
            "tensorstore": importlib.util.find_spec("tensorstore")
            is not None,
            "cards": torch.cuda.device_count(),
            "nccl": dist.is_nccl_available()}


def phase9_lifter_data(rig_config, rig):
    """Phase 9's full-width lifter problem: (data, LifterConfig, init)."""
    from mpe3d_tpu_torch.config import LifterConfig
    from mpe3d_tpu_torch.data.synthetic import generate_single_person_frames
    from mpe3d_tpu_torch.train.lifter import init_lifter_tree
    from mpe3d_tpu_torch.train.lifter_data import build_lifter_dataset

    wire = generate_single_person_frames(rig_config, rig, 160, seed=11)
    net, err = build_lifter_dataset(wire, rig_config, rig, device=GPU)
    if len(net) < N_TRAIN + N_DEV:
        raise AssertionError(f"lifter dataset: {len(net)} samples")
    data = (net[:N_TRAIN], err[:N_TRAIN], net[N_TRAIN:N_TRAIN + N_DEV],
            err[N_TRAIN:N_TRAIN + N_DEV])
    cfg = LifterConfig(in_dim=rig_config.lifter_input_dim,
                       out_dim=rig_config.n_joints * 3)
    return data, cfg, init_lifter_tree(cfg, TRAIN_SEED)


def check_orbax(rig_config, rig, d, zstd, smi):
    """Phase 12 (b): the full-width lifter trained with the orbax backend
    (saves during training on the saver thread), its checkpoint and a
    params + Adam save read back bit for bit, a leg resumed from the disk
    equal to one resumed from memory; the committed JAX-written OCDBT
    fixture read against its npz twin (where libzstd is missing, the read
    must raise naming it)."""
    import dataclasses
    import shutil

    import numpy as np
    from mpe3d_tpu_torch.checkpoint import (flatten_tree, load_checkpoint,
                                            open_checkpoint,
                                            read_optimizer_leaves,
                                            save_checkpoint,
                                            wait_for_async_saves)
    from mpe3d_tpu_torch.config import LifterTrainConfig
    from mpe3d_tpu_torch.train.lifter import train_lifter

    data, cfg, init = phase9_lifter_data(rig_config, rig)
    tcfg = LifterTrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                             eval_every=1, shuffle=False,
                             checkpoint_backend="orbax",
                             save_rel_improve=0.0)
    stem = os.path.join(d, "orbax", "pose_estimator")
    t = time.perf_counter()
    res = train_lifter(*data, rig_config, rig, cfg, tcfg, params=init,
                       checkpoint_path=stem, log=lambda s: None, device=GPU)
    t_train = time.perf_counter() - t
    if not os.path.isdir(stem + ".orbax") or os.path.exists(stem + ".npz"):
        raise AssertionError("train_lifter(checkpoint_backend='orbax') left "
                             "no orbax checkpoint")
    loaded, _, meta = load_checkpoint(stem, res.params)
    for a, b in zip(flatten_tree(loaded), flatten_tree(res.params)):
        if not np.array_equal(a, b):
            raise AssertionError("the orbax checkpoint differs from the "
                                 "trained parameters")
    full = os.path.join(d, "orbax", "with_adam")
    t = time.perf_counter()
    save_checkpoint(full, res.params, opt_state=res.opt_state,
                    meta={"lifter_config": cfg, "epoch": meta["epoch"]},
                    backend="orbax", wait=False)
    t_submit = time.perf_counter() - t
    wait_for_async_saves(full)
    t_save = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(full + ".orbax") for f in fs)
    p2, o2, _ = load_checkpoint(full, res.params, res.opt_state)
    pairs = list(zip(flatten_tree((p2, o2)),
                     flatten_tree((res.params, res.opt_state))))
    if len(pairs) != 1 + 3 * 2 * len(cfg.layer_dims()) or not all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs):
        raise AssertionError("the params + Adam checkpoint does not read "
                             "back bit for bit")
    more = dataclasses.replace(tcfg, epochs=1, checkpoint_backend="npz")
    legs = [train_lifter(*data, rig_config, rig, cfg, more, params=p,
                         opt_state=o, log=lambda s: None, device=GPU)
            for p, o in ((p2, read_optimizer_leaves(full)),
                         (res.params, res.opt_state))]
    h = [[(x["train_loss"], x["val_loss"]) for x in leg.history]
         for leg in legs]
    if h[0] != h[1]:
        raise AssertionError(f"a leg resumed from the orbax checkpoint "
                             f"{h[0]} differs from one resumed from memory "
                             f"{h[1]}")
    print(f"  orbax backend: full-width train_lifter, {TRAIN_EPOCHS} "
          f"epochs with saves on the saver thread, {t_train:.2f} s; the "
          f"checkpoint equals the trained parameters bit for bit; params + "
          f"Adam ({nbytes / 1e6:.1f} MB, plain zarr) submitted in "
          f"{1e3 * t_submit:.1f} ms, committed in {t_save:.2f} s, read back "
          f"bit for bit; a leg resumed from it equals one resumed from "
          f"memory: {h[0]} ({smi})", flush=True)
    fx = os.path.join(d, "fixture")
    shutil.copytree(FIXTURE, fx)
    if not zstd:
        try:
            open_checkpoint(os.path.join(fx, "pose_estimator"))
        except RuntimeError as e:
            if "libzstd.so.1" not in str(e):
                raise
            print(f"  the JAX-written OCDBT fixture: libzstd.so.1 is not on "
                  f"this machine, and the read raises naming it: {e}",
                  flush=True)
            return
        raise AssertionError("a zstd-compressed checkpoint read without "
                             "libzstd.so.1")
    got, fmeta = open_checkpoint(os.path.join(fx, "pose_estimator"))
    with np.load(os.path.join(fx, "twin.npz")) as twin:
        names = sorted(k for k in twin.files if k != "__meta_json__")
        if sorted(got) != names or not all(
                np.array_equal(got[k], twin[k]) and got[k].dtype ==
                twin[k].dtype for k in names):
            raise AssertionError("the JAX-written fixture differs from its "
                                 "npz twin")
        if fmeta != json.loads(bytes(twin["__meta_json__"]).decode()):
            raise AssertionError("the fixture's meta differs from its twin's")
    print(f"  the JAX-written OCDBT fixture (tests/data/orbax_lifter, "
          f"{len(names)} leaves, zstd) equals its npz twin bit for bit, meta "
          f"included", flush=True)


def parallel_problems(rig_config, rig, d):
    """The runs phase 12 trains in a world and in one process, written to
    ``d/problems.pkl`` for the world's processes: the lifter (phase 9's)
    and the matcher (phase 10's scenes, batch ``PAR_M_BATCH``)."""
    import pickle

    from mpe3d_tpu_torch.config import MatcherConfig
    from mpe3d_tpu_torch.weights import random_matcher_tree

    data, cfg, init = phase9_lifter_data(rig_config, rig)
    _, topo, train, dev = matcher_scene_sets(rig_config, rig)
    mcfg = MatcherConfig(in_dim=rig_config.matcher_feature_dim)
    prob = {"lifter": (data, cfg, init),
            "matcher": (train, dev, topo, mcfg,
                        random_matcher_tree(mcfg, MATCHER_SEED))}
    with open(os.path.join(d, "problems.pkl"), "wb") as f:
        pickle.dump(prob, f)
    return prob


def parallel_task(task, prob, rig_config, rig, mesh):
    """One run of phase 12 (over ``mesh``, one process without it):
    {"history": [(train, dev, elapsed)], "params": leaves, "n": samples or
    scenes an epoch}."""
    from mpe3d_tpu_torch.checkpoint import flatten_tree
    from mpe3d_tpu_torch.config import LifterTrainConfig, MatcherTrainConfig
    from mpe3d_tpu_torch.train.lifter import train_lifter
    from mpe3d_tpu_torch.train.matcher import train_matcher

    if task.startswith("lifter"):
        data, cfg, init = prob["lifter"]
        res = train_lifter(*data, rig_config, rig, cfg, LifterTrainConfig(
            epochs=PAR_EPOCHS, batch_size=TRAIN_BATCH, eval_every=1,
            shuffle=False), params=init, mesh=mesh, log=lambda s: None,
            device=GPU)
        n = len(data[0]) // TRAIN_BATCH * TRAIN_BATCH
    else:
        train, dev, topo, cfg, init = prob["matcher"]
        res = train_matcher(train, dev, rig_config, rig, topo, cfg,
                            MatcherTrainConfig(epochs=PAR_EPOCHS,
                                               batch_size=PAR_M_BATCH,
                                               eval_every=1,
                                               scan_epoch=False),
                            params=init, mesh=mesh, log=lambda s: None,
                            device=GPU)
        n = len(train)
    return {"history": [(h["train_loss"], h["val_loss"], h["elapsed_s"])
                        for h in res.history],
            "params": flatten_tree(res.params), "n": n,
            "steps": int(res.opt_state[0])}


def planted_fault(fault):
    """A context in which the trainers run with ``fault`` (``FAULTS``)."""
    import contextlib

    from mpe3d_tpu_torch.parallel import mesh as pm
    from mpe3d_tpu_torch.train import lifter, matcher

    def unsummed(group, size, tensors):
        return (list(tensors) if len(tensors) > 1
                else pm.sum_over(group, size, tensors))

    def twice(mesh, n):
        lo, hi = pm.data_block(mesh, n)
        return 0, hi - lo

    name, fn = {"unsummed": ("sum_over", unsummed),
                "twice": ("data_block", twice)}[fault]

    @contextlib.contextmanager
    def ctx():
        for mod in (lifter, matcher):
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod in (lifter, matcher):
                setattr(mod, name, getattr(pm, name))
    return ctx()


def parallel_worker(argv) -> int:
    """A rank of a phase 12 world (``chip_smoke.py --parallel-worker``):
    joins the world (``--backend``, a ``file://`` store in ``--dir``, a
    timeout on every collective) on the card, checks the backend's
    collectives on card tensors, runs ``--tasks`` over a data-axis mesh
    (``lifter_tp``: a model-axis mesh; ``<task>:<fault>``: with a planted
    fault) and, on rank 0, writes the results to ``DIR/<backend>.pkl``."""
    import argparse
    import contextlib
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
    from mpe3d_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    for a in ("--rank", "--world"):
        ap.add_argument(a, type=int, required=True)
    for a in ("--backend", "--dir", "--tasks"):
        ap.add_argument(a, required=True)
    a = ap.parse_args(argv)
    torch.cuda.set_device(0)
    dist.init_process_group(
        a.backend, init_method=f"file://{a.dir}/store-{a.backend}",
        rank=a.rank, world_size=a.world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    w = a.world
    t = torch.full((4,), float(a.rank + 1), device=GPU)
    dist.all_reduce(t)
    parts = [torch.empty(4, device=GPU) for _ in range(w)]
    dist.all_gather(parts, t)
    b = torch.full((2,), float(a.rank), device=GPU)
    dist.broadcast(b, src=0)
    if (t.tolist() != [w * (w + 1) / 2] * 4 or b.tolist() != [0.0, 0.0]
            or any(p.tolist() != t.tolist() for p in parts)):
        raise AssertionError(f"{a.backend} collectives on the card: "
                             f"all_reduce {t.tolist()}, broadcast "
                             f"{b.tolist()}")
    with open(os.path.join(a.dir, "problems.pkl"), "rb") as f:
        prob = pickle.load(f)
    rig = synthetic_ring_rig(PANOPTIC)
    out = {}
    for task in a.tasks.split(","):
        mesh = (make_mesh(n_data=1, n_model=w, device=GPU)
                if task == "lifter_tp" else make_mesh(device=GPU))
        fault = task.partition(":")[2]
        with planted_fault(fault) if fault else contextlib.nullcontext():
            out[task] = parallel_task(task, prob, PANOPTIC, rig, mesh)
    if a.rank == 0:
        with open(os.path.join(a.dir, f"{a.backend}.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_world(d, backend, world, tasks):
    """Start a world of ``world`` processes of this script on the card and
    wait for it (``WORLD_TIMEOUT_S``); its results."""
    import pickle

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-worker",
         "--rank", str(r), "--world", str(world), "--backend", backend,
         "--dir", d, "--tasks", ",".join(tasks)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(world)]
    t0, logs = time.perf_counter(), []
    try:
        for p in procs:
            left = WORLD_TIMEOUT_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"the {backend} world of {world} exited "
                             f"{[p.returncode for p in procs]}:\n"
                             + "\n".join(log[-3000:] for log in logs))
    with open(os.path.join(d, f"{backend}.pkl"), "rb") as f:
        return pickle.load(f), time.perf_counter() - t0


def compare_runs(label, got, ref, tol):
    """A world's run against the one-process run: (the limits of ``tol``
    (``PAR_TOL``'s) that it breaks, of "steps", "loss" and "params"; a
    line saying how far apart)."""
    import numpy as np
    rel = [max(abs(g / r - 1.0) for g, r in zip(gh[:2], rh[:2]))
           for gh, rh in zip(got["history"], ref["history"])]
    dp = max(float(np.abs(a - b).max()) for a, b in zip(got["params"],
                                                       ref["params"]))
    broken = ((["steps"] if len(got["history"]) != len(ref["history"])
               or got["steps"] != ref["steps"] else [])
              + (["loss"] if max(rel) > tol[0] else [])
              + (["params"] if dp > tol[1] else []))
    return broken, (f"{label}: max rel loss difference a epoch "
                    f"{[float(f'{r:.3g}') for r in rel]} (limit {tol[0]:g}),"
                    f" max |d param| {dp:.3g} (limit {tol[1]:g}) after "
                    f"{ref['steps']} steps")


def epoch_rate(run):
    """(seconds of each epoch after the first, items a second of the last)."""
    ends = [h[2] for h in run["history"]]
    secs = [b - a for a, b in zip(ends, ends[1:])]
    return secs, run["n"] / secs[-1]


def check_parallel(rig_config, rig, d, nccl, smi):
    """Phase 12 (c): a 2-rank gloo world on the one card (both ranks on
    cuda:0: gloo takes CUDA tensors, NCCL refuses two ranks on one card)
    trains the full-width lifter (batch 256), the lifter 1x2
    tensor-parallel, and the full-width matcher (batch ``PAR_M_BATCH``);
    each held to the one-process card run at the same global batch within
    ``PAR_TOL`` (``compare_runs``), and each data-parallel task run again
    with each planted fault of ``FAULTS``, which must break both.  A
    1-rank NCCL world runs the lifter through the same path (its
    collectives checked on card tensors first).  Epoch seconds and rates
    at 1 and 2 ranks: overhead, not speed-up (one card)."""
    prob = parallel_problems(rig_config, rig, d)
    one = {t: parallel_task(t, prob, rig_config, rig, None)
           for t in ("lifter", "matcher")}
    planted = [f"{t}:{f}" for t in ("lifter", "matcher") for f in FAULTS]
    gloo, t_gloo = run_world(d, "gloo", 2, ("lifter", "lifter_tp",
                                            "matcher", *planted))
    if not nccl:
        raise AssertionError("torch.distributed has no NCCL on this machine")
    nc, t_nccl = run_world(d, "nccl", 1, ("lifter",))
    lines, bad, caught = [], [], []
    for label, got, task in (
            ("gloo 2 ranks, lifter", gloo["lifter"], "lifter"),
            ("gloo 1x2 tensor-parallel, lifter", gloo["lifter_tp"],
             "lifter"),
            ("gloo 2 ranks, matcher", gloo["matcher"], "matcher"),
            ("NCCL 1 rank, lifter", nc["lifter"], "lifter")):
        ref = one[task]
        broken, line = compare_runs(label, got, ref, PAR_TOL[task])
        lines.append(line)
        if broken:
            bad.append(f"{line}, breaks {broken}: losses {got['history']} "
                       f"against one process {ref['history']}")
    for task in planted:
        t, _, fault = task.partition(":")
        broken, line = compare_runs(f"gloo 2 ranks, {t}, planted fault "
                                    f"{fault}", gloo[task], one[t],
                                    PAR_TOL[t])
        caught.append(f"{line}: breaks {broken}")
        if not {"loss", "params"} <= set(broken):
            bad.append(f"{line}: the planted fault breaks only {broken}")
    rates = []
    for label, run, unit in (
            ("lifter, 1 process", one["lifter"], "samples"),
            ("lifter, gloo 2 ranks", gloo["lifter"], "samples"),
            ("lifter 1x2 tensor-parallel, gloo", gloo["lifter_tp"],
             "samples"),
            ("lifter, NCCL 1 rank", nc["lifter"], "samples"),
            ("matcher, 1 process", one["matcher"], "scenes"),
            ("matcher, gloo 2 ranks", gloo["matcher"], "scenes")):
        secs, rate = epoch_rate(run)
        rates.append(f"{label}: warm epochs {[round(s, 4) for s in secs]} s,"
                     f" {rate:.1f} {unit} a second")
    print(f"  worlds on the card: gloo 2 ranks ({t_gloo:.1f} s, start to "
          f"exit, planted faults included), NCCL 1 rank ({t_nccl:.1f} s); "
          f"against one process at the same global batch: "
          + "; ".join(lines), flush=True)
    print("  planted faults against the same limits: " + "; ".join(caught),
          flush=True)
    print("  epoch times (dev evaluation included; two ranks on one card "
          "measure overhead, not speed-up): " + "; ".join(rates)
          + f" ({smi})", flush=True)
    if bad:
        raise AssertionError("; ".join(bad))


def check_multi_device(pipe_of, frames, wire4, wire10, gate, smi):
    """Phase 12 (d): ``enable_multi_device_serving(["cuda:0", "cuda:0"])``
    on phase 4's 16 S=4 frames (pan_irls_bf16's lifter, random matcher):
    persons equal to the single-device pipeline's, scores within 1e-5,
    both replicas used, the kernels launched; ``infer_batch(mesh=...)`` over
    the two replicas equal to the unsplit call; ``serve --multi-device``
    over stdio equal to ``serve``."""
    import numpy as np
    from mpe3d_tpu_torch.parallel.mesh import make_mesh

    single_pipe = pipe_of()
    single = [single_pipe.infer_fused(f) for f in frames]
    pipe = pipe_of()
    n = pipe.enable_multi_device_serving(devices=["cuda:0", "cuda:0"])
    reset_launches()
    multi = list(pipe.infer_stream(frames, depth=2 * n))
    launches = read_launches()

    def same(got, ref, label):
        for i, (g, r) in enumerate(zip(got, ref)):
            ds = float(np.abs(g.scores - r.scores).max())
            if not np.array_equal(g.persons, r.persons) or ds > 1e-5:
                raise AssertionError(f"{label}, frame {i}: persons "
                                     f"{g.persons} / {r.persons}, max |d "
                                     f"score| {ds}")
        return sum(len(g.persons) for g in got)

    persons = same(multi, single, "multi-device serving")
    if pipe.replica_uses != [8, 8] or not launches["mlp_run"] \
            or not launches["gat_stack"]:
        raise AssertionError(f"replica uses {pipe.replica_uses}, launches "
                             f"{launches}")
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    whole = single_pipe.infer_batch(frames)
    split = single_pipe.infer_batch(frames, mesh=mesh)
    same(split, whole, "infer_batch(mesh=...)")
    lines = [json.dumps(f) for f in wire4 + wire10]
    one, _ = serve_stdio(lines, 3, gate)
    import torch
    got, err = serve_stdio(lines, 3, gate, "--multi-device")
    cards = torch.cuda.device_count()
    if f"round-robin serving over {cards} devices" not in err:
        raise AssertionError(f"serve --multi-device: {err[-2000:]}")
    compare_records(got, one, "serve --multi-device")
    print(f"  multi-device serving, 2 replicas on cuda:0: 16 S=4 frames "
          f"through infer_stream, persons equal to one device ({persons} "
          f"persons), replica uses {pipe.replica_uses}, launches "
          f"{launches}; infer_batch over a 2-device mesh equals the unsplit "
          f"call; serve --multi-device ({cards} card(s), a replica each) "
          f"over stdio equals serve ({len(got)} records) ({smi})",
          flush=True)


def run_parallel_and_serving(rig_config, rig, pipe_of, frames, wire4,
                             wire10, gate, smi):
    """Phase 12: probes, (b) orbax, (c) worlds, (d) multi-device serving,
    in a temporary directory."""
    import tempfile
    p = probes()
    print(f"  probes: {json.dumps(p)}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        check_orbax(rig_config, rig, d, p["libzstd.so.1"], smi)
        check_parallel(rig_config, rig, d, p["nccl"], smi)
    check_multi_device(pipe_of, frames, wire4, wire10, gate, smi)
    return p


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mpe3d_tpu_torch import native, weights
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
    t1 = time.perf_counter()
    if native.load_library() is None:
        raise AssertionError("the C++ wire parser did not build")
    print(f"  C++ wire parser: {native.LIB_PATH} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    phase("build", t0, f"nvcc {lib.build_seconds:.1f} s; ptxas: "
          + ("; ".join(spills) if spills else "no spills"))

    t0 = time.perf_counter()
    rig_config = PANOPTIC
    rig = synthetic_ring_rig(rig_config)
    mtree, mcfg, ltree, lcfg, prior = load_trees(rig_config)
    rtree = weights.random_matcher_tree(mcfg, RANDOM_MATCHER_SEED)
    wire4 = generate_frames(rig_config, rig, N_FRAMES, n_people=(2, 3),
                            seed=1)
    wire10 = generate_frames(rig_config, rig, N_CROWDED, n_people=(6, 9),
                             seed=3)
    frames = [parse_frame(f, rig_config) for f in wire4]
    frames10 = [parse_frame(f, rig_config) for f in wire10]
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

    def int8_pipeline(tree, device, use_frame_kernel=None,
                      models_dir=DEMO_INT8):
        """A demo pair (the int8-stored models_demo/pan_irls unless
        ``models_dir`` names another) through from_checkpoint, served with
        the given matcher (the Panoptic pairs ship the matcher of
        pan_irls_bf16)."""
        pipe = PoseEstimationPipeline.from_checkpoint(
            models_dir, rig, rig_config, device=device, slot_buckets=(4,),
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
    nets8 = gpu_r.stage_inputs(frames[0])[3]
    _, _, run_turns = check_run_rows(
        "bf16, pan_irls_bf16", gpu_r.lifter, nets8, report,
        "mpe3d_tpu/ops/fused_mlp.py:57", bf16_library)
    check_run_rows("int8, pan_irls", irls_gpu.lifter, nets8, report,
                   "mpe3d_tpu/ops/fused_mlp.py:80", int8_net_library)
    check_run_wide("bf16, pan_irls_bf16", gpu_r.lifter, nets8, report,
                   "mpe3d_tpu/ops/fused_mlp.py:57", bf16_library)
    check_run_wide("int8, pan_irls", irls_gpu.lifter, nets8, report,
                   "mpe3d_tpu/ops/fused_mlp.py:80", int8_net_library)
    check_int8_rows64(irls_gpu.lifter, nets8, report)
    check_batch_decode(gpu_r, frames, trained16, frames16, report)
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
    variants = variant_setups((ltree, lcfg), prior)
    arp_turns = check_variant_kernels(variants, report)
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
          "layers, a bf16 head; the recipe of pan_irls_bf16), "
          "models_demo/pan_compact, the shipping pair models_demo/pan_res "
          "(int8, median prior) and models_demo/pan_lowview_bf16 (bf16, "
          "IRLS prior)")
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
        for name, models_dir in DEMO_PAIRS.items():
            gpu = int8_pipeline(tree, GPU, models_dir=models_dir)
            if not gpu.frame_path_on():
                raise AssertionError(f"{name}: not on the frame path")
            run_main_path(gpu, int8_pipeline(tree, "cpu", True, models_dir),
                          frames[:N_SHORT],
                          f"{name} ({gpu.serve_dtype}, {gpu.lifter_prior} "
                          f"prior), {mlabel} matcher, frame path")
    phase("int8 path", t0, "int8 pairs, pan_res and pan_lowview_bf16 on the "
          "card agree with the CPU; "
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
        if "path" not in k:
            k["launches"] = path_launches.get(k["replaces"],
                                              main_launches)[k["name"]]
    missing = [k["name"] for k in report
               if "path" not in k and not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    phase("crowded path", t0, "infer_fused on the card agrees with the CPU "
          "on every crowded bucket; median frame ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in crowded_ms.items()))

    t0 = time.perf_counter()
    gate, latency = check_stdio(wire4, wire10)
    check_tcp(wire4, wire10)
    fps = check_infer_stream(frames, rtree)
    parse_us = time_parser([json.dumps(f) for f in wire4 + wire10],
                           rig_config)
    print(f"  serve latency_ms, median over the stdio run's frames: depth 1 "
          f"{latency[1]:.3f}, depth 3 {latency[3]:.3f} ({smi})")
    print(f"  frames per second, 16 S=4 frames x {N_STREAM_PASSES}, random "
          f"matcher, in turns: infer_fused loop {fps[0]:.1f}, "
          f"infer_stream(depth=3) {fps[1]:.1f}, {fps[2]:.1f}, infer_fused "
          f"loop {fps[3]:.1f} ({smi})")
    print(f"  wire parser, us a frame line (22 lines x {N_PARSE_REPS}): C++ "
          f"{parse_us['native']:.1f}, json.loads + parse_frame "
          f"{parse_us['python']:.1f} ({smi})", flush=True)
    phase("serve path", t0, "python -m mpe3d_tpu_torch serve over stdio "
          "(reload included) and two concurrent TCP clients on pan_res agree "
          "with the CPU; infer_stream is bit-equal to infer_fused")

    t0 = time.perf_counter()
    iltree, ilcfg, iprior = load_lifter(DEMO_INT8, rig_config)
    pairs = {"pan_irls_bf16": (ltree, lcfg, prior),
             "pan_irls (int8)": (iltree, ilcfg, iprior)}
    batch_runs = {}
    for (pname, (lt, lc, pr)), mlabel, (blabel, kw, bframes) in (
            (p, m, b) for p in pairs.items() for m in matchers
            for b in (("S=4", dict(slots=(4,), persons=(8,)), frames),
                      ("S=10", dict(slots=(2, 4, 10), persons=(4, 8, 16),
                                    lifter_prior=CROWDED_PRIOR), frames10))):
        kw = {"lifter_prior": pr, **kw, "lifter": (lt, lc)}
        batch_runs[pname, mlabel, blabel] = run_batch_path(
            pipeline(matchers[mlabel], GPU, **kw),
            pipeline(matchers[mlabel], "cpu", True, **kw), bframes,
            f"infer_batch, {pname}, {mlabel} matcher, {len(bframes)} "
            f"{blabel} frames")
    graphs = check_batch_graphs(pipeline, variants["arplab_bf16"], mtree,
                                rtree, rig_config, rig, smi)
    staged = check_staged(
        lambda device, **kw: pipeline(rtree, device, **kw),
        frames[:STAGED_FRAMES])
    batch_lat = check_stdio_batch(wire4, wire10, gate)
    fps_turns, (b_dev, b_n), (l_dev, l_n) = batch_fps(pipeline(rtree, GPU),
                                                      frames)
    print(f"  lifter run kernel, device ms in turns: one M=64 launch "
          f"{run_turns[0]:.4f} against four M=16 launches {run_turns[1]:.4f} "
          f"(bf16 pair; {smi})")
    print(f"  frames per second, {N_BATCH_TIMED} S=4 frames x 4, random "
          f"matcher, in turns: infer_fused loop {fps_turns[0]:.1f}, "
          f"infer_batch(B={N_BATCH_TIMED}) {fps_turns[1]:.1f}, "
          f"{fps_turns[2]:.1f}, infer_fused loop {fps_turns[3]:.1f}; under "
          f"the profiler a batch is {b_n:g} CUDA launches and {b_dev:.4f} "
          f"ms of device time, the loop {l_n:g} launches and {l_dev:.4f} ms "
          f"({smi})", flush=True)
    # each batch row's launches from the batch run of its pair (random
    # matcher, S=4: live persons)
    batch_src = {"mpe3d_tpu/ops/fused_mlp.py:57":
                 batch_runs["pan_irls_bf16", "random", "S=4"],
                 "mpe3d_tpu/ops/frame_kernel.py:358":
                 batch_runs["pan_irls_bf16", "random", "S=4"],
                 "mpe3d_tpu/ops/fused_mlp.py:80":
                 batch_runs["pan_irls (int8)", "random", "S=4"],
                 "mpe3d_tpu/ops/quant_matmul.py:73":
                 batch_runs["pan_irls (int8)", "random", "S=4"]}
    for k in report:
        if k.get("path") == "batch":
            k["launches"] = batch_src[k["replaces"]][k["name"]]
    missing = [k["name"] for k in report
               if k.get("path") in (None, "batch") and not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    phase("batch and staged paths", t0,
          f"infer_batch on the card agrees with infer_fused and the CPU for "
          f"both pairs and matchers at S=4 and S=10; the batch graphs "
          f"replay bit-equal to the eager body ({', '.join(graphs)}, after "
          f"reload_weights); the staged path "
          f"({', '.join(staged)}) agrees with the CPU; serve --batch-window "
          f"4 equals --batch-window 1 (median latency_ms "
          f"{batch_lat[4]:.3f} / {batch_lat[1]:.3f})")

    t0 = time.perf_counter()
    print(f"  ARPLAB: 6 cameras on a synthetic ring rig (world-up from its Z "
          f"entry), random matcher seed {ARPLAB_LIVE_SEED}; the lifter run "
          f"kernel at K0=1512, device ms in turns: one M=64 launch "
          f"{arp_turns[0]:.4f} against four M=16 launches {arp_turns[1]:.4f} "
          f"(bf16 ARPLAB lifter; {smi})", flush=True)
    variant_launches, variant_ms = run_variants(variants)
    for k in report:
        if k.get("path") in variant_launches:
            k["launches"] = variant_launches[k["path"]][k["name"]]
    missing = [f"{k['name']} ({k.get('case')})" for k in report
               if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    phase("second rig and graph variants", t0,
          "ARPLAB (arp_irls int8 and a bf16 lifter, trained and random "
          "matcher, S=4 and S=10, infer_batch, serve --rig ARPLAB), BODY_25 "
          "on the frame path, alt-2, alt-1 and a residual matcher on the "
          "eager path agree with the CPU; median frame ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in variant_ms.items())
          + f" ({smi})")

    t0 = time.perf_counter()
    eval_launches, ltree9, lcfg9 = run_eval_and_training(
        rig_config, rig, matchers, mcfg, smi)
    phase("evaluation and training", t0,
          f"train_lifter at full width on the card tracks the CPU within "
          f"{TRAIN_RTOL} a epoch; run_pose_metrics (fused, stream "
          f"{EVAL_STREAM}) serves the trained lifter through the kernels "
          f"(launches {eval_launches}) with the CPU's counts; sm-metrics, "
          f"reprojection-error, train-lifter and metrics-from-model run on "
          f"the card ({smi})")

    t0 = time.perf_counter()
    lifters = {"pan_irls_bf16": (ltree, lcfg, prior),
               "random": (weights.random_lifter_tree(lcfg, 1), lcfg,
                          "mean")}
    m_launches = run_matcher_training_and_files(
        rig_config, rig, matchers, mcfg, lifters, frames, frames10, wire4,
        ltree9, lcfg9, prior, smi)
    phase("matcher training and model files", t0,
          f"train_matcher at full width on the card tracks the CPU within "
          f"{TRAIN_RTOL} a epoch (MSE; BCE with prune_dist); --device-synth "
          f"trains on scenes synthesised on the card; the trained matcher "
          f"serves through the kernels (launches {m_launches}) with the "
          f"CPU's persons; export-torch / convert-torch, the reference's "
          f"files, export-servable int8 / bf16 and infer --profile-trace "
          f"serve on the card ({smi})")

    t0 = time.perf_counter()
    run_conversion_and_viewers(rtree, mcfg, rig_config, rig, smi)
    phase("conversor and viewers", t0,
          "resize_linear and the peaks on the card equal the CPU's; "
          "Detector2D (PoseResNet-50 at 960x512) agrees with the CPU; "
          "convert_sequence converts a 5-camera HD sequence; show-results "
          f"--out .html and --live agree with --cpu ({smi})")

    t0 = time.perf_counter()
    p12 = run_parallel_and_serving(rig_config, rig,
                                   lambda: pipeline(rtree, GPU), frames,
                                   wire4, wire10, gate, smi)
    phase("checkpoints, parallel training and multi-device serving", t0,
          f"probes {json.dumps(p12)}; orbax checkpoints written and read "
          f"back bit for bit, the JAX fixture against its npz twin; gloo 2 "
          f"ranks (data- and tensor-parallel) and NCCL 1 rank track one "
          f"process; two serving replicas give one device's persons "
          f"({smi})")

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
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main())
