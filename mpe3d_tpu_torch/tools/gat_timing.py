"""Time the GAT kernels of one checkout on the card: the stack kernel
(``gat_stack``) on the trained matcher at S=4 and S=16, and the tiled
kernels K1 and K2 at S=16, each as call ms (CUDA events around the
wrapper, its host work included), device ms (torch.profiler, kernels and
copies only) and CUDA kernel launches a call; and the median
``infer_fused`` frame ms (host clock) of the frame path at S=4 (stack
form) and S=16 (tiled form) on 16 frames each, the frames in which these
kernels serve.

    python3 mpe3d_tpu_torch/tools/gat_timing.py [--root DIR] [--label L]

``--root`` is the checkout whose ``mpe3d_tpu_torch`` is imported and built
(default: the one that holds this file); run it on two checkouts in turns
(a, b, b, a) on one card, one run after another, to compare them.  The
inputs are the ones ``chip_smoke.py`` gives these kernels: the trained
matcher of ``models_demo/pan_irls_bf16`` (read from the checkout that
holds this file, whatever ``--root``) on the synthetic Panoptic ring rig,
frame 0 of ``generate_frames(..., n_people=(2, 3), seed=1)`` at S=4 and of
``n_people=(10, 14), seed=2`` at S=16 (all 16 frames for the frame times;
the IRLS prior at S=4, "mean" at S=16, as ``chip_smoke.py``), the
pipeline's ``edge_const`` where the checkout's ``gat_stack`` takes it.
Prints the card's name and power limit, then one JSON line (with each
item's device ms by kernel name).
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def median_ms(fn, n: int = 50) -> float:
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
    """(device ms, CUDA kernel launches, device ms by kernel name) of one
    call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    ms = sum(max(ev.device_time_total, ev.self_device_time_total)
             for ev in evs) / 1e3 / n
    kernels = sum(ev.count for ev in evs
                  if not ev.key.startswith(("Memcpy", "Memset")))
    by_name = {}
    for ev in evs:
        name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = re.sub(r"^.*::", "", name.removeprefix("void ")).strip()
        by_name[name] = by_name.get(name, 0.0) + max(
            ev.device_time_total, ev.self_device_time_total) / 1e3 / n
    return ms, kernels / n, by_name


def measure(fn, calls: int = 1) -> dict:
    ms = median_ms(fn)
    dev, launches, by_name = device_profile(fn)
    return {"call_ms": ms, "device_ms": dev,
            "cuda_launches_a_call": launches / calls,
            "device_ms_by_kernel": by_name}


def frame_ms(pipe, frames, warmup: int = 3) -> float:
    """Median host ms of ``infer_fused`` (frame in, poses on the host)."""
    for f in frames[:warmup]:
        pipe.infer_fused(f)
    times = []
    for f in frames:
        t0 = time.perf_counter()
        pipe.infer_fused(f)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gat_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            load_matcher_checkpoint)
    from mpe3d_tpu_torch.config import (PANOPTIC, LifterConfig,
                                        MatcherConfig)
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.models.gat import gat_topology
    from mpe3d_tpu_torch.ops import _build, gat_kernel, gat_tiled
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.library()
    demo = os.path.join(REPO, "models_demo", "pan_irls_bf16")
    rc = PANOPTIC
    rig = synthetic_ring_rig(rc)
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(demo, "skeleton_matching"),
        MatcherConfig(in_dim=rc.matcher_feature_dim))
    ltree, lcfg, prior = load_lifter_checkpoint(
        os.path.join(demo, "pose_estimator"),
        LifterConfig(in_dim=rc.lifter_input_dim, out_dim=rc.n_joints * 3))

    def pipeline(S):
        return PoseEstimationPipeline(
            rc, rig, weights.matcher_from_tree(mtree, mcfg, "cuda"),
            weights.lifter_from_tree(ltree, lcfg, "cuda"), slot_buckets=(S,),
            person_buckets=(8 if S == 4 else 16,),
            lifter_prior=prior if S == 4 else "mean", device="cuda")

    frames4 = [parse_frame(f, rc) for f in generate_frames(
        rc, rig, 16, n_people=(2, 3), seed=1)]
    frames16 = [parse_frame(f, rc, max_skeletons=16) for f in
                generate_frames(rc, rig, 16, n_people=(10, 14), seed=2)]
    frame4, frame16 = frames4[0], frames16[0]
    const = ({"edge_const": True} if "edge_const" in inspect.signature(
        gat_kernel.gat_stack).parameters else {})
    out = {"label": a.label, "root": root, "device": smi,
           "stack_edge_const": bool(const)}
    p4, p16 = pipeline(4), pipeline(16)
    for S, pipe, frame in ((4, p4, frame4), (16, p16, frame16)):
        x, pw, gtopo, form = pipe.gat_stage_inputs(frame)
        m = pipe.matcher
        if form != "stack":
            gtopo = gat_topology(pipe.topology(S), "cuda", "stack")
        args = (x, pw, gtopo, m.flat, m.dims, m.cfg.alpha,
                m.cfg.hidden_slope)
        out[f"gat_stack_S{S}"] = measure(
            lambda: gat_kernel.gat_stack(*args, **const))
    x, pw, gtopo, form = p16.gat_stage_inputs(frame16)
    m = p16.matcher
    k1s, k2s, _ = gat_tiled.cuda_layer_calls(
        x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope,
        edge_const=True)
    for i, k1 in enumerate(k1s):
        k1()
        if i < len(k2s):
            k2s[i]()
    out["gat_k1_S16"] = measure(lambda: [k() for k in k1s], len(k1s))
    out["gat_k2_S16"] = measure(lambda: [k() for k in k2s], len(k2s))
    out["gat_stack_tiled_S16"] = measure(lambda: gat_tiled.gat_stack_tiled(
        x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope,
        edge_const=True))
    out["frame_ms_S4"] = frame_ms(p4, frames4)
    out["frame_ms_S16"] = frame_ms(p16, frames16)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
