#!/usr/bin/env python3
"""Where one frame of the PyTorch port's ``infer_fused`` spends its time.

    python3 scripts/torch_stage_breakdown.py

On one CUDA GPU, with the configuration ``chip_smoke.py`` drives (Panoptic
ring rig, S=4, P=8, 16 frames of 2-3 people, seed 1), for the trained and
the numpy-seeded random matcher:

* per-stage host wall time of a frame, each stage ended by
  ``torch.cuda.synchronize()`` (medians over the frames): upload, features,
  GAT, decode, gather + pack, lifter, quality + download;
* the unsynchronized frame time (``infer_fused``), median;
* a ``torch.profiler`` run over the frames: device time (kernels and
  copies), its share of the wall time (busy share), the device time of the
  port's two kernels a frame, and the device events that take the most.

Prints the card's name and power limit, one line per measurement and a
final JSON line.  Imports only torch, numpy, the standard library,
``mpe3d_tpu_torch`` and ``chip_smoke``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def stage_times(pipe, frame):
    """Host wall ms per stage of one frame (mirrors PoseEstimationPipeline._run)."""
    import torch
    from mpe3d_tpu_torch.lifting.pack import pack_lifter_input
    from mpe3d_tpu_torch.matching.decode_device import \
        decode_person_proposals_device
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
        topo, gtopo, _ = pipe._bucket_state(S)
        x_all, pmask = pipe._match_inputs(S, *args)
        mark("features")
        scores = torch.sigmoid(pipe.matcher(x_all, pmask, gtopo)) * pmask
        mark("gat")
        p_max = pipe._p_max(S)
        persons, person_mask = decode_person_proposals_device(
            scores, pmask, topo, pipe.rig_config.min_number_of_views,
            pipe.threshold, p_max, top_k=pipe.decode_top_k)
        mark("decode")
        kp, valid, prob, observed, _ = args
        pkp, pval, pprob, pobs = pipe._person_obs(persons, kp, valid, prob,
                                                  observed)
        nets, _ = pack_lifter_input(pkp, pval, pprob, pobs, pipe.used_rig,
                                    pipe.image_size,
                                    prior=pipe.lifter_prior,
                                    prior_gate_px=pipe.prior_gate_px)
        mark("gather_pack")
        poses = pipe.lifter(nets).reshape(p_max, -1, 3) * 10.0
        mark("lifter")
        q = pose_quality_px(poses, pkp, pval, pobs, pipe.used_rig)
        (poses * person_mask[:, None, None]).cpu(), q.cpu(), scores.cpu()
        mark("quality_download")
    return out


_PORT_KERNELS = {"gat_stack": ("gemm_bias_act", "attn_terms", "edge_out",
                                "head_out"),
                 "mlp_bf16_layer": ("mlp_bf16_layer_kernel",)}


def profile(pipe, frames):
    """Over the frames: wall ms, device ms (kernels and copies on the card,
    each counted once), device ms of each port kernel, top device events."""
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
    rows = []
    for ev in prof.key_averages():
        # operator rows on the host repeat their kernels' device time;
        # only rows of device events are summed
        if ev.device_type != DeviceType.CUDA:
            continue
        us = max(ev.device_time_total, ev.self_device_time_total)
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    port = {name: sum(ms for ms, k, _ in rows if any(p in k for p in parts))
            for name, parts in _PORT_KERNELS.items()}
    return wall, sum(r[0] for r in rows), port, rows[:8]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import PANOPTIC
    from mpe3d_tpu_torch.data.frames import parse_frame
    from mpe3d_tpu_torch.data.synthetic import (generate_frames,
                                                synthetic_ring_rig)
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    print(cs.nvidia_smi_line(), flush=True)
    rig = synthetic_ring_rig(PANOPTIC)
    mtree, mcfg, ltree, lcfg, prior, lsource = cs.load_trees(PANOPTIC)
    print(f"lifter weights: {lsource}")
    frames = [parse_frame(f, PANOPTIC) for f in generate_frames(
        PANOPTIC, rig, cs.N_FRAMES, n_people=(2, 3), seed=1)]
    result = {}
    for label, tree in (("trained", mtree),
                        ("random", weights.random_matcher_tree(
                            mcfg, cs.RANDOM_MATCHER_SEED))):
        pipe = PoseEstimationPipeline(
            PANOPTIC, rig, weights.matcher_from_tree(tree, mcfg, "cuda"),
            weights.lifter_from_tree(ltree, lcfg, "cuda"),
            slot_buckets=(4,), person_buckets=(8,), lifter_prior=prior)
        for f in frames[:cs.N_WARMUP]:
            pipe.infer_fused(f)
        per = [stage_times(pipe, f) for f in frames]
        stages = {k: statistics.median(p[k] for p in per) for k in per[0]}
        frame_ms = []
        for f in frames:
            t0 = time.perf_counter()
            pipe.infer_fused(f)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
        wall, dev, port, top = profile(pipe, frames)
        result[label] = {
            "frame_ms_median": statistics.median(frame_ms),
            "stage_ms_median": stages,
            "profiled_wall_ms": wall, "device_kernel_ms": dev,
            "device_busy_share": dev / wall if wall else None,
            "port_kernel_device_ms_per_frame": {
                k: v / len(frames) for k, v in port.items()},
            "top_kernels": [{"name": k[:80], "ms": ms, "count": n}
                            for ms, k, n in top]}
        print(f"{label}: frame {result[label]['frame_ms_median']:.3f} ms "
              f"(median of {len(frames)}); stages (synchronized) "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; profiled {len(frames)} frames: wall {wall:.1f} ms, "
              f"device {dev:.2f} ms (busy share {dev / wall:.3f}); device "
              f"ms a frame: " + ", ".join(
                  f"{k} {v / len(frames):.4f}" for k, v in port.items()),
              flush=True)
        for ms, k, n in top:
            print(f"    {ms:9.3f} ms  x{n:<6d} {k[:90]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "breakdown": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
