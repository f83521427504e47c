"""Time the GAT kernels, the lifter run and the decode + gather + pack
kernel of one checkout on the card.

* GAT (``--only gat``): the stack kernel (``gat_stack``) on the trained
  matcher at S=4 and S=16; the tiled kernels K1 and K2 at S=16 as their
  per-layer calls (``cuda_layer_calls``); the tiled stack as one call
  (``gat_stack_tiled``) at S=16, S=10 and on the ARPLAB-shaped 6 x 16
  topology (``arplab_tiled_inputs``); and the median ``infer_fused`` frame
  ms (host clock) of the frame path at S=4 (stack form) and S=16 (tiled
  form) on 16 frames each.  Under ``--root`` another checkout, it also
  prints whether that checkout's tiled logits at S=10 and S=16 are
  bit-equal to this file's own checkout's on the same frames (digests
  from ``--logits`` run in a second process).
* lifter (``--only lifter``): the int8 pairs ``models_demo/pan_irls`` and
  ``pan_compact`` (their 8 int8 layers alone, and the whole net) and the
  bf16 net of ``pan_irls_bf16``, at M=8 (the lifter rows of the S=4
  random-matcher frame) and M=16, through ``fused_mlp_forward``.
* decode (``--only decode``): ``frame_decode_pack`` at S=4 on the
  random-matcher frame for each prior at k_cap 64 and with no decode (the
  threshold at +inf: no pair is eligible, so no trip and no person: the
  fixed cost), and at S=16 on a frame scored by geometric consistency
  (``consistency_scores``) at k_cap 64 and k_cap = E.

Each item is call ms (CUDA events around the wrapper, its host work
included), device ms (torch.profiler, kernels and copies only) and CUDA
kernel launches a call, with the device ms by kernel name.

    python3 mpe3d_tpu_torch/tools/gat_timing.py [--root DIR] [--label L]
        [--only gat,lifter,decode] [--logits]

``--root`` is the checkout whose ``mpe3d_tpu_torch`` is imported and built
(default: the one that holds this file); run it on two checkouts in turns
(a, b, b, a) on one card, one run after another, to compare them.  The
inputs are the ones ``chip_smoke.py`` gives these kernels: the trained
matcher of ``models_demo/pan_irls_bf16`` and the demo lifters (read from
the checkout that holds this file, whatever ``--root``) on the synthetic
Panoptic ring rig, frame 0 of ``generate_frames(..., n_people=(2, 3),
seed=1)`` at S=4, of ``n_people=(6, 9), seed=3`` at S=10 and of
``n_people=(10, 14), seed=2`` at S=16 (all 16
frames for the frame times; the IRLS prior at S=4, "mean" at S=16 for the
GAT frames, the IRLS prior for the decode kernel at S=16), the numpy-seeded
random matcher (seed 0) for the S=4 decode and lifter inputs, the
pipeline's ``edge_const`` where the checkout's ``gat_stack`` takes it.
Prints the card's name and power limit, then one JSON line.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
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


def device_profile(fn, n: int = 20, tries: int = 5):
    """(device ms, CUDA kernel launches, device ms by kernel name) of one
    call of ``fn``, which launches at least one kernel a call.  The
    profiler records ``n`` calls after two unrecorded warm-up calls (a
    launch right after the profiler starts can be lost); a window that
    still recorded fewer kernels than calls is taken again after a pause,
    and after ``tries`` such windows the device time is not measured
    (NaN)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=2, active=n,
                                  repeat=1)) as prof:
            for _ in range(n + 2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        kernels = sum(ev.count for ev in evs
                      if not ev.key.startswith(("Memcpy", "Memset")))
        if kernels >= n:
            break
        time.sleep(0.5)
    else:
        return float("nan"), float("nan"), {}
    ms = sum(max(ev.device_time_total, ev.self_device_time_total)
             for ev in evs) / 1e3 / n
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


def crowded_decode_inputs(pipe, frame):
    """(args, kw) of ``frame_decode_pack`` on an S=16 frame scored by
    ``consistency_scores``, every eligible pair decoded (k_cap = E)."""
    import torch
    with torch.inference_mode():
        S, bufs = pipe._frame_tensors(frame)
        pmask = pipe._gat_inputs(S, *(a[None] for a in bufs))[1]
        scores = consistency_scores(pipe, S, bufs[0], bufs[3], pmask)
        args, kw = pipe._frame_decode_args(S, scores, pmask, *bufs[:4])
    kw["k_cap"] = scores.numel()
    return args, kw


def x16_rows(nets):
    """16 lifter rows from 8: the rows twice, each scaled by a numpy-seeded
    factor in [0.5, 1.5) (seed 16), as ``chip_smoke.py`` makes them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(16)
    return (nets.float().repeat(2, 1) * torch.tensor(
        rng.uniform(0.5, 1.5, (2 * nets.shape[0], 1)), dtype=torch.float32,
        device=nets.device)).contiguous()


def time_lifters(out, nets, lifters):
    """The lifter items (module header) into ``out``."""
    from mpe3d_tpu_torch.ops import fused_mlp
    for x in (nets.float().contiguous(), x16_rows(nets)):
        M = x.shape[0]
        for name, lifter in lifters.items():
            layers = lifter.packed_layers()
            slope, out_dim = lifter.cfg.negative_slope, lifter.cfg.out_dim
            out[f"{name}_net_M{M}"] = measure(
                lambda x=x, ls=layers: fused_mlp.fused_mlp_forward(
                    x, ls, slope, out_dim))
            if name != "pan_irls_bf16":
                body = layers[:-1]
                width = body[-1].b.shape[0]
                out[f"{name}_int8_layers_M{M}"] = measure(
                    lambda x=x, ls=body: fused_mlp.fused_mlp_forward(
                        x, ls, slope, width))


def time_decode(out, pipe4, frame4, pipe16, frame16):
    """The decode items (module header) into ``out``."""
    from mpe3d_tpu_torch.ops import frame_kernel as fk
    args, kw = pipe4.frame_stage_inputs(frame4)
    for prior in fk.PRIORS:
        for label, extra in (("k64", {}),
                             ("k0", {"threshold": float("inf")})):
            k = dict(kw, prior=prior, **extra)
            out[f"decode_S4_{prior}_{label}"] = measure(
                lambda k=k: fk.frame_decode_pack(*args, **k))
    cargs, ckw = crowded_decode_inputs(pipe16, frame16)
    E = ckw["k_cap"]
    for label, k_cap in (("k64", min(64, E)), (f"kE{E}", E)):
        k = dict(ckw, k_cap=k_cap)
        out[f"decode_S16_{ckw['prior']}_{label}"] = measure(
            lambda k=k: fk.frame_decode_pack(*cargs, **k))


def arplab_tiled_inputs(device, seed: int = 1):
    """(x, pw, topology, matcher) of an ARPLAB-shaped tiled GAT call: the
    6 x 16 topology (E=3840, head degree 80), numpy-seeded head features,
    the shared edge one-hot, 80 % live pairs and a random matcher of in_dim
    1082 (``weights.random_matcher_tree`` with the same seed)."""
    import numpy as np
    import torch
    from mpe3d_tpu_torch import weights
    from mpe3d_tpu_torch.config import MatcherConfig
    from mpe3d_tpu_torch.matching.features import (build_topology,
                                                   edge_node_features)
    from mpe3d_tpu_torch.models.gat import gat_topology
    cfg = MatcherConfig(in_dim=1082)
    m = weights.matcher_from_tree(weights.random_matcher_tree(cfg, seed),
                                  cfg, device)
    topo = build_topology(6, 16)
    rng = np.random.default_rng(seed)
    heads = torch.tensor(rng.normal(size=(topo.n_heads, 1082)),
                         dtype=torch.float32)
    x = torch.cat([heads, edge_node_features(topo.n_pairs, 1082)]).to(device)
    pw = torch.tensor(rng.random(topo.n_pairs) < 0.8,
                      dtype=torch.float32).to(device)
    return x, pw, gat_topology(topo, device, "tiled"), m


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tiled_logits(pipes, frames) -> dict:
    """{"S10", "S16": {"inputs": digest, "logits": digest}}: SHA-256 of
    the inputs (x, pw, e1, e2, weights) and of the logits ``gat_stack_tiled``
    gives for frame 0 of each crowded bucket (trained matcher)."""
    from mpe3d_tpu_torch.ops import gat_tiled
    out = {}
    for S in (10, 16):
        x, pw, gtopo, _ = pipes[S].gat_stage_inputs(frames[S][0])
        m = pipes[S].matcher
        logits = gat_tiled.gat_stack_tiled(
            x, pw, gtopo, m.flat, m.dims, m.cfg.alpha, m.cfg.hidden_slope,
            edge_const=True)
        out[f"S{S}"] = {"inputs": _digest(x, pw, gtopo.e1, gtopo.e2, m.flat),
                        "logits": _digest(logits)}
    return out


def time_gat(out, p4, p10, p16, frames4, frames10, frames16):
    """The GAT items (module header) into ``out``."""
    from mpe3d_tpu_torch.models.gat import gat_topology
    from mpe3d_tpu_torch.ops import gat_kernel, gat_tiled
    const = ({"edge_const": True} if "edge_const" in inspect.signature(
        gat_kernel.gat_stack).parameters else {})
    out["stack_edge_const"] = bool(const)
    frame4, frame16 = frames4[0], frames16[0]
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
    x10, pw10, topo10, _ = p10.gat_stage_inputs(frames10[0])
    tiled = {"S16": (x, pw, gtopo, m),
             "S10": (x10, pw10, topo10, p10.matcher),
             "arplab_6x16": arplab_tiled_inputs("cuda")}
    for name, (x_, pw_, topo_, m_) in tiled.items():
        out[f"gat_stack_tiled_{name}"] = measure(
            lambda a=(x_, pw_, topo_, m_.flat, m_.dims, m_.cfg.alpha,
                      m_.cfg.hidden_slope): gat_tiled.gat_stack_tiled(
                *a, edge_const=True))
    out["frame_ms_S4"] = frame_ms(p4, frames4)
    out["frame_ms_S16"] = frame_ms(p16, frames16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="gat,lifter,decode",
                    help="comma-separated items: gat, lifter, decode")
    ap.add_argument("--logits", action="store_true",
                    help="print only the digests of the tiled stack's S=10 "
                         "and S=16 inputs and logits (``tiled_logits``)")
    a = ap.parse_args()
    only = set(a.only.split(","))
    if not only <= {"gat", "lifter", "decode"}:
        ap.error(f"--only: unknown items {sorted(only)}")
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
    from mpe3d_tpu_torch.ops import _build
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _build.library()
    demos = os.path.join(REPO, "models_demo")
    rc = PANOPTIC
    rig = synthetic_ring_rig(rc)
    lcfg0 = LifterConfig(in_dim=rc.lifter_input_dim, out_dim=rc.n_joints * 3)
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(demos, "pan_irls_bf16", "skeleton_matching"),
        MatcherConfig(in_dim=rc.matcher_feature_dim))

    def lifter_tree(name):
        return load_lifter_checkpoint(
            os.path.join(demos, name, "pose_estimator"), lcfg0)

    ltree, lcfg, prior = lifter_tree("pan_irls_bf16")

    def pipeline(S, tree=mtree, lifter_prior=None):
        return PoseEstimationPipeline(
            rc, rig, weights.matcher_from_tree(tree, mcfg, "cuda"),
            weights.lifter_from_tree(ltree, lcfg, "cuda"), slot_buckets=(S,),
            person_buckets=(8 if S == 4 else 16,),
            lifter_prior=lifter_prior or (prior if S == 4 else "mean"),
            device="cuda")

    frames4 = [parse_frame(f, rc) for f in generate_frames(
        rc, rig, 16, n_people=(2, 3), seed=1)]
    frames16 = [parse_frame(f, rc, max_skeletons=16) for f in
                generate_frames(rc, rig, 16, n_people=(10, 14), seed=2)]
    frames10 = [parse_frame(f, rc) for f in generate_frames(
        rc, rig, 6, n_people=(6, 9), seed=3)]
    frame4, frame16 = frames4[0], frames16[0]
    if a.logits:
        print(json.dumps(tiled_logits({10: pipeline(10), 16: pipeline(16)},
                                      {10: frames10, 16: frames16})))
        return 0
    out = {"label": a.label, "root": root, "device": smi}
    if "lifter" in only or "decode" in only:
        p_random = pipeline(4, weights.random_matcher_tree(mcfg, 0))
    if "lifter" in only:
        # the bf16 net first: its time does not then follow the int8 nets'
        # (which differ between checkouts) in the same process
        lifters = {name: weights.lifter_from_tree(*lifter_tree(name)[:2],
                                                  "cuda")
                   for name in ("pan_irls_bf16", "pan_irls", "pan_compact")}
        time_lifters(out, p_random.stage_inputs(frame4)[3], lifters)
    if "decode" in only:
        time_decode(out, p_random, frame4, pipeline(16, lifter_prior=prior),
                    frame16)
    if "gat" in only:
        p10, p16 = pipeline(10), pipeline(16)
        time_gat(out, pipeline(4), p10, p16, frames4, frames10, frames16)
        if root != REPO:
            # the same logits from this file's own checkout, in a process
            # of its own (one package of each name a process)
            mine = tiled_logits({10: p10, 16: p16},
                                {10: frames10, 16: frames16})
            other = json.loads(subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--logits"],
                capture_output=True, text=True, check=True, cwd=REPO,
                timeout=900).stdout.strip().splitlines()[-1])
            out["tiled_logits_bit_equal"] = {
                S: {"inputs": mine[S]["inputs"] == other[S]["inputs"],
                    "logits": mine[S]["logits"] == other[S]["logits"]}
                for S in mine}
            print(f"tiled stack logits of {root} and {REPO} on the same "
                  f"frames: {out['tiled_logits_bit_equal']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
