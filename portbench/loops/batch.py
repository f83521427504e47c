"""Offline batch inference: whole batches of frames through
``PoseEstimationPipeline.submit_batch`` / ``collect_batch``, a closed loop
that keeps ``in_flight`` batches submitted (batch n+1 is submitted before
batch n is collected), cycling over a seeded pool of ``pool_batches``
batches.  A batch holds ``chunks`` times the frames of one union chunk
(at most ``chunk_heads`` heads and ``chunk_pairs`` pairs of the slot
bucket's graph).

``frames_per_s``: frames collected over the window's wall time (the
window runs ``seconds``, then the batches in flight are collected).
``batch_p95_ms``: the 95th percentile over every batch of the window of
the time from its ``submit_batch`` call to the return of its
``collect_batch``.

The comparison (``judge``), on ``check_batches`` of the window's batches
drawn from the seed, frame by frame against ``reference/pose.py``:
``score_gap`` the largest |score - reference score| over every pair;
``decode_miss`` the frames whose persons differ from the reference's
decode of the program's own scores; ``pose_gap`` the RMS of pose - reference pose
over every joint of every person, relative to the reference poses' RMS,
the reference lifting the program's persons from the frames' buffers (an
RMS, not a largest gap: a bf16 activation that lies on a rounding
boundary flips by one bf16 step (2^-8) on a change of summation order,
and the largest gap reads such flips); ``quality_gap`` the largest |quality - reference
quality of the program's poses| / max(1, |reference|).

A loop of another batch form hands ``setup`` its own ``Form`` (the
models, the program built on them, the reference's lifter stage) in
place of ``SEEDED``, and imports ``measure``, ``judge``,
``layer_context``, ``control`` and ``tiny`` unchanged."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench import frames as F
from portbench import program, weights
from portbench.loops import Measured
from portbench.reference import pose as R
from portbench.reference.geometry import torch_rig
from portbench.trace import Tracer, maybe


class FrameOut(NamedTuple):
    poses: np.ndarray      # [n, J, 3] metres
    persons: np.ndarray    # [n, C]
    scores: np.ndarray     # [E]
    quality: np.ndarray    # [n]


@dataclass
class State:
    cfg: dict
    traffic: dict
    device: torch.device
    rig: F.Rig
    pool: F.Frames
    batches: List[list]
    B: int
    S: int
    n_check: int          # batches the comparison samples
    mlayers: list
    llayers: Any          # as ``form.lift_ref`` reads them
    form: "Form"
    pipe: object = None


@dataclass
class Window:
    wall_s: float
    frames: int
    latencies_s: List[float]
    sample: List[Tuple[int, List[FrameOut]]]
    attempted: int
    failed: int
    traced: List[Tuple[int, List[FrameOut]]] = field(default_factory=list)
    traced_frames: int = 0
    submit_s: List[float] = field(default_factory=list)


def batch_size(cfg: dict, traffic: dict) -> int:
    C, S = len(cfg["cameras"]["names"]), traffic["slots"]
    H, E = C * S, C * (C - 1) // 2 * S * S
    return traffic["chunks"] * max(1, min(traffic["chunk_heads"] // H,
                                          traffic["chunk_pairs"] // E))


def p_max(cfg: dict, traffic: dict) -> int:
    C = len(cfg["cameras"]["names"])
    return min(traffic["person_buckets"][-1],
               max(C * traffic["slots"] // max(cfg["min_views"], 1), 1))


def seeded_models(cfg: dict, seed: int, dev) -> Tuple[list, list]:
    """The seeded matcher (fp32) and lifter (bf16) weights."""
    return (weights.matcher_layers(cfg["matcher"], seed, dev),
            weights.lifter_layers(cfg["lifter"], seed, dev, torch.bfloat16))


def seeded_pipeline(st: State):
    """The program's pipeline on the seeded weights."""
    return program.pipeline(st.cfg, st.traffic, st.rig, st.mlayers,
                            st.llayers, st.device)


def lift_mean_prior(st: State, g, trig, size, precision: str
                    ) -> torch.Tensor:
    """The reference's lifter stage on gathered persons ``g``: their rows
    packed with the "mean" prior, the lifter, poses [n, J, 3] metres."""
    net = R.lifter_input(*g, trig, size)
    return (R.lift(net, st.llayers, st.cfg["lifter"]["negative_slope"],
                   precision)[:, :st.cfg["lifter"]["out_dim"]]
            .reshape(len(net), -1, 3) * 10.0)


class Form(NamedTuple):
    """What a batch form is made of: ``models(cfg, seed, device)``, the
    matcher's and the lifter's weights that set-up makes, as the
    reference reads them; ``build(state)``, the program on them;
    ``lift_ref(state, persons, rig, size, precision)``, the reference's
    lifter stage (the gathered persons packed with their prior into the
    lifter's input, and the lifter on it)."""
    models: Callable
    build: Callable
    lift_ref: Callable


SEEDED = Form(seeded_models, seeded_pipeline, lift_mean_prior)


def state(cell, seed: int, device, B: int, n_batches: int, n_check: int,
          form: Form = SEEDED) -> State:
    """The seeded rig, a pool of ``n_batches`` batches of ``B`` frames and
    the models; no program yet."""
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    rig = F.ring_rig(cfg)
    S = tr["slots"]
    pool = F.generate(cfg, rig, n_batches * B, tuple(tr["people"]), S, seed,
                      tr["spread_m"])
    return State(cfg, tr, dev, rig, pool, [], B, S, n_check,
                 *form.models(cfg, seed, dev), form)


def setup(cell, seed: int, device, build_program: bool = True,
          form: Form = SEEDED) -> State:
    tr = cell.traffic
    st = state(cell, seed, device, batch_size(cell.config, tr),
               tr["pool_batches"], tr["check_batches"], form)
    if build_program:
        program.check_rig(cell.config)
        st.pipe = form.build(st)
        fl = program.frame_list(st.pool)
        B, S = st.B, st.S
        st.batches = [fl[i * B:(i + 1) * B] for i in range(tr["pool_batches"])]
        for _ in range(2):          # every shape, twice: plans and buffers
            tickets = [st.pipe.submit_batch(b, slots=S) for b in st.batches]
            for t in tickets:
                st.pipe.collect_batch(t)
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)
    return st


def _outs(res) -> List[FrameOut]:
    return [FrameOut(o.poses, o.persons, o.scores, o.quality) for o in res]


def window(st: State, seconds: float, seed: int,
           tracer: Optional[Tracer] = None, trace_at: float = 0.0,
           trace_s: float = 0.0) -> Window:
    pipe, S, B = st.pipe, st.S, st.B
    n_keep = st.n_check
    rng = np.random.default_rng([seed % 2 ** 63, 17])
    q: deque = deque()
    lat, sample, traced, submit_s = [], [], [], []
    k = done = frames = failed = traced_frames = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if tracer is not None:
            if tracer.prof is None and now >= t0 + trace_at:
                tracer.start()
            elif tracer.active and now >= tracer.t0 + trace_s:
                tracer.stop()
        if now >= t_end and not q:
            break
        while now < t_end and len(q) < st.traffic["in_flight"]:
            b = k % len(st.batches)
            on = tracer is not None and tracer.active
            ts = time.perf_counter()
            with maybe(tracer, "submit"):
                ticket = pipe.submit_batch(st.batches[b], slots=S)
            if on:
                submit_s.append(time.perf_counter() - ts)
                traced_frames += B
            q.append((ts, b, ticket, on))
            k += 1
        ts, b, ticket, on = q.popleft()
        with maybe(tracer, "collect"):
            res = pipe.collect_batch(ticket)
        lat.append(time.perf_counter() - ts)
        if len(res) != B:
            failed += B - len(res)
        frames += len(res)
        outs = _outs(res)
        if on:
            traced.append((b, outs))
        if done < n_keep:
            sample.append((b, outs))
        else:
            j = int(rng.integers(0, done + 1))
            if j < n_keep:
                sample[j] = (b, outs)
        done += 1
    wall = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        tracer.stop()
    return Window(wall, frames, lat, sample, done * B, failed, traced,
                  traced_frames, submit_s)


def end_to_end(win: Window) -> Dict[str, float]:
    return {"frames_per_s": win.frames / win.wall_s,
            "batch_p95_ms": 1e3 * float(np.percentile(win.latencies_s, 95))}


def measure(st: State, seconds: float, seed: int,
            tracer: Optional[Tracer] = None, trace_at: float = 0.0,
            trace_s: float = 0.0, window: Callable = window,
            end_to_end: Callable = end_to_end) -> Measured:
    """The window (another loop of this state hands its own ``window``
    and ``end_to_end``); the comparison reads its sampled batches."""
    at = time.time()
    win = window(st, seconds, seed, tracer, trace_at, trace_s)
    return Measured(end_to_end(win), at, win.attempted, win.failed,
                    win.sample, win)


def _frame_tensors(fr: F.Frames, i: int, dev):
    return tuple(torch.as_tensor(a[i], device=dev) for a in fr)


def reference_outputs(st: State, idx, precision: str) -> List[FrameOut]:
    """The reference in the program's place (the control, in the
    "control" precision): each frame's scores, decode, poses, quality."""
    cfg, dev = st.cfg, st.device
    topo = R.topology(len(cfg["cameras"]["names"]), st.S)
    trig = torch_rig(st.rig, dev)
    size = (cfg["image_width"], cfg["image_height"])
    out = []
    for i in idx:
        fr = _frame_tensors(st.pool, i, dev)
        s = R.frame_scores(fr, topo, st.mlayers, cfg["matcher"], trig, size,
                           precision).cpu().numpy()
        persons = R.decode(s, st.pool.present[i], topo,
                           cfg["serve"]["threshold"],
                           cfg["serve"]["decode_top_k"], cfg["min_views"],
                           p_max(cfg, st.traffic))
        g = R.gather(persons, fr)
        poses = st.form.lift_ref(st, g, trig, size, precision)
        q = R.quality(poses, g[0], g[1], g[3], trig, precision)
        out.append(FrameOut(poses.cpu().numpy(), persons.astype(np.int32), s,
                            q.cpu().numpy()))
    return out


def judge(st: State, sample: List[Tuple[int, List[FrameOut]]]
          ) -> Dict[str, float]:
    """The four numbers of the comparison (module header) over the
    sampled batches: ``sample`` holds (pool batch, its outputs)."""
    cfg, dev = st.cfg, st.device
    topo = R.topology(len(cfg["cameras"]["names"]), st.S)
    trig = torch_rig(st.rig, dev)
    size = (cfg["image_width"], cfg["image_height"])
    score_gap, miss, q_gap = 0.0, 0, 0.0
    pose_err, pose_sq = 0.0, 0.0
    for b, outs in sample:
        if len(outs) != st.B:
            miss += st.B - len(outs)
        rows, got_poses, got_q = [], [], []
        for j, o in enumerate(outs):
            i = b * st.B + j
            fr = _frame_tensors(st.pool, i, dev)
            s = R.frame_scores(fr, topo, st.mlayers, cfg["matcher"], trig,
                               size, "fp32").cpu().numpy()
            score_gap = max(score_gap, float(np.max(np.abs(o.scores - s))))
            want = R.decode(o.scores, st.pool.present[i], topo,
                            cfg["serve"]["threshold"],
                            cfg["serve"]["decode_top_k"], cfg["min_views"],
                            p_max(cfg, st.traffic))
            if want.shape != o.persons.shape or np.any(want != o.persons):
                miss += 1
            if len(o.persons):
                rows.append(R.gather(o.persons, fr))
                got_poses.append(o.poses)
                got_q.append(o.quality)
        if not rows:
            continue
        g = tuple(torch.cat(parts) for parts in zip(*rows))
        ref = st.form.lift_ref(st, g, trig, size, "fp32")
        got = torch.as_tensor(np.concatenate(got_poses), device=dev)
        pose_err += float(((got - ref) ** 2).sum())
        pose_sq += float((ref * ref).sum())
        qr = R.quality(got, g[0], g[1], g[3], trig)
        qg = torch.as_tensor(np.concatenate(got_q), device=dev)
        q_gap = max(q_gap, float(((qg - qr).abs()
                                  / torch.clamp(qr.abs(), min=1.0)).max()))
    return {"score_gap": score_gap, "decode_miss": float(miss),
            "pose_gap": ((pose_err / pose_sq) ** 0.5 if pose_sq > 0
                         else float("inf")),
            "quality_gap": q_gap}


def control(st: State, seed: int) -> Dict[str, float]:
    """The comparison of the reference in the "control" precision, put in
    the program's place on as many batches as a run compares."""
    rng = np.random.default_rng([seed % 2 ** 63, 17])
    picks = rng.choice(len(st.pool) // st.B, size=min(
        st.n_check, len(st.pool) // st.B), replace=False)
    sample = [(int(b), reference_outputs(
        st, range(int(b) * st.B, (int(b) + 1) * st.B), "control"))
        for b in picks]
    return judge(st, sample)


def layer_context(st: State, m: Measured, tracer: Tracer) -> dict:
    """What the per-layer readers of a batch cell read: the traced
    batches' present skeletons, candidate trips and decoded persons."""
    win = m.window
    topo = R.topology(len(st.cfg["cameras"]["names"]), st.S)
    thr, top_k = st.cfg["serve"]["threshold"], st.cfg["serve"]["decode_top_k"]
    present, live, persons = [], [], []
    for b, outs in win.traced:
        for j, o in enumerate(outs):
            p = st.pool.present[b * st.B + j]
            pf = p.reshape(-1)
            pm = pf[topo.e1] & pf[topo.e2]
            present.append(p)
            live.append(min(int(np.sum(pm & (o.scores > thr))), top_k))
            persons.append(len(o.persons))
    return {"kind": "batch", "config": st.cfg, "traffic": st.traffic,
            "tracer": tracer, "frames": win.traced_frames,
            "batch_frames": st.B, "submit_s": win.submit_s,
            "present": np.asarray(present, bool).reshape(
                -1, len(st.cfg["cameras"]["names"]), st.S),
            "live": np.asarray(live, float),
            "persons": np.asarray(persons, float)}


def tiny(cfg: dict, tr: dict) -> None:
    """Rehearsal size: a batch of one union of at most two frames, two
    pool batches, one compared."""
    C = len(cfg["cameras"]["names"])
    tr.update(chunks=1, chunk_heads=2 * C * tr["slots"], pool_batches=2,
              check_batches=1)
