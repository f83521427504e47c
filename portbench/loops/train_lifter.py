"""Label-free lifter training: the program's ``train_lifter`` at the
configuration's training settings on a packed dataset of
``train_batches`` full batches (and ``dev_batches`` of dev rows), from
seeded fp32 weights made on the device.

One call of ``train_lifter`` is both the set-up and the window.  Its
``stop_flag`` (asked at the start of every epoch) marks them: epoch 0
(the first steps and the first dev evaluation) is set-up, the window
opens when epoch 1 is asked for and closes at the first epoch boundary
after ``seconds``; each boundary follows the epoch's loss read-back, so
the device has finished the epoch.  ``samples_per_s``: training rows
stepped in the window's epochs over its wall time, the dev evaluations
(every ``eval_every`` epochs) in it.

During epoch 0 a forward hook on the program's lifter module captures,
from the same object the window then trains, the gradient of step 1 as
the optimizer gets it (hooks on its parameters) and the parameters as
step ``follow_steps`` + 1 reads them; epoch 0's mean training loss comes
from the run's history.  The comparison (``judge``) follows the same
batches with ``reference/lifter_train.py``: ``loss_gap`` the relative gap
of epoch 0's mean loss, ``grad_gap`` the worst leaf's gap between the two
norms of the step-1 gradient, ``update_gap`` the same of the parameters'
change after ``follow_steps`` steps (leaves whose reference gradient is
under a thousandth of the median leaf's left out), each relative to the
larger of that leaf's reference norm and the median leaf's."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import frames as F
from portbench import lifter_data, program, weights
from portbench.loops import Measured
from portbench.reference import lifter_train as RT
from portbench.reference.geometry import torch_rig
from portbench.trace import Tracer


@dataclass
class State:
    cfg: dict
    traffic: dict
    device: torch.device
    rig: F.Rig
    data: Dict[str, np.ndarray]
    layers: list
    batch_size: int
    seconds: float = 0.0
    tracer: Optional[Tracer] = None
    trace_at: float = 0.0
    trace_s: float = 0.0
    captured: dict = field(default_factory=dict)
    marks: dict = field(default_factory=dict)
    result: object = None
    rows_per_epoch: int = 0
    traced_epochs: int = 0


def setup(cell, seed: int, device, build_program: bool = True) -> State:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    rig = F.ring_rig(cfg)
    bs = cfg["train"]["batch_size"]
    data = lifter_data.dataset(cfg, rig, tr, bs, seed, dev)
    st = State(cfg, tr, dev, rig, data,
               weights.lifter_layers(cfg["lifter"], seed, dev, torch.float32),
               bs)
    st.rows_per_epoch = tr["train_batches"] * bs
    if build_program:
        program.check_rig(cfg)
    return st


def _hook(st: State):
    """A global forward hook that captures step 1's gradients and the
    parameters after ``follow_steps`` steps of the first lifter module
    trained."""
    cap = st.captured
    k_keep = st.traffic["follow_steps"] + 1

    def hook(module, inputs, output):
        if type(module).__name__ != "TrainableLifter" or not output.requires_grad:
            return
        cap.setdefault("module", module)
        if module is not cap["module"]:
            return
        cap["calls"] = cap.get("calls", 0) + 1
        params = module.layer_params()
        if cap["calls"] == 1:
            cap["grads"] = [None] * len(params)

            def grab(i):
                def f(g):
                    cap["grads"][i] = g.detach().clone()
                return f
            cap["handles"] = [p.register_hook(grab(i))
                              for i, p in enumerate(params)]
        elif cap["calls"] == 2:
            for h in cap.pop("handles"):
                h.remove()
        if cap["calls"] == k_keep:
            cap["params"] = [p.detach().clone() for p in params]
    return torch.nn.modules.module.register_module_forward_hook(hook)


def run(st: State, seconds: float, tracer: Optional[Tracer] = None,
        trace_at: float = 0.0, trace_s: float = 0.0) -> None:
    """Set-up's epoch 0 and the window, in one ``train_lifter`` call;
    ``st.marks`` gets the window's start and end and its epochs."""
    marks = st.marks
    handle = _hook(st)
    epoch_span = [None]

    def close_span():
        if epoch_span[0] is not None:
            epoch_span[0].__exit__(None, None, None)
            epoch_span[0] = None

    def stop_flag() -> bool:
        e = marks.get("asked", 0)
        marks["asked"] = e + 1
        now = time.perf_counter()
        close_span()
        if e == 0:
            return False
        if e == 1:
            handle.remove()
            marks["t0"] = now
        t0 = marks["t0"]
        if tracer is not None:
            if tracer.prof is None and now >= t0 + trace_at:
                tracer.start()
                marks["trace_e0"] = e
            elif tracer.active and now >= tracer.t0 + trace_s:
                tracer.stop()
                st.traced_epochs = e - marks["trace_e0"]
        if now - t0 >= seconds:
            marks["t1"], marks["epochs"] = now, e - 1
            if tracer is not None and tracer.active:
                tracer.stop()
                st.traced_epochs = e - marks["trace_e0"]
            return True
        if tracer is not None and tracer.active:
            epoch_span[0] = tracer.span("epoch")
            epoch_span[0].__enter__()
        return False

    try:
        st.result = program.train_lifter(st.cfg, st.rig, st.data, st.layers,
                                         stop_flag, st.device, st.batch_size)
    finally:
        handle.remove()
        close_span()
    if "t1" not in marks:
        raise RuntimeError("training ended before the window closed (early "
                           "stopping or too few epochs)")


def end_to_end(st: State) -> Dict[str, float]:
    m = st.marks
    return {"samples_per_s": m["epochs"] * st.rows_per_epoch
            / (m["t1"] - m["t0"])}


def measure(st: State, seconds: float, seed: int,
            tracer: Optional[Tracer] = None, trace_at: float = 0.0,
            trace_s: float = 0.0) -> Measured:
    """Set-up's epoch 0 and the window (``run``); the comparison reads the
    captured gradient and parameters and epoch 0's loss."""
    run(st, seconds, tracer, trace_at, trace_s)
    at = st.marks["t0"] - time.perf_counter() + time.time()
    return Measured(end_to_end(st), at,
                    st.marks["epochs"] * st.traffic["train_batches"], 0,
                    program_readings(st))


def _batches(st: State, n_rows: int) -> torch.Tensor:
    """The first epoch's batches as the trainer draws them: a permutation
    from a generator on the device seeded ``seed + 1``, cut into full
    batches."""
    g = torch.Generator(device=st.device)
    g.manual_seed(st.cfg["train"]["seed"] + 1)
    k = n_rows // st.batch_size
    perm = torch.randperm(n_rows, generator=g, device=st.device)
    return perm[:k * st.batch_size].view(k, st.batch_size)


def _leaf_gap(got: List[torch.Tensor], ref: List[torch.Tensor],
              use: Optional[List[bool]] = None) -> float:
    gn = [float(torch.linalg.norm(g.float())) for g in got]
    rn = [float(torch.linalg.norm(r.float())) for r in ref]
    med = float(np.median(rn))
    return max(abs(a - b) / max(b, med, 1e-30)
               for i, (a, b) in enumerate(zip(gn, rn))
               if use is None or use[i])


def follow(st: State, precision: str, half: bool = False) -> Dict:
    dev = st.device
    net = torch.as_tensor(st.data["net_train"], device=dev)
    err = torch.as_tensor(st.data["err_train"], device=dev)
    return RT.follow([t for p in st.layers for t in (p["b"], p["w"])], net,
                     err, _batches(st, len(net)), torch_rig(st.rig, dev),
                     st.cfg["train"], st.cfg["n_joints"],
                     st.cfg["lifter"]["negative_slope"],
                     st.traffic["follow_steps"], precision, half)


def judge(st: State, got: Dict, ref: Optional[Dict] = None) -> Dict[str, float]:
    """The comparison's numbers for ``got`` (the program's readings, or the
    control's): ``loss`` epoch 0's mean loss, ``grads`` step 1's gradient,
    ``params`` the parameters after ``follow_steps`` steps.  The program's
    trained state is freed first, so that the reference fits beside it."""
    st.result = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ref or follow(st, "fp32")
    init = [t for p in st.layers for t in (p["b"], p["w"])]
    gref = [float(torch.linalg.norm(g)) for g in ref["grads"]]
    med = float(np.median(gref))
    use = [g >= 1e-3 * med for g in gref]
    l_ref = float(np.mean(ref["losses"]))
    if got.get("grads") is None or any(g is None for g in got["grads"]) \
            or got.get("params") is None:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "update_gap": float("inf")}
    return {"loss_gap": abs(got["loss"] - l_ref) / abs(l_ref),
            "grad_gap": _leaf_gap(got["grads"], ref["grads"]),
            "update_gap": _leaf_gap([p - i for p, i in zip(got["params"], init)],
                                    [p - i for p, i in zip(ref["params"], init)],
                                    use)}


def program_readings(st: State) -> Dict:
    cap = st.captured
    return {"loss": float(st.result.history[0]["train_loss"]),
            "grads": cap.get("grads"), "params": cap.get("params")}


def control_readings(st: State, half: bool = False) -> Dict:
    """The control's readings (the reference in TF32 in the program's
    place); with ``half`` the fp32 reference with half of each batch left
    out instead (a planted fault)."""
    c = follow(st, "fp32", True) if half else follow(st, "control")
    return {"loss": float(np.mean(c["losses"])), "grads": c["grads"],
            "params": c["params"]}


def control(st: State, seed: int) -> Dict[str, float]:
    return judge(st, control_readings(st))


FAULTS = {"fault_half_batch":
          lambda st: judge(st, control_readings(st, half=True))}


def layer_context(st: State, m: Measured, tracer: Tracer) -> dict:
    steps = st.traced_epochs * st.traffic["train_batches"]
    return {"kind": "train_lifter", "config": st.cfg, "traffic": st.traffic,
            "tracer": tracer, "steps": steps, "rows": st.batch_size}


def tiny(cfg: dict, tr: dict) -> None:
    """Rehearsal size: 64-row batches of a two-layer 64-wide lifter."""
    cfg["lifter"]["widths"] = [64, 64]
    cfg["train"]["batch_size"] = 64
    tr["train_batches"] = max(tr["follow_steps"] + 1, 4)
