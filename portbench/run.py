"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the cell's seeded inputs and weights, the program and every shape
the cell's traffic uses) runs from process start; then the window runs
``--seconds``; then the comparison with the reference.  With ``--trace
0`` the result holds the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, read from a profiled steady stretch of the window.
The last line of standard output is one JSON object; the numbers
compared, each with its limit, are the last lines of standard error and
the last key of that object.

``--cpu`` rehearses on the CPU (the program's plain versions) and is for
checking the harness, never for a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from portbench.cell import HERE, Cell, load, manifest, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "mpe3d_tpu")
TRACE_AT = 0.25          # the traced stretch starts this share into the window
TRACE_MAX_S = 3.0        # ... and lasts at most this long, or half the window


def process_start() -> float:
    """time.time() at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def cache_dirs() -> None:
    """Build and kernel caches of the program inside the checkout, at fixed
    paths."""
    base = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(dev) -> Dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, fault=None) -> Dict:
    """One run of ``cell``; returns the result object.  ``fault`` (tests):
    called with the built state before the window, to break the program
    under it."""
    import numpy as np
    import torch
    from portbench.trace import Tracer
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    drv = cell.loop
    tracer = Tracer(dev) if trace else None
    trace_s = min(TRACE_MAX_S, 0.5 * seconds)
    st = drv.setup(cell, seed, dev)
    if tracer is not None:
        tracer.warm()
    if fault is not None:
        fault(st)
    m = drv.measure(st, seconds, seed, tracer, TRACE_AT * seconds, trace_s)
    setup_s = m.window_at - t_start
    e2e = dict(m.end_to_end)
    attempted, failed = m.attempted, m.failed
    info = device_info(dev)
    checks = drv.judge(st, m.got)
    ctx = drv.layer_context(st, m, tracer) if trace else None
    limits = cell.limits
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = failed == 0 and all(np.isfinite(v) and v <= limits[k]
                                  for k, v in checks.items())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed)}
    metrics = {}
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"trace: the profiler took {tracer.start_s:.3f} s to start; "
              f"stretch {tracer.window_s:.3f} s; {len(tracer.kernels)} "
              f"device events, {len(tracer.host_spans)} host spans, "
              f"{len(tracer.spans)} placed", file=sys.stderr)
        info["busy_s"] = tracer.busy_s
        info["window_s"] = tracer.window_s
        out["breakdown"] = tracer.breakdown()
    out["metrics"] = metrics
    out["device"] = info
    out["checks"] = compared
    return out


def tiny(cell: Cell) -> Cell:
    """The cell at rehearsal size (``--cpu``), as its loop's ``tiny``
    shrinks copies of its configuration and mix."""
    tr = dict(cell.traffic)
    cfg = json.loads(json.dumps(cell.config))
    cell.loop.tiny(cfg, tr)
    cell.traffic, cell.config = tr, cfg
    return cell


def main(argv: Optional[List[str]] = None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (no measurement)")
    args = ap.parse_args(argv)
    cache_dirs()
    cell = load(args.workload, manifest())
    import torch
    if not args.cpu:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    if args.cpu:
        cell = tiny(cell)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cpu" if args.cpu else "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
