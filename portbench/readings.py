"""The readings that the comparison limits are set from: the program's
numbers over many seeds (short windows at the cell's own load) and the
control's (the reference in the next precision down, in the program's
place) over a few, in one process so that set-up is paid once a seed.

    python3 -m portbench.readings --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]
        [--out FILE] [--cpu]

Each reading is a JSON line: {"seed", "side": "program", "control" or the
name of a fault the cell's loop plants (its ``FAULTS``), "checks": {...}};
the lines go to standard output and, with ``--out``, to a file.  Not run
by the benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.cell import load, manifest
from portbench.run import cache_dirs, run_cell, tiny


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="each fault the loop defines (FAULTS), planted in "
                         "the reference put in the program's place")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cache_dirs()
    cell = load(args.workload, manifest())
    if args.cpu:
        cell = tiny(cell)
    device = "cpu" if args.cpu else "cuda"
    import torch
    drv = cell.loop
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.time()
        out = run_cell(cell, s, args.seconds, False, device, time.time())
        emit({"seed": s, "side": "program", "correct": out["correct"],
              "checks": {k: v["value"] for k, v in out["checks"].items()},
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "seconds": time.time() - t})
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.time()
        st = drv.setup(cell, s, torch.device(device), build_program=False)
        emit({"seed": s, "side": "control", "checks": drv.control(st, s),
              "seconds": time.time() - t})
    for s in [int(x) for x in args.fault_seeds.split(",") if x]:
        for name, fault in getattr(drv, "FAULTS", {}).items():
            t = time.time()
            st = drv.setup(cell, s, torch.device(device), build_program=False)
            emit({"seed": s, "side": name, "checks": fault(st),
                  "seconds": time.time() - t})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
