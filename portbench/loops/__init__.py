"""One general loop a traffic kind, ``loops/<kind>.py``, which carries
the whole of a run of its cells.  ``run.py`` calls the same functions on
every loop:

* ``setup(cell, seed, device, build_program=True)``: the state, built
  from the seed, with every shape the traffic uses warmed up (without
  ``build_program`` the inputs and weights alone, for the control);
* ``measure(st, seconds, seed, tracer, trace_at, trace_s)``: the window,
  returning ``Measured``;
* ``judge(st, got)``: the comparison's numbers for ``Measured.got``;
* ``layer_context(st, measured, tracer)``: what the per-layer readers
  read after a traced run;
* ``control(st, seed)``: the comparison's numbers with the reference in a
  lower precision in the program's place;
* ``tiny(cfg, traffic)``: shrinks copies of the configuration and the mix
  to rehearsal size (``--cpu``), in place.

A loop may also define ``FAULTS``: named functions of the state that
return the comparison's numbers with a fault planted in the reference put
in the program's place (``python3 -m portbench.readings
--fault-seeds``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class Measured:
    end_to_end: Dict[str, float]   # the cell's end-to-end numbers, set-up's aside
    window_at: float               # time.time() when the window opened
    attempted: int
    failed: int
    got: Any                       # what ``judge`` reads
    window: Any = None             # what ``layer_context`` reads
