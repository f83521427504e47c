"""Decoded persons of the traced batches over the rows the lifter got
in the stretch (the program's ``lifter.rows`` counter: every person slot,
live or empty), %."""

from portbench.program_trace import count


def read(ctx):
    rows = count(ctx, "lifter.rows")
    if not rows:
        return None
    return 100.0 * float(ctx["persons"].sum()) / rows
