"""Rows the lifter's run kernel serves a launch in the traced stretch (the
program's ``lifter.rows`` counter over its ``lifter.launches`` counter):
the batch path's chunk of frames times person slots where a chunk is one
launch, 64 or fewer where it is cut into 64-row groups."""

from portbench.program_trace import count


def read(ctx):
    rows, launches = count(ctx, "lifter.rows"), count(ctx, "lifter.launches")
    if not rows or not launches:
        return None
    return rows / launches
