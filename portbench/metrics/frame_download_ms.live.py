"""Host time of a ``submit_fused`` call in ``frame.download`` (the
program's span over the outputs' pinned download and its event), mean
over the traced stretch's ``frame.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "frame.submit", ("frame.download",))
