"""Host time of a ``submit_fused`` call in ``frame.pack`` (the program's
span over the frame's buffers put on the device), mean over the traced
stretch's ``frame.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "frame.submit", ("frame.pack",))
