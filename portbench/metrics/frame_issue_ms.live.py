"""Host time of a ``submit_fused`` call issuing the frame's five stages:
the program's ``chunk.features``, ``chunk.gat``, ``chunk.decode``,
``chunk.lifter`` and ``chunk.quality`` spans (eager launches and their
arguments), mean over the traced stretch's ``frame.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "frame.submit",
                       ("chunk.features", "chunk.gat", "chunk.decode",
                        "chunk.lifter", "chunk.quality"))
