"""Host time a batch in ``batch.pack`` (the program's span over
stacking and padding the frames' five buffers, the pinned staging copy
and the upload's enqueue), mean over the traced stretch's
``batch.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "batch.submit", ("batch.pack",))
