"""Host time a batch in ``chunk.features`` (the program's span over the
matcher's inputs: head features, pair mask, concatenation, the union
topology), summed over the batch's chunks, mean over the traced
stretch's ``batch.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "batch.submit", ("chunk.features",))
