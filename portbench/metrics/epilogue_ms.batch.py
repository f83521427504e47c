"""Host time a batch in the epilogue: the program's ``chunk.quality``
(the quality column, the person mask, the output views) of each chunk and
its ``batch.download`` (the outputs' concatenation and the pinned
download), mean over the traced stretch's ``batch.submit`` spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "batch.submit",
                       ("chunk.quality", "batch.download"))
