"""Host time a batch issuing the hand kernels: the program's
``chunk.gat`` (the matcher and its sigmoid), ``chunk.decode`` (the decode
kernel and its arguments) and ``chunk.lifter`` (the lifter run), summed
over the batch's chunks, mean over the traced stretch's ``batch.submit``
spans, ms."""

from portbench.program_trace import per_root_ms


def read(ctx):
    return per_root_ms(ctx, "batch.submit",
                       ("chunk.gat", "chunk.decode", "chunk.lifter"))
