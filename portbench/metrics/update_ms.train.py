"""Host time of a training step's ``train.update`` (the program's span
over the gradients' all-reduce if any, the clip, Adam and the EMA), mean
over the traced stretch's steps, ms."""

from portbench.program_trace import per_span_ms


def read(ctx):
    return per_span_ms(ctx, "train.update")
