"""Host time of a training step's ``train.grad`` (the program's span
over the forward, the loss and the issue of ``autograd.grad``), mean
over the traced stretch's steps, ms."""

from portbench.program_trace import per_span_ms


def read(ctx):
    return per_span_ms(ctx, "train.grad")
