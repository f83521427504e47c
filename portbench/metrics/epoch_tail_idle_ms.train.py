"""Device idle time an epoch at its tail: the traced stretch's idle time
during which the host was in the program's ``train.readback`` (the epoch
loss to the host), ``train.eval`` (the dev evaluation) or
``train.select`` (the best copy, the checkpoint and host copies), over
the stretch's ``train.epoch`` spans, ms."""

from portbench.program_trace import idle_in, n_roots

TAIL = ("train.readback", "train.eval", "train.select")


def read(ctx):
    n = n_roots(ctx, "train.epoch")
    t = idle_in(ctx, TAIL)
    return 1e3 * t / n if t is not None and n else None
