"""Share of the traced stretch's batches whose body ran as a replay of a
captured CUDA graph (the program's ``batch.replay`` counter over the
stretch's ``batch.submit`` spans), %."""

from portbench.program_trace import count, n_roots


def read(ctx):
    replays, submits = count(ctx, "batch.replay"), n_roots(ctx, "batch.submit")
    if replays is None or not submits:
        return None
    return 100.0 * replays / submits
