"""Host time of a ``submit_batch`` call (the benchmark's clock around
each call in the traced stretch), mean, ms: the pipeline's host work a
batch, which the device waits on when it exceeds the device work."""


def read(ctx):
    s = ctx.get("submit_s") or []
    return 1e3 * sum(s) / len(s) if s else None
