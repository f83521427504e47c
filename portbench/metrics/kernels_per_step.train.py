"""CUDA kernels the profiler saw in the traced stretch (copies and memsets
left out; the dev evaluations' in it) over the training steps in it."""


def read(ctx):
    n = ctx["tracer"].n_kernels()
    return n / ctx["steps"] if n and ctx["steps"] else None
