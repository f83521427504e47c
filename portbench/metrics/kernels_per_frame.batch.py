"""CUDA kernels the profiler saw in the traced stretch (copies and memsets
left out) over the frames submitted in it: the launches a frame pays."""


def read(ctx):
    n = ctx["tracer"].n_kernels()
    return n / ctx["frames"] if n and ctx["frames"] else None
