"""Host time of a ``collect_fused`` call: the program's ``frame.collect``
span (the wait on the device and the download, then the crop to the
frame's persons), whole, mean over the traced stretch's frames, ms."""

from portbench.program_trace import root_ms


def read(ctx):
    return root_ms(ctx, "frame.collect")
