"""Host time of a ``submit_fused`` call: the program's ``frame.submit``
span (the frame's pack and upload, every stage's launches and the start
of the download), whole, mean over the traced stretch's frames, ms."""

from portbench.program_trace import root_ms


def read(ctx):
    return root_ms(ctx, "frame.submit")
