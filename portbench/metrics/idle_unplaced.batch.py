"""Share of the traced stretch's device idle time during which the host
was in no span of the program (the benchmark's own loop between calls,
or work the program's spans leave out), %."""

from portbench.program_trace import idle_unplaced_share


def read(ctx):
    return idle_unplaced_share(ctx)
