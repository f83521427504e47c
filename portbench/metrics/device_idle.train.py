"""Share of the traced stretch in which no kernel, copy or memset ran on
the device, %."""

from portbench.layers import idle


def read(ctx):
    return idle(ctx)
