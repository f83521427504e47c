"""The lifter's share of its roofline, %: the frozen count's bound (bf16
peak, HBM bandwidth, weights read once a batch) over the device time of
``mlp_run_kernel``."""

from portbench.layers import roofline
from portbench.peaks import BF16_FLOPS

KERNELS = ("mlp_run_kernel",)


def read(ctx):
    return roofline(ctx, "lifter", KERNELS, BF16_FLOPS)
