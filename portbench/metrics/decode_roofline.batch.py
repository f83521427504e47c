"""Decode + gather + pack's share of its roofline, %: the frozen count's
bound (fp32 peak, HBM bandwidth) over the device time of
``frame_decode_pack_kernel``."""

from portbench.layers import roofline
from portbench.peaks import FP32_FLOPS

KERNELS = ("frame_decode_pack_kernel",)


def read(ctx):
    return roofline(ctx, "decode", KERNELS, FP32_FLOPS)
