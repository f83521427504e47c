"""The GAT matcher's share of its roofline, %: the frozen count's bound
(fp32 peak; the fp64 tensor cores' published peak is the same) over the
device time of the GAT's kernels (stack form: the fp64 GEMM and
``stack_out``; tiled form: the GEMM, ``attn_terms``, ``k1_edges``,
``tiled_incidence``, ``k2_heads``)."""

from portbench.layers import roofline
from portbench.peaks import FP32_FLOPS

KERNELS = ("f64_gemm_kernel", "stack_out", "attn_terms", "k1_edges",
           "tiled_incidence", "k2_heads")


def read(ctx):
    return roofline(ctx, "gat", KERNELS, FP32_FLOPS)
