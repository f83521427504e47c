"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit)."""

FP32_FLOPS = 67e12          # fp32 outside the tensor cores; fp64 tensor cores
BF16_FLOPS = 989e12         # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def bound_s(ops: float, bytes_: float, peak_flops: float) -> float:
    """The least time the work can take: the larger of its operations at
    their peak and its bytes at the memory's."""
    return max(ops / peak_flops, bytes_ / HBM_BYTES_PER_S)
