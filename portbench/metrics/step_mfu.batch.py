"""The whole batch step's share of the device's peak, %: over the traced
stretch, the GAT's model operations at the fp32 peak plus the lifter's at
the bf16 peak (frozen counts), over the stretch's wall time."""

from portbench import counts, peaks
from portbench.layers import batches


def read(ctx):
    tr = ctx["tracer"]
    if tr.window_s <= 0.0 or len(ctx["present"]) == 0:
        return None
    t = 0.0
    for p, lv, pr in batches(ctx):
        c = counts.batch_costs(ctx["config"], p, lv, pr)
        t += c["gat"][0] / peaks.FP32_FLOPS + c["lifter"][0] / peaks.BF16_FLOPS
    return 100.0 * t / tr.window_s if t > 0.0 else None
