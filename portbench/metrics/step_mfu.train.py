"""The training steps' share of the fp32 peak, %: 6 operations a weight
and row (forward and backward) for every step of the traced stretch, over
its wall time (dev evaluations in it count no operations)."""

from portbench import counts, peaks


def read(ctx):
    tr = ctx["tracer"]
    if tr.window_s <= 0.0 or not ctx["steps"]:
        return None
    ops = ctx["steps"] * counts.train_step_ops(ctx["config"]["lifter"],
                                               ctx["rows"])
    return 100.0 * ops / peaks.FP32_FLOPS / tr.window_s
