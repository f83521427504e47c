"""Shared arithmetic of the per-layer readers: a layer's share of its
roofline over the traced stretch, from the frozen counts (``counts.py``)
and the device time of the kernels a reader names."""

from __future__ import annotations


from portbench import counts, peaks


def batches(ctx):
    """(present [B, C, S], live [B], persons [B]) a traced batch."""
    B = ctx["batch_frames"]
    p, lv, pr = ctx["present"], ctx["live"], ctx["persons"]
    for i in range(0, len(p), B):
        yield p[i:i + B], lv[i:i + B], pr[i:i + B]


def layer_bound_s(ctx, layer: str, peak: float) -> float:
    total = 0.0
    for p, lv, pr in batches(ctx):
        ops, byt = counts.batch_costs(ctx["config"], p, lv, pr)[layer]
        total += peaks.bound_s(ops, byt, peak)
    return total


def roofline(ctx, layer: str, kernels, peak: float):
    t = ctx["tracer"].device_seconds(kernels)
    if t <= 0.0 or len(ctx["present"]) == 0:
        return None
    return 100.0 * layer_bound_s(ctx, layer, peak) / t


def idle(ctx):
    tr = ctx["tracer"]
    if tr.window_s <= 0.0 or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


