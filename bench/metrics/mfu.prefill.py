"""Model FLOPs of the prefills in the window (``cost/lm.py``: 2 N a token
and the scan's forward) over the window's host-clock length, as a share
of the bf16 peak."""


def read(ctx):
    t = ctx.spec.traffic
    flops = ctx.work["steps"] * ctx.cost("lm").cost(ctx.spec.config, t["batch"], t["seq"], False)
    return 100.0 * (flops / ctx.work["window_s"] / ctx.peaks["bf16_flops"])
