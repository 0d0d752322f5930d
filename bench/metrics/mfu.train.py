"""Model FLOPs of the training steps in the window (``cost/lm.py``: 6 N a
token and the scan's, remat's recompute not counted) over the window's
host-clock length, as a percentage of the bf16 peak."""


def read(ctx):
    t = ctx.spec.traffic
    flops = ctx.work["steps"] * ctx.cost("lm").cost(ctx.spec.config, t["batch"], t["seq"], True)
    return 100.0 * (flops / ctx.work["window_s"] / ctx.peaks["bf16_flops"])
