"""K1's percentage of its roofline: the least time its calls in the traced
window could take (``cost/k1.py``: bytes over HBM bandwidth, or FLOPs
over the float32 peak, the larger) over the device time of
``fedavg_reduce_kernel`` there."""


def read(ctx):
    calls = ctx.counters["k1_calls"]
    busy = ctx.trace.device_s(["fedavg_reduce_kernel"])
    if not calls or busy <= 0:
        return None
    flops, nbytes = ctx.cost("k1").cost(**ctx.work["k1_shape"])
    bound = max(flops / ctx.peaks["f32_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * (calls * bound / busy)
