"""K2's percentage of its roofline: the least time its calls in the traced
window could take (``cost/k2.py``: bytes over HBM bandwidth) over the
device time of ``radix_topk_kernel`` there (K3 shares the kernel; the
Markov policy runs no K3)."""


def read(ctx):
    calls = ctx.counters["k2_calls"]
    busy = ctx.trace.device_s(["radix_topk_kernel"])
    if not calls or busy <= 0:
        return None
    t = ctx.spec.traffic
    flops, nbytes = ctx.cost("k2").cost(n=t["clients"], k=t["buffer"])
    return 100.0 * (calls * nbytes / ctx.peaks["hbm_bytes_per_s"] / busy)
