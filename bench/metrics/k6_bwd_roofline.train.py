"""K6 backward's percentage of its roofline in the traced steps: the calls'
least time (``cost/k6_bwd.py``) over the device time of its kernels (the
``ssd_bwd_*`` kernels and the CB kernel each backward call opens with)."""


def read(ctx):
    c, t = ctx.spec.config, ctx.spec.traffic
    calls = ctx.counters["k6_bwd_calls"]
    busy = ctx.cost("k6_fwd").split(ctx.trace.ops)[1]
    if not calls or busy <= 0:
        return None
    flops, nbytes = ctx.cost("k6_bwd").cost(
        B=t["batch"], S=t["seq"], nh=c["expand"] * c["d_model"] // c["headdim"],
        hd=c["headdim"], ds=c["d_state"], L=c["chunk_size"])
    bound = max(flops / ctx.peaks["bf16_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * (calls * bound / busy)
