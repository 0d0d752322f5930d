"""``k6_fwd_roofline.<cell>``: K6 forward's percentage of its roofline in
the traced steps: the calls' least time (``cost/k6_fwd.py``: bytes over
HBM bandwidth or FLOPs over the bf16 peak, the larger) over the device
time of its kernels."""


def read(ctx):
    c, t = ctx.spec.config, ctx.spec.traffic
    calls = ctx.counters["k6_calls"]
    k6 = ctx.cost("k6_fwd")
    busy = k6.split(ctx.trace.ops)[0]
    if not calls or busy <= 0:
        return None
    flops, nbytes = k6.cost(B=t["batch"], S=t["seq"], nh=c["expand"] * c["d_model"] // c["headdim"],
                            hd=c["headdim"], ds=c["d_state"], L=c["chunk_size"])
    bound = max(flops / ctx.peaks["bf16_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * (calls * bound / busy)
