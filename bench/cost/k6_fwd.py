"""K6 forward (``ssd_scan``) at x (B, S, nh, hd), B_ and C_ (B, S, ds),
chunks of L. FLOPs: what the chunked scan needs (C B^T once per (batch,
chunk) over the causal pairs; per (batch, head, chunk) the pairs' scores
times x and the chunk's state and output products); bytes: x, B_, C_ read
in bfloat16, dt and A in float32, y and the final state written in
float32. No workspace of any schedule is counted."""

# the kernels that K6's forward launches; ssd_cb_kernel is shared with the
# backward, whose calls it opens (followed by ssd_bwd_*)
FWD = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_out_kernel", "ssd_fma_kernel")
CB = "ssd_cb_kernel"


def cost(B, S, nh, hd, ds, L):
    """(FLOPs, bytes) of one call."""
    nc, pairs = S // L, L * (L + 1) // 2
    flops = B * nc * pairs * 2 * ds + B * nh * nc * (pairs * 2 * hd + 4 * L * hd * ds)
    x, bc, dt = B * S * nh * hd, B * S * ds, B * S * nh
    read = 2 * (x + 2 * bc) + 4 * (dt + nh)
    written = 4 * (x + B * nh * hd * ds)
    return flops, read + written


def split(ops):
    """(forward seconds, backward seconds) of K6's kernels among the trace's
    ``(name, start_us, end_us)`` ops: a CB kernel belongs to the call whose
    next scan kernel follows it."""
    fwd = bwd = 0.0
    scan = [(n, s, e) for n, s, e in ops if "ssd_" in n]
    for i, (n, s, e) in enumerate(scan):
        t = (e - s) / 1e6
        if CB in n:
            nxt = scan[i + 1][0] if i + 1 < len(scan) else ""
            if "ssd_bwd" in nxt:
                bwd += t
            else:
                fwd += t
        elif "ssd_bwd" in n:
            bwd += t
        elif any(k in n for k in FWD):
            fwd += t
    return fwd, bwd
