"""K6 backward (``ssd_scan``'s gradient) at x (B, S, nh, hd), B_ and C_
(B, S, ds), chunks of L. FLOPs: what the scan's gradient needs (C B^T once
per (batch, chunk); per (batch, head, chunk) the causal pairs' products
and eight state products); bytes: the gradient's inputs, x, B_, C_
(bfloat16), dt, A and dy (float32), read; dx, dB_, dC_ (bfloat16), ddt,
dA (a row per batch row) and dh0 (float32) written. Each once; no state
that a schedule saves between chunks and no workspace is counted."""


def cost(B, S, nh, hd, ds, L):
    """(FLOPs, bytes) of one call."""
    nc, pairs = S // L, L * (L + 1) // 2
    flops = B * nc * pairs * 2 * ds + B * nh * nc * (
        pairs * 2 * (2 * ds + 2 * hd) + 8 * L * hd * ds)
    x, bc, dt = B * S * nh * hd, B * S * ds, B * S * nh
    read = 2 * (x + 2 * bc) + 4 * (dt + nh + x)
    written = 2 * (x + 2 * bc) + 4 * (dt + B * nh + B * nh * hd * ds)
    return flops, read + written
