"""FLOPs of a Mamba2 language model step, frozen from the port's earlier
``share_of_bf16_peak`` arithmetic: 2 N a token forward and 6 N a token for
a training step (N every parameter, the tied embedding once), plus each
layer's SSD scan (``cost/k6_fwd.py`` and ``cost/k6_bwd.py``'s FLOPs).
Recomputation under remat is not counted."""
from bench import harness


def n_params(cfg) -> int:
    d, di, ds = cfg["d_model"], cfg["expand"] * cfg["d_model"], cfg["d_state"]
    nh = di // cfg["headdim"]
    ch = di + 2 * ds
    layer = d + d * (2 * di + 2 * ds + nh) + cfg["d_conv"] * ch + ch + 3 * nh + di + di * d
    return cfg["vocab_size"] * d + d + cfg["n_layer"] * layer


def cost(cfg, batch: int, seq: int, training: bool) -> int:
    """FLOPs of one step (training) or one forward over batch x seq tokens."""
    shape = dict(B=batch, S=seq, nh=cfg["expand"] * cfg["d_model"] // cfg["headdim"],
                 hd=cfg["headdim"], ds=cfg["d_state"], L=cfg["chunk_size"])
    scan = harness.cost("k6_fwd").cost(**shape)[0]
    if training:
        scan += harness.cost("k6_bwd").cost(**shape)[0]
    return (6 if training else 2) * n_params(cfg) * batch * seq + cfg["n_layer"] * scan
