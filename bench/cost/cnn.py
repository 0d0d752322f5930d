"""FLOPs of the paper's CNN per example, from its shapes (a multiply-add
is 2 FLOPs; biases, ReLUs and pools are not counted).

Forward: each SAME convolution is H x W outputs x C_out x (k x k x C_in)
multiply-adds (the second at the pooled size), each dense layer in x out.
Training (one SGD step's share of an example) is the forward and a
backward of twice the forward, less the first convolution's input
gradient, which no step needs."""


def layers(cfg):
    """Forward FLOPs by layer of one example."""
    s, k, c = cfg["image_size"], cfg["kernel"], cfg["channels"]
    c1, c2 = cfg["conv_channels"]
    flat = (s // 4) * (s // 4) * c2
    return {"conv1": 2 * s * s * c1 * k * k * c,
            "conv2": 2 * (s // 2) * (s // 2) * c2 * k * k * c1,
            "fc1": 2 * flat * cfg["fc_width"],
            "fc2": 2 * cfg["fc_width"] * cfg["num_classes"]}


def cost(cfg, training: bool = True) -> int:
    """FLOPs of one example: a training step's, or the forward's."""
    fwd = layers(cfg)
    total = sum(fwd.values())
    return 3 * total - fwd["conv1"] if training else total
