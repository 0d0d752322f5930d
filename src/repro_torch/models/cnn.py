"""The paper's simulation model: CNN of McMahan et al. [1], in torch.

Two 5x5 conv layers (32, 64 channels) each followed by 2x2 max-pool, a
512-unit fully-connected layer, and a softmax output (paper Sec. IV).

The params keep the reference's layout at every public function: a dict
with the same keys, HWIO conv weights and ``(in, out)`` fc weights, and
images are NHWC. The functions permute to torch's NCHW/OIHW inside, and
flatten in NHWC order so the rows of ``fc1.w`` follow (H, W, C) exactly as
in the reference (an NCHW flatten would scramble them with no error).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig


def init_params(draws, cfg: CNNConfig) -> Dict:
    """He-normal weights and zero biases; the normals come from ``draws``
    at sites ``params/conv1`` .. ``params/fc2``."""
    c1, c2 = cfg.conv_channels
    kk = cfg.kernel
    # output spatial size after two stride-2 pools with SAME conv
    s = cfg.image_size // 4
    flat = s * s * c2
    dev = draws.device

    def he(name, shape, fan_in):
        return draws.normal(f"params/{name}", shape) * (2.0 / fan_in) ** 0.5

    def zeros(width):
        return torch.zeros((width,), dtype=torch.float32, device=dev)

    return {
        "conv1": {"w": he("conv1", (kk, kk, cfg.channels, c1), kk * kk * cfg.channels),
                  "b": zeros(c1)},
        "conv2": {"w": he("conv2", (kk, kk, c1, c2), kk * kk * c1), "b": zeros(c2)},
        "fc1": {"w": he("fc1", (flat, cfg.fc_width), flat), "b": zeros(cfg.fc_width)},
        "fc2": {"w": he("fc2", (cfg.fc_width, cfg.num_classes), cfg.fc_width),
                "b": zeros(cfg.num_classes)},
    }


def _conv(x, p):
    """SAME 5x5 conv, stride 1, on NCHW ``x`` with an HWIO weight."""
    w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    return F.conv2d(x, w, p["b"], padding=w.shape[-1] // 2)


def forward(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood, as the reference writes it."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def loss_and_acc(params: Dict, images, labels):
    logits = forward(params, images)
    loss = cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc
