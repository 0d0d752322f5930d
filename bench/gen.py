"""Inputs made from ``--seed``, on the device, in a few large calls: the
MNIST-shaped images, the token stream and the weights. The benchmark makes
them and hands the same to the program and to the reference."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of a run seeded ``seed``."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, name))
    return g


def images(seed: int, n: int, size: int, channels: int, classes: int, device,
           difficulty: float = 1.6, protos: int = 3, freq: int = 4):
    """Class-conditional images (the arithmetic of the port's synthetic
    MNIST): each class mixes ``protos`` smooth prototypes (a ``freq`` x
    ``freq`` random field, each cell repeated to ``size``), Dirichlet(1)
    weights, a random roll of -2..2 pixels on each axis, noise of scale
    ``difficulty``, then standardised over the set. Returns NHWC float32
    images and int64 labels, both on ``device``."""
    g = generator(seed, "images", device)
    dev = torch.device(device)
    base = torch.randn((classes, protos, freq, freq, channels), generator=g, device=dev)
    reps = size // freq
    proto = base.repeat_interleave(reps, 2).repeat_interleave(reps, 3)
    labels = torch.randint(0, classes, (n,), generator=g, device=dev)
    mix = -torch.log(torch.rand((n, protos), generator=g, device=dev).clamp_min(1e-12))
    mix = mix / mix.sum(1, keepdim=True)
    img = torch.einsum("np,nphwc->nhwc", mix, proto[labels])
    sh = torch.randint(-2, 3, (n, 2), generator=g, device=dev)
    ar = torch.arange(size, device=dev)
    rows = (ar[None, :] - sh[:, :1]) % size
    cols = (ar[None, :] - sh[:, 1:]) % size
    img = img[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    img = img + difficulty * torch.randn(img.shape, generator=g, device=dev)
    img = (img - img.mean()) / (img.std() + 1e-6)
    return img.contiguous(), labels


def token_batches(seed: int, count: int, batch: int, seq: int, vocab: int,
                  device) -> torch.Tensor:
    """``count`` batches of ``batch`` rows of ``seq + 1`` tokens, (count,
    batch, seq + 1) int64: the port's Zipf-bigram stream arithmetic
    (ids below min(vocab, 4096) with Zipf(1.1) weights; each token is the
    previous one's fixed successor with probability 1/2, else a fresh Zipf
    draw), drawn in whole-array steps on the device. Every row differs."""
    g = generator(seed, "tokens", device)
    dev = torch.device(device)
    v = min(vocab, 4096)
    zipf = 1.0 / torch.arange(1, v + 1, device=dev, dtype=torch.float64) ** 1.1
    succ = torch.randperm(v, generator=g, device=dev)
    rows, n = count * batch, seq + 1
    fresh = torch.multinomial((zipf / zipf.sum()).float(), rows * n, replacement=True,
                              generator=g).view(rows, n)
    follow = torch.rand((rows, n), generator=g, device=dev) < 0.5
    follow[:, 0] = False
    # each token is succ applied d times to the last fresh draw, d positions back
    pos = torch.arange(n, device=dev).expand(rows, n)
    last = torch.cummax(torch.where(follow, torch.zeros_like(pos), pos), 1).values
    dist = pos - last
    tok = torch.gather(fresh, 1, last)
    for d in range(1, int(dist.max()) + 1):
        tok = torch.where(dist >= d, succ[tok], tok)
    return (tok % vocab).view(count, batch, n)


def normal_tree(seed: int, shapes: List[Tuple[str, Tuple[int, ...], float]], dtype,
                device) -> Dict[str, torch.Tensor]:
    """Leaves ``name -> N(0, 1) * scale`` of ``shape``, drawn as one flat
    buffer in ``dtype`` and cut into views."""
    g = generator(seed, "weights", device)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn((total,), generator=g, device=torch.device(device),
                       dtype=torch.float32).to(dtype)
    out, at = {}, 0
    for name, shape, scale in shapes:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        if scale != 1.0:
            out[name].mul_(scale)
        at += size
    return out
