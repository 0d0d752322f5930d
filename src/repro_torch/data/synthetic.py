"""Synthetic datasets.

Real MNIST/CIFAR are unavailable in the offline container; we generate
class-conditional image datasets with matched shapes and cardinalities
(class prototype + structured noise + per-sample affine jitter), hard
enough that the paper's CNN needs many FedAvg rounds to fit them — which
is what the convergence experiments measure. Token streams for the LLM
architectures come from a small synthetic Zipf language model.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    name: str
    images: np.ndarray  # (N, H, W, C) float32 in [0, 1]-ish, standardized
    labels: np.ndarray  # (N,) int32


def make_image_dataset(
    name: str,
    num_classes: int,
    image_size: int,
    channels: int,
    train_size: int,
    test_size: int,
    seed: int = 0,
    difficulty: float = 1.6,
) -> Tuple[ImageDataset, ImageDataset]:
    """Class-conditional generator: each class is a mixture of 3 smooth
    prototypes; samples add prototype mixing, spatial shift, and noise.
    ``difficulty`` scales the noise (higher = slower convergence)."""
    rng = np.random.default_rng(seed)
    protos_per_class = 3
    # smooth prototypes: low-frequency random fields
    freq = 4
    base = rng.normal(
        size=(num_classes, protos_per_class, freq, freq, channels)
    ).astype(np.float32)

    def upsample(field):  # (.., freq, freq, C) -> (.., H, W, C) bilinear-ish
        reps = image_size // freq
        out = np.repeat(np.repeat(field, reps, axis=-3), reps, axis=-2)
        return out

    protos = upsample(base)  # (classes, P, H, W, C)

    def gen(n, seed_):
        r = np.random.default_rng(seed_)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        mix = r.dirichlet(np.ones(protos_per_class), size=n).astype(np.float32)
        imgs = np.einsum("np,nphwc->nhwc", mix, protos[labels])
        # random spatial roll
        sh = r.integers(-2, 3, size=(n, 2))
        for i in range(n):  # small n; fine on host
            imgs[i] = np.roll(imgs[i], sh[i], axis=(0, 1))
        imgs += difficulty * r.normal(size=imgs.shape).astype(np.float32)
        imgs = (imgs - imgs.mean()) / (imgs.std() + 1e-6)
        return ImageDataset(name, imgs.astype(np.float32), labels)

    return gen(train_size, seed + 1), gen(test_size, seed + 2)


DATASET_SPECS = {
    # name: (classes, size, channels, train, test)
    "mnist": (10, 28, 1, 12000, 2000),
    "cifar10": (10, 32, 3, 12000, 2000),
    "cifar100": (100, 32, 3, 20000, 4000),
}


def load_dataset(name: str, seed: int = 0, scale: float = 1.0):
    classes, size, ch, ntr, nte = DATASET_SPECS[name]
    return make_image_dataset(
        name, classes, size, ch, int(ntr * scale), int(nte * scale), seed=seed
    )


def make_token_stream(
    vocab_size: int, num_tokens: int, seed: int = 0, order: int = 2
) -> np.ndarray:
    """Zipf-distributed token stream with local bigram structure, so a
    language model has something learnable."""
    rng = np.random.default_rng(seed)
    v = min(vocab_size, 4096)
    zipf = 1.0 / np.arange(1, v + 1) ** 1.1
    zipf /= zipf.sum()
    # bigram transition: mixture of zipf and a random permutation successor
    succ = rng.permutation(v)
    toks = np.empty(num_tokens, dtype=np.int32)
    toks[0] = rng.choice(v, p=zipf)
    draws = rng.random(num_tokens)
    zipf_draws = rng.choice(v, size=num_tokens, p=zipf)
    for i in range(1, num_tokens):
        toks[i] = succ[toks[i - 1]] if draws[i] < 0.5 else zipf_draws[i]
    return toks % vocab_size
