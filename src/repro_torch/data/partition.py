"""Client data partitioning: IID and Dirichlet non-IID [14].

The paper's non-IID experiment draws each client's label distribution from
Dirichlet(alpha=0.6) (Yurochkin et al. [14]). We partition a dataset into
n equal-size client shards (the paper assumes |D_i| all equal, Sec. II).
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(num_examples: int, n_clients: int, seed: int = 0) -> np.ndarray:
    """Returns (n_clients, shard) index matrix, equal sizes."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_examples)
    shard = num_examples // n_clients
    return order[: shard * n_clients].reshape(n_clients, shard)


def partition_dirichlet(
    labels: np.ndarray, n_clients: int, alpha: float = 0.6, seed: int = 0
) -> np.ndarray:
    """Dirichlet label-skew partition with equal client sizes.

    Each client gets a Dirichlet(alpha) label distribution; examples are
    assigned greedily by those quotas, then trimmed/padded to equal size
    (paper assumption |D_i| equal).
    """
    rng = np.random.default_rng(seed)
    n = len(labels)
    classes = np.unique(labels)
    shard = n // n_clients
    quotas = rng.dirichlet(alpha * np.ones(len(classes)), size=n_clients)
    by_class: List[np.ndarray] = [
        rng.permutation(np.flatnonzero(labels == c)) for c in classes
    ]
    ptr = np.zeros(len(classes), dtype=np.int64)
    out = np.empty((n_clients, shard), dtype=np.int64)
    for ci in range(n_clients):
        want = (quotas[ci] * shard).astype(np.int64)
        # fix rounding to hit exactly `shard`
        while want.sum() < shard:
            want[rng.integers(len(classes))] += 1
        while want.sum() > shard:
            nz = np.flatnonzero(want > 0)
            want[rng.choice(nz)] -= 1
        got = []
        for k, cls_idx in enumerate(by_class):
            take = min(want[k], len(cls_idx) - ptr[k])
            got.append(cls_idx[ptr[k] : ptr[k] + take])
            ptr[k] += take
        got = np.concatenate(got) if got else np.empty(0, np.int64)
        if len(got) < shard:  # class exhausted: fill from global leftovers
            leftovers = np.concatenate(
                [c[p:] for c, p in zip(by_class, ptr)] or [np.empty(0, np.int64)]
            )
            extra = rng.choice(leftovers, size=shard - len(got), replace=False)
            # advance pointers approximately: mark taken by removing later is
            # costly; instead draw from a shrinking pool
            taken = set(extra.tolist())
            for k in range(len(by_class)):
                rest = by_class[k][ptr[k] :]
                keep = np.array([i for i in rest if i not in taken], dtype=np.int64)
                by_class[k] = np.concatenate([by_class[k][: ptr[k]], keep])
            got = np.concatenate([got, extra])
        out[ci] = got[:shard]
    return out


def label_histograms(labels: np.ndarray, parts: np.ndarray, num_classes: int):
    """(n_clients, num_classes) label counts — for non-IID diagnostics."""
    return np.stack(
        [np.bincount(labels[p], minlength=num_classes) for p in parts]
    )
