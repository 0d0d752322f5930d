"""Learned online detection: a logistic head trained inside the step.

The port of ``repro.defense.learned``. ``detector="learned"`` replaces the
fixed OR-combination of anomaly channels with a tiny logistic regression
over the per-slot feature vector — norm z, cosine z, clique score, flip
score, shaped staleness, shaped age-of-information, and a robust
loss-delta z — trained one SGD step per observed cohort.

Labels: when the run arms ``fault_exposure`` the engines pass the
per-slot fault-hit mask (evaluation mode); otherwise the head
self-supervises against its own quarantine outcomes (a slot is "bad" if
its client is already hot or benched).

Cold start is safe by construction: a zero weight vector scores every
slot sigmoid(0) = 0.5, below the default 0.55 quarantine threshold, so
an untrained head never quarantines anyone.

State (the reference's shapes):

  lw   (1, F)   f32  logistic head weights (feature order above + bias)
  auc  (2, 16)  f32  score histograms, row 0 fault/positive slots,
                     row 1 clean/negative — exact AUC at report time

The head's products are elementwise multiplies and sums, not a matmul, so
no TF32 setting changes them; the histogram adds 0/1 counts with
``index_add``, exact in any order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.defense.config import DefenseConfig
from repro_torch.defense.stats import median_and_mad, median_ranks

N_FEATURES = 8
N_BINS = 16


def _robust_one_sided_z(x, valid, floor):
    """z of x above the cohort's masked median, MAD-scaled (like the
    norm channel in :func:`repro_torch.defense.reputation._slot_channels`)."""
    c, lo, hi = median_ranks(valid)
    med, mad = median_and_mad(x, valid, c, lo, hi)
    scale = torch.clamp(1.4826 * mad, min=floor)
    return torch.clamp((x - med) / scale, min=0.0)


def feature_matrix(s_norm, s_dir, s_clique, s_flip, staleness, ages,
                   losses, valid):
    """(B, N_FEATURES) per-slot features, every channel in [0, 1]."""
    st = staleness.to(torch.float32)
    stale_f = 1.0 - (1.0 + st) ** -0.5
    if ages is None:
        age_f = torch.zeros_like(s_norm)
    else:
        ag = torch.clamp(ages.to(torch.float32), min=0.0)
        age_f = 1.0 - (1.0 + ag) ** -0.5
    if losses is None:
        loss_f = torch.zeros_like(s_norm)
    else:
        zl = _robust_one_sided_z(losses.to(torch.float32), valid, 0.05)
        loss_f = zl / (zl + 3.0)
    ones = torch.ones_like(s_norm)
    return torch.stack(
        [s_norm, s_dir, s_clique, s_flip, stale_f, age_f, loss_f, ones], dim=1)


def learned_observe(dstate, feats, valid, labels, cfg: DefenseConfig):
    """Score this cohort with the current head, then train one step.

    Returns ``(dstate, scores)`` where ``scores`` are the pre-update
    sigmoid probabilities — the online prediction, never contaminated
    by this cohort's own labels.
    """
    w = dstate["lw"][0]
    p = torch.sigmoid((feats * w).sum(dim=1))  # (B,)

    y = torch.where(valid, labels.to(torch.float32), 0.0)
    grad = torch.where(valid[:, None], (p - y)[:, None] * feats, 0.0).sum(dim=0)
    cnt = valid.sum(dtype=torch.float32)
    w_new = w - cfg.learned_lr * grad / torch.clamp(cnt, min=1.0)

    bins = torch.clamp((p * N_BINS).to(torch.int32), 0, N_BINS - 1).long()
    pos = torch.where(valid & (y > 0.5), 1.0, 0.0)
    neg = torch.where(valid & (y <= 0.5), 1.0, 0.0)
    auc = dstate["auc"]
    auc = torch.stack([auc[0].index_add(0, bins, pos), auc[1].index_add(0, bins, neg)])

    dstate = {**dstate, "lw": w_new[None, :], "auc": auc}
    return dstate, p


def auc_from_hist(hist) -> float:
    """Exact ROC AUC from the (2, N_BINS) score histograms (host side).

    Ties within a bin count half, the standard rank-statistic handling;
    NaN when either class has not been observed yet.
    """
    h = np.asarray(hist, np.float64)
    pos, neg = h[0], h[1]
    p_tot, n_tot = pos.sum(), neg.sum()
    if p_tot <= 0 or n_tot <= 0:
        return float("nan")
    neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    return float((pos * (neg_below + 0.5 * neg)).sum() / (p_tot * n_tot))
