"""Collusion scoring: historical-direction sketches and clique detection.

The port of ``repro.defense.collusion``. A coalition submitting a shared
poisoned direction is invisible to per-slot norm statistics; what it
cannot hide is agreement with itself over time. Each slot's update delta
is count-sketched into ``d_sketch`` dims by a fixed random signed-bucket
projection and EWMA'd into a per-client ``(n, d_sketch)`` history; the
cohort's residual-centered pairwise cosine of those histories flags
cliques, and anti-alignment with the cohort center flags flips.

The projection constants (``_projection``) are copied: host numpy from
``PROJECTION_SEED``, a pure function of the leaf shapes, so the port and
the reference embed the same ``(bucket, sign)`` arrays.

The bucket sum is a fixed-order sum, not ``index_add_``: on a CUDA float
tensor ``index_add_`` adds the many nonzero terms of a bucket with
atomics, in an order that varies by run. Instead each leaf's columns are
grouped by bucket once on the host (``_bucket_plan``: a stable sort of the
bucket ids, padded to the fullest bucket with the index of an appended
zero column), so the sketch is a gather of the signed deltas into
``(B, d_sketch, L)`` (in blocks of slots) and a ``sum`` over the last axis
— a reduction that torch computes in a fixed order on either device, so
it repeats bitwise. The reference's ``segment_sum`` adds in column order;
the two orders agree within f32 rounding (``tests/test_torch_defense.py``
holds them to rtol 1e-5).

The pairwise and center products are elementwise multiplies and sums, not
matmuls, so no TF32 setting changes them and a permutation of the slots
permutes the scores exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fleet import whole
from repro_torch.core.load_metric import ewma_scatter_update_rows, scatter_targets
from repro_torch.core.tree import tree_paths
from repro_torch.defense.config import DefenseConfig
from repro_torch.defense.stats import median_ranks, pick

# Host-side RNG seed for the signed-bucket projection. Fixed so the
# projection is a pure function of the leaf shapes: every engine (chunked,
# restarted) embeds bit-identical constants.
PROJECTION_SEED = 0x5EEDC11E

# residual L2-norm gate: unit-normalized histories sit within 2 of any
# center, honest residuals measure ~sqrt(1 - |center|^2) plus noise
RESID_GATE = 0.8
# center-norm gate for the flip channel: with no cohort consensus there
# is nothing to anti-align with
CENTER_GATE = 0.2
# flip-score half-point: a converged flipped sketch reads anti-alignment
# fx ~ 0.2-0.4 while honest noise sits under ~0.05, so fx/(fx + FLIP_HALF)
# pushes real flips well past the noise floor
FLIP_HALF = 0.15

_PROJ_CACHE: dict = {}
_PLAN_CACHE: dict = {}
_BLOCK_BYTES = 1 << 28  # gathered (slots, d_sketch, L) terms per block


def _projection(shapes, d_sketch: int):
    """Per-leaf (bucket, sign) projection constants, cached by shape."""
    key = (tuple(shapes), int(d_sketch))
    cached = _PROJ_CACHE.get(key)
    if cached is None:
        rng = np.random.default_rng(PROJECTION_SEED)
        cached = []
        for shp in shapes:
            m = int(np.prod(shp, dtype=np.int64)) if shp else 1
            h = rng.integers(0, d_sketch, size=m).astype(np.int32)
            s = (rng.integers(0, 2, size=m) * 2 - 1).astype(np.float32)
            cached.append((h, s))
        _PROJ_CACHE[key] = cached
    return cached


def _bucket_plan(h: np.ndarray, d_sketch: int) -> np.ndarray:
    """``(d_sketch, L)`` column indices of each bucket in ascending column
    order, ``L`` the fullest bucket's size; short buckets are padded with
    ``m`` (the index of a zero column appended to the signed deltas)."""
    m = h.shape[0]
    order = np.argsort(h, kind="stable")
    counts = np.bincount(h, minlength=d_sketch)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    hs = h[order]
    plan = np.full((d_sketch, max(int(counts.max(initial=0)), 1)), m, np.int64)
    plan[hs, np.arange(m) - starts[hs]] = order
    return plan


def _planes(shapes, d_sketch: int, device):
    """Per-leaf ``(sign (m,), bucket plan (d_sketch, L))`` on ``device``."""
    key = (tuple(shapes), int(d_sketch), str(device))
    cached = _PLAN_CACHE.get(key)
    if cached is None:
        cached = [(torch.as_tensor(s, device=device),
                   torch.as_tensor(_bucket_plan(h, d_sketch), device=device))
                  for h, s in _projection(shapes, d_sketch)]
        _PLAN_CACHE[key] = cached
    return cached


def project_deltas(updated, bases, d_sketch: int, deltas=None):
    """Count-sketch each slot's update delta into (B, d_sketch) unit rows.

    ``bases`` may be stacked ``(B, ...)`` dispatch snapshots (async) or
    the unstacked global params (sync); both broadcast. Zero deltas stay
    exact zero rows (they carry no direction evidence). ``deltas`` (each
    leaf's f32 ``(B, m)`` delta stack, in ``tree_paths`` order) saves
    recomputing them when the caller has them.
    """
    lu = [t for _, t in tree_paths(updated)]
    shapes = tuple(tuple(u.shape[1:]) for u in lu)
    b, dev = lu[0].shape[0], lu[0].device
    if deltas is None:
        deltas = [(u - base).to(torch.float32).reshape(b, -1)
                  for u, (_, base) in zip(lu, tree_paths(bases))]
    out = torch.zeros((b, d_sketch), dtype=torch.float32, device=dev)
    for (s, plan), d in zip(_planes(shapes, d_sketch, dev), deltas):
        m = d.shape[1]
        # slots in blocks of at most _BLOCK_BYTES of gathered terms, so a
        # fleet-scale cohort never holds its whole gathered stack at once
        rows = max(1, _BLOCK_BYTES // (plan.numel() * 4))
        sums = []
        for lo in range(0, b, rows):
            hi = min(b, lo + rows)
            ds = torch.empty((hi - lo, m + 1), dtype=torch.float32, device=dev)
            torch.mul(d[lo:hi], s, out=ds[:, :m])
            ds[:, m] = 0.0
            sums.append(ds[:, plan].sum(dim=-1))
        out = out + torch.cat(sums)
    nrm = torch.sqrt(torch.sum(out * out, dim=1, keepdim=True))
    return torch.where(nrm > 1e-12, out / torch.clamp(nrm, min=1e-12), 0.0)


def clique_scores(hists, obs, valid, idx, cfg: DefenseConfig):
    """Per-slot (s_clique, s_flip) in [0, 1] from gathered history rows.

    Pure in its array arguments and slot-permutation equivariant: every
    reduction over the slot axis is a sort or a max, and each pairwise
    product is its own elementwise sum, so permuting ``(hists, obs,
    valid, idx)`` permutes the outputs exactly.

    ``idx`` guards self-pairing: duplicate slots of one client (async
    re-dispatch races) agree with themselves trivially and must not form
    a "clique" of one.
    """
    hn = torch.sqrt(torch.sum(hists * hists, dim=1, keepdim=True))
    hu = torch.where(hn > 1e-12, hists / torch.clamp(hn, min=1e-12), 0.0)
    seen = valid & (obs >= cfg.clique_min_obs) & (hn[:, 0] > 1e-12)

    # masked coordinate median of seen histories -> cohort center sketch
    m, lo, hi = median_ranks(seen)
    col = torch.sort(torch.where(seen[:, None], hu, torch.inf), dim=0).values
    center = torch.where(m > 0, (pick(col, lo) + pick(col, hi)) / 2.0, 0.0)  # (d,)
    cn = torch.sqrt(torch.sum(center * center))
    cu = torch.where(cn > 1e-12, center / torch.clamp(cn, min=1e-12), 0.0)

    # flip channel: anti-alignment with the consensus direction
    align = torch.sum(hu * cu, dim=1)  # (B,)
    fx = torch.clamp(-align, min=0.0)
    s_flip = torch.where(seen & (cn > CENTER_GATE), fx / (fx + FLIP_HALF), 0.0)

    # clique channel: pairwise agreement of *residual* directions
    resid = hu - center[None, :]
    rn = torch.sqrt(torch.sum(resid * resid, dim=1))
    elig = seen & (rn > RESID_GATE)
    ru = torch.where(rn[:, None] > 1e-12,
                     resid / torch.clamp(rn[:, None], min=1e-12), 0.0)
    cs = torch.sum(ru[:, None, :] * ru[None, :, :], dim=-1)  # (B, B)
    pair = elig[:, None] & elig[None, :] & (idx[:, None] != idx[None, :])
    maxcs = torch.amax(torch.where(pair, cs, -1.0), dim=1)
    s_clique = torch.where(
        elig,
        torch.clamp((maxcs - cfg.clique_thresh) / (1.0 - cfg.clique_thresh),
                    0.0, 1.0),
        0.0)
    return s_clique, s_flip


def collusion_observe(dstate, updated, bases, idx, valid,
                      cfg: DefenseConfig, deltas=None, layout=None):
    """Update the sketches with this cohort and score it (``deltas`` as
    for :func:`project_deltas`).

    Returns ``(dstate, s_clique, s_flip)``; the caller turns ``s_clique``
    into both a reputation term and the aggregation-weight discount
    ``1 - s_clique`` (exact 1.0 for every clique-free slot, so a calm
    armed run multiplies weights by exact ones). The observation counts
    add 0/1 with ``index_add``, exact in any order. Under a sharded
    ``layout`` (``core.fleet``) the ``(n, d_sketch)`` sketches and the
    counts are this rank's blocks, read through the layout's gather and
    written on their owner.
    """
    lay = whole(layout, dstate["sk_obs"].shape[0])
    rows = project_deltas(updated, bases, cfg.d_sketch, deltas)
    sketch = ewma_scatter_update_rows(
        dstate["sketch"], idx, rows, valid, cfg.sketch_ewma, layout)
    g, inb = scatter_targets(idx, lay.n)
    sk_obs = lay.index_add(dstate["sk_obs"], g,
                           torch.where(valid & inb, 1.0, 0.0))
    hists = lay.gather(sketch, g)
    obs = lay.gather(sk_obs, g)
    s_clique, s_flip = clique_scores(hists, obs, valid, idx, cfg)
    hits = torch.sum(torch.where(valid & (s_clique > 0.5), 1.0, 0.0))
    dstate = {**dstate, "sketch": sketch, "sk_obs": sk_obs,
              "clique_hits": dstate["clique_hits"] + hits}
    return dstate, s_clique, s_flip
