"""Per-client reputation, quarantine, and probation — the torch runtime.

The port of ``repro.defense.reputation``. The ``Defense`` object is the
engines' counterpart of ``FaultSet``: its state dict rides the engine state
(``state["defense"]``), its random draws come from the ``defense``
sub-stream of the run's source (the reference's key fold 108), and every
armed effect is applied through ``torch.where`` / ``& ~mask`` seams, so an
armed-but-never-triggered defense leaves the training stream bit for bit
the calm run.

State layout (the reference's keys, dtypes and shapes):

  rep         (n,) f32  EWMA anomaly score in [0, 1]
  status      (n,) i32  0 active / 1 quarantined / 2 probation
  quarantined ()   f32  cumulative quarantine inflow (incl. relapses)
  readmitted  ()   f32  cumulative probation -> active re-admissions
  pressure    ()   f32  windowed attack-pressure accumulator (mtd)
  win_obs     ()   f32  windowed observed-slot count (mtd)
  win         ()   i32  steps into the current mtd window
  level       ()   i32  current rung on the mtd ladder

armed only with ``collusion=True`` (see :mod:`repro_torch.defense.collusion`):

  sketch      (n, d_sketch) f32  EWMA historical-direction sketches
  sk_obs      (n,) f32  sketch observation counts
  clique_hits ()   f32  cumulative clique-discounted slot count

armed only with ``detector="learned"`` (see :mod:`repro_torch.defense.learned`):

  lw          (1, F)  f32  logistic-head weights
  auc         (2, 16) f32  pos/neg score histograms for exact AUC

The quarantine chain's coins are two ``(n,)`` uniforms drawn every step
from the ``defense`` sub-stream, at the sites ``probation`` and
``readmit``, and compared ``< p`` as ``jax.random.bernoulli`` compares the
reference's fold-108 sub-folds 0 and 1. The robust center of the cosine
channel is the weighted sum ``sum_c cw_c * d_c`` over the f32 delta stack:
K1, one ``fedavg_reduce_leaves`` launch for the whole tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fleet import whole
from repro_torch.core.load_metric import ewma_scatter_update
from repro_torch.core.tree import tree_paths
from repro_torch.defense.collusion import collusion_observe
from repro_torch.defense.config import DefenseConfig
from repro_torch.defense.learned import (
    N_BINS,
    N_FEATURES,
    auc_from_hist,
    feature_matrix,
    learned_observe,
)
from repro_torch.defense.stats import median_and_mad, median_ranks
from repro_torch.kernels import ops as kops

def slot_deltas(updated, bases):
    """Each leaf's f32 update deltas as a contiguous ``(B, m_i)`` stack, in
    the reference's leaf order; ``bases`` stacked or unstacked."""
    lu = [t for _, t in tree_paths(updated)]
    lb = [t for _, t in tree_paths(bases)]
    b = lu[0].shape[0]
    return [(u - bb).to(torch.float32).reshape(b, -1) for u, bb in zip(lu, lb)]


def _slot_channels(updated, bases, valid, deltas=None):
    """Raw per-cohort-slot anomaly channels ``(s_norm, s_dir, norm)``.

    (a) the slot delta's L2-norm z-score against the cohort's median/MAD
    norm, (b) misalignment (cosine) with the cohort's robust center — a
    norm-clipped mean, which a minority of scaled/flipped attackers
    cannot steer the way they cancel the plain mean. ``bases`` may be
    stacked ``(B, ...)`` (async dispatch snapshots) or the unstacked
    global params (sync); both broadcast. ``deltas`` (``slot_deltas``'s
    stacks) saves recomputing them when the caller has them.

    Each leaf's squared norm is ``vector_norm`` squared and its dot product
    with the center a ``torch.mv`` (a gemv: FP32 FMA on the card, no
    tensor cores, so TF32 does not apply, and no atomics): one pass over the
    stack each, with no temporary. The reference sums ``d * d`` and
    ``d * m``: the same values up to rounding.
    """
    if deltas is None:
        deltas = slot_deltas(updated, bases)
    sq = sum(torch.linalg.vector_norm(d, dim=1) ** 2 for d in deltas)
    norm = torch.sqrt(sq)  # (B,)

    # median + MAD of valid slot norms (sorts, invalid -> +inf)
    c, lo, hi = median_ranks(valid)
    nmed, nmad = median_and_mad(norm, valid, c, lo, hi)
    scale = torch.maximum(1.4826 * nmad, 0.05 * nmed + 1e-6)
    z = torch.clamp((norm - nmed) / scale, min=0.0)
    s_norm = z / (z + 3.0)

    # robust center: mean of deltas with norms clipped to the median —
    # one K1 launch for the tree, no per-coordinate sort
    cw = torch.where(valid, torch.clamp(nmed / torch.clamp(norm, min=1e-12), max=1.0),
                     0.0) / torch.clamp(c.to(torch.float32), min=1.0)
    center = kops.fedavg_reduce_leaves(deltas, cw.contiguous())
    dot = sum(torch.mv(d, m) for d, m in zip(deltas, center))
    cnorm = torch.sqrt(sum(torch.sum(m * m) for m in center))
    cos = dot / (norm * cnorm + 1e-12)
    # one-sided robust z of the cosine: suspicion is pointing *away* from
    # the cohort's median alignment, measured in its own spread
    cmed, cmad = median_and_mad(cos, valid, c, lo, hi)
    cscale = torch.clamp(1.4826 * cmad, min=0.05)
    zc = torch.clamp((cmed - cos) / cscale, min=0.0)
    s_dir = zc / (zc + 1.5)
    return s_norm, s_dir, norm


def _shape_scores(score, norm, staleness, cfg: DefenseConfig):
    """Optional staleness and hard-clip terms on top of a raw score."""
    if cfg.stale_gain > 0.0:
        st = staleness.to(torch.float32)
        score = torch.maximum(score, cfg.stale_gain * (1.0 - (1.0 + st) ** -0.5))
    if cfg.clip > 0.0:
        score = torch.where(norm > cfg.clip, 1.0, score)
    return score


def _slot_scores(updated, bases, valid, staleness, cfg: DefenseConfig):
    """Per-cohort-slot anomaly scores in [0, 1]: the norm and cosine
    channels of :func:`_slot_channels`, OR-combined, with the optional
    staleness and hard-clip terms riding on top."""
    s_norm, s_dir, norm = _slot_channels(updated, bases, valid)
    score = 1.0 - (1.0 - s_norm) * (1.0 - s_dir)
    return _shape_scores(score, norm, staleness, cfg)


class Defense:
    """Stateful detect -> quarantine -> adapt loop for one fleet.

    ``host_reads`` counts the reads of the mtd level that closed windows
    made (``step_level``), ``restore_reads`` those of a state this object
    did not produce (a restored or foreign state).
    """

    def __init__(self, n: int, cfg: DefenseConfig):
        self.n = int(n)
        self.cfg = cfg
        self.host_reads = 0
        self.restore_reads = 0
        self._mirror = None  # (win tensor, win, level) of the newest state

    @property
    def mtd(self) -> bool:
        return self.cfg.mtd

    @property
    def collusion(self) -> bool:
        return self.cfg.collusion

    @property
    def learned(self) -> bool:
        return self.cfg.detector == "learned"

    @property
    def wants_labels(self) -> bool:
        """Whether the engines should pass fault-hit ground truth
        (only consumed by the learned head, only when exposure is on)."""
        return self.learned

    def init(self, device):
        n = self.n

        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        state = {
            "rep": torch.zeros((n,), dtype=torch.float32, device=device),
            "status": torch.zeros((n,), dtype=torch.int32, device=device),
            "quarantined": z(), "readmitted": z(),
            "pressure": z(), "win_obs": z(),
            "win": torch.zeros((), dtype=torch.int32, device=device),
            "level": torch.zeros((), dtype=torch.int32, device=device),
        }
        if self.collusion:
            state["sketch"] = torch.zeros((n, self.cfg.d_sketch), dtype=torch.float32,
                                          device=device)
            state["sk_obs"] = torch.zeros((n,), dtype=torch.float32, device=device)
            state["clique_hits"] = z()
        if self.learned:
            state["lw"] = torch.zeros((1, N_FEATURES), dtype=torch.float32,
                                      device=device)
            state["auc"] = torch.zeros((2, N_BINS), dtype=torch.float32, device=device)
        self._mirror = (state["win"], 0, 0)
        return state

    def blocked(self, dstate):
        """(n,) bool — barred from selection (quarantined only;
        probation clients are selectable so they generate evidence)."""
        return dstate["status"] == 1

    def observe(self, dstate, draws, updated, bases, idx, valid, staleness,
                losses=None, ages=None, labels=None, layout=None):
        """Score the cohort, update reputation, run the quarantine
        chain, and advance the mtd pressure window.

        ``draws`` is the defense's sub-stream. Returns ``(dstate, excluded,
        w_scale)``: ``excluded`` is the (n,) post-transition suspect mask
        (status != 0) the caller must apply to the aggregation validity —
        the same seam heartbeat dark clients use; ``w_scale`` is a (B,)
        per-slot aggregation-weight discount (``1 - s_clique``) when
        collusion scoring is armed, else None. ``losses``/``ages`` feed the
        learned head's feature vector; ``labels`` is the per-slot fault-hit
        ground truth when ``fault_exposure`` arms evaluation mode (None ->
        the head self-supervises against its own quarantine outcomes).

        Under a sharded ``layout`` (``core.fleet``) the ``(n,)`` state is
        this rank's block: reads at ``idx`` go through the layout's gather,
        writes through its owner-only adds, the ``(n,)`` coins are drawn at
        full width and blocked, and the fleet counts are summed over ranks
        (exact: 0/1 values). ``excluded`` is then this rank's block.
        """
        cfg = self.cfg
        lay = whole(layout, self.n)
        w_scale = None
        if not self.collusion and not self.learned:
            scores = _slot_scores(updated, bases, valid, staleness, cfg)
        else:
            deltas = slot_deltas(updated, bases)  # shared with the sketch
            s_norm, s_dir, norm = _slot_channels(updated, bases, valid, deltas)
            if self.collusion:
                dstate, s_clique, s_flip = collusion_observe(
                    dstate, updated, bases, idx, valid, cfg, deltas, layout)
                w_scale = 1.0 - s_clique
            else:
                s_clique = torch.zeros_like(s_norm)
                s_flip = torch.zeros_like(s_norm)
            if self.learned:
                feats = feature_matrix(s_norm, s_dir, s_clique, s_flip,
                                       staleness, ages, losses, valid)
                if labels is None:
                    # deployment mode: self-supervise against outcomes
                    labels = ((lay.gather(dstate["rep"], idx) > cfg.threshold)
                              | (lay.gather(dstate["status"], idx) != 0))
                dstate, scores = learned_observe(dstate, feats, valid, labels, cfg)
                # staleness already sits in the feature vector; the
                # hard norm clip stays as a non-negotiable override
                if cfg.clip > 0.0:
                    scores = torch.where(norm > cfg.clip, 1.0, scores)
            else:
                score = 1.0 - ((1.0 - s_norm) * (1.0 - s_dir)
                               * (1.0 - s_clique) * (1.0 - s_flip))
                scores = _shape_scores(score, norm, staleness, cfg)

        status = dstate["status"]
        # passive decay while benched, then fresh evidence (probation
        # clients can be observed; invalid slots add an exact 0.0)
        rep = torch.where(status != 0, dstate["rep"] * cfg.q_decay, dstate["rep"])
        rep = ewma_scatter_update(rep, idx, scores, valid, cfg.ewma, layout)

        u_prob = lay.block(draws.uniform("probation", (self.n,)))
        u_read = lay.block(draws.uniform("readmit", (self.n,)))
        hot = rep > cfg.threshold
        to_quar = (status == 0) & hot
        relapse = (status == 2) & hot
        to_prob = (status == 1) & (u_prob < cfg.p_probation)
        to_active = (status == 2) & ~hot & (u_read < cfg.p_readmit)
        status = torch.where(
            to_quar | relapse, 1,
            torch.where(to_prob, 2, torch.where(to_active, 0, status)))
        inflow = lay.psum((to_quar | relapse).sum(dtype=torch.float32))
        readmits = lay.psum(to_active.sum(dtype=torch.float32))

        out = {
            **dstate, "rep": rep, "status": status,
            "quarantined": dstate["quarantined"] + inflow,
            "readmitted": dstate["readmitted"] + readmits,
        }
        if cfg.mtd:
            press = dstate["pressure"] + inflow + torch.sum(
                valid & (scores > cfg.threshold), dtype=torch.float32)
            obs = dstate["win_obs"] + valid.sum(dtype=torch.float32)
            win = dstate["win"] + 1
            done = win >= cfg.mtd_window
            ratio = press / torch.clamp(obs, min=1.0)
            step = ((ratio > cfg.mtd_up).to(torch.int32)
                    - (ratio < cfg.mtd_down).to(torch.int32))
            level = torch.clamp(dstate["level"] + torch.where(done, step, 0),
                                0, len(cfg.mtd_trims) - 1)
            out.update(
                pressure=torch.where(done, 0.0, press),
                win_obs=torch.where(done, 0.0, obs),
                win=torch.where(done, 0, win), level=level,
            )
        return out, out["status"] != 0, w_scale

    def step_level(self, before, after) -> int:
        """The mtd level a step aggregates with: ``after["level"]``, the
        level its own ``observe`` left (``before``/``after`` are the step's
        defense state going in and coming out).

        ``observe`` advances ``win`` by one every step and changes the
        level only on the step that closes a window, so the host tracks
        ``win`` itself and reads the level from the device once, on that
        step; on every other step the level is the one it read last. A
        state this object did not produce (a restored checkpoint, a second
        run) is read once to start the count."""
        m = self._mirror
        if m is not None and m[0] is before["win"]:
            win, level = m[1], m[2]
        else:
            win, level = int(before["win"]), int(before["level"])
            self.restore_reads += 1
        win += 1
        if win >= self.cfg.mtd_window:
            win = 0
            level = int(after["level"])
            self.host_reads += 1
        self._mirror = (after["win"], win, level)
        return level

    # ---- host-side reporting ------------------------------------------

    def report(self, dstate):
        """Scalar counters for ``load_stats`` (host side)."""
        status = dstate["status"].cpu().numpy()
        out = {
            "def_quarantine_inflow": float(dstate["quarantined"]),
            "def_readmitted": float(dstate["readmitted"]),
            "def_quarantined_now": int((status == 1).sum()),
            "def_probation_now": int((status == 2).sum()),
            "def_mtd_level": int(dstate["level"]),
        }
        if self.collusion:
            out["def_clique_hits"] = float(dstate["clique_hits"])
        if self.learned:
            out["def_detector_auc"] = auc_from_hist(dstate["auc"].cpu().numpy())
        return out

    def arrays(self, dstate):
        """Per-client reputation/status for ``RunResult.defense``."""
        return {
            "reputation": np.asarray(dstate["rep"].cpu().numpy()),
            "status": np.asarray(dstate["status"].cpu().numpy()),
        }


def make_defense(n: int, cfg: DefenseConfig) -> Defense:
    return Defense(n, cfg)
