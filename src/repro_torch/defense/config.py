"""Defense configuration — deliberately torch-free.

Copied from ``repro.defense.config`` (plain Python): every knob, default
and validation message is the reference's, and
``tests/test_torch_defense.py`` holds the copy to it.
``RunConfig.resolved_defense()`` builds this eagerly in ``__post_init__``
(the same pattern as topology resolution), so a bad knob fails at config
time without importing torch; the runtime in
:mod:`repro_torch.defense.reputation` is only constructed by the engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

DETECTORS = ("zscore", "learned")
# aggregator families the moving-target ladder may rotate across; "base"
# is the engine's configured aggregator untouched (bitwise via the
# switch's branch 0) and must occupy level 0
MTD_FAMILIES = ("base", "trimmed_mean", "coordinate_median", "norm_clip")


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Knobs for the detect -> quarantine -> adapt loop.

    Detection: per-client reputation is an EWMA (weight ``ewma`` on the
    newest observation) of per-cohort-slot anomaly scores in [0, 1].
    Quarantine: reputation above ``threshold`` moves a client to
    quarantined (excluded from selection AND aggregation); a quarantined
    client's reputation decays passively by ``q_decay`` per step and it
    moves to probation with per-step probability ``p_probation``.
    Probation clients are selectable again (so they generate fresh
    evidence) but stay excluded from aggregation until re-admitted with
    probability ``p_readmit`` while their reputation sits at or below the
    threshold; a probation client whose reputation crosses the threshold
    relapses to quarantine. ``threshold=inf`` arms the machinery without
    ever triggering it (bitwise-calm by construction).

    Moving-target defense (``mtd``): windowed attack pressure (suspect
    slot mass + quarantine inflow per observed slot over ``mtd_window``
    steps) walks a trim-fraction ladder ``mtd_trims``; level 0 is the
    engine's configured aggregator untouched, level L swaps in a trimmed
    mean at ``mtd_trims[L]``. ``mtd_families`` upgrades the ladder to
    rotate across aggregator *families*: one name per rung (level 0 must
    be ``"base"``), picked by the engine from the ladder level —
    ``trimmed_mean`` rungs read their trim from ``mtd_trims``,
    ``norm_clip`` clips to the cohort's median delta norm, and
    ``coordinate_median`` is parameter-free.

    Collusion scoring (``collusion``): every slot's update direction is
    count-sketched into ``d_sketch`` dims and EWMA'd (``sketch_ewma``)
    into a per-client historical-direction sketch. Clients whose
    sketches, after subtracting the cohort's coordinate-median sketch,
    still agree pairwise above ``clique_thresh`` form a clique
    (FoolsGold-style): their anomaly score and aggregation weight are
    jointly discounted. A client whose sketch *opposes* the cohort
    center scores the anti-alignment ("flip") channel — the signal a
    pure −1x sign-flip leaves that norm statistics cannot see. A sketch
    needs ``clique_min_obs`` observations before either channel fires.

    Learned detection (``detector="learned"``): a logistic head trained
    inside the step on the per-slot feature vector (norm z, cosine z,
    clique, flip, staleness, AoI, loss delta) replaces the fixed
    OR-combination. Labels come from the per-slot fault-hit mask when
    ``RunConfig.fault_exposure`` is armed (evaluation mode) or from
    quarantine outcomes otherwise (self-supervised deployment mode);
    ``learned_lr`` is the head's SGD step size.
    """

    threshold: float = 0.55
    ewma: float = 0.8
    q_decay: float = 0.985
    p_probation: float = 0.15
    p_readmit: float = 0.5
    clip: float = 0.0        # >0: delta norms above this score 1.0 outright
    stale_gain: float = 0.0  # >0: staleness feeds the anomaly score
    detector: str = "zscore"  # zscore | learned
    learned_lr: float = 0.5   # logistic-head SGD step size
    collusion: bool = False
    d_sketch: int = 64        # historical-direction sketch width
    sketch_ewma: float = 0.25  # weight on the newest sketched direction
    clique_thresh: float = 0.6  # residual pairwise-cos clique threshold
    clique_min_obs: int = 3   # sketch observations before scoring fires
    mtd: bool = False
    mtd_window: int = 8
    mtd_trims: Tuple[float, ...] = (0.0, 0.1, 0.2, 0.35)
    mtd_families: Optional[Tuple[str, ...]] = None
    mtd_up: float = 0.15
    mtd_down: float = 0.05

    def __post_init__(self):
        if not (self.threshold > 0.0):
            raise ValueError(
                f"defense threshold must be > 0 (inf disarms the trigger), "
                f"got {self.threshold}")
        if not (0.0 < self.ewma <= 1.0):
            raise ValueError(f"defense ewma must be in (0, 1], got {self.ewma}")
        if not (0.0 < self.q_decay <= 1.0):
            raise ValueError(
                f"defense q_decay must be in (0, 1], got {self.q_decay}")
        for nm in ("p_probation", "p_readmit"):
            v = getattr(self, nm)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"defense {nm} must be in [0, 1], got {v}")
        if self.clip < 0.0 or not math.isfinite(self.clip):
            raise ValueError(f"defense clip must be finite >= 0, got {self.clip}")
        if not (0.0 <= self.stale_gain <= 1.0):
            raise ValueError(
                f"defense stale_gain must be in [0, 1], got {self.stale_gain}")
        if self.detector not in DETECTORS:
            raise ValueError(
                f"defense detector must be one of {DETECTORS}, got "
                f"{self.detector!r}")
        if not (0.0 < self.learned_lr <= 10.0):
            raise ValueError(
                f"defense learned_lr must be in (0, 10], got {self.learned_lr}")
        if self.d_sketch < 8:
            raise ValueError(
                f"defense d_sketch must be >= 8 (a narrower sketch aliases "
                f"honest directions into cliques), got {self.d_sketch}")
        if not (0.0 < self.sketch_ewma <= 1.0):
            raise ValueError(
                f"defense sketch_ewma must be in (0, 1], got "
                f"{self.sketch_ewma}")
        if not (0.0 < self.clique_thresh < 1.0):
            raise ValueError(
                f"defense clique_thresh must be in (0, 1), got "
                f"{self.clique_thresh}")
        if self.clique_min_obs < 1:
            raise ValueError(
                f"defense clique_min_obs must be >= 1, got "
                f"{self.clique_min_obs}")
        if self.mtd_window < 1:
            raise ValueError(
                f"defense mtd_window must be >= 1, got {self.mtd_window}")
        object.__setattr__(self, "mtd_trims", tuple(self.mtd_trims))
        if not self.mtd_trims:
            raise ValueError("defense mtd_trims must be non-empty")
        for t in self.mtd_trims:
            if not (0.0 <= t < 0.5):
                raise ValueError(
                    f"defense mtd_trims entries must be in [0, 0.5), got {t}")
        if self.mtd_families is not None:
            object.__setattr__(self, "mtd_families",
                               tuple(self.mtd_families))
            if not self.mtd:
                raise ValueError(
                    "defense mtd_families requires mtd=True (the family "
                    "ladder is driven by the mtd pressure window)")
            if len(self.mtd_families) != len(self.mtd_trims):
                raise ValueError(
                    f"defense mtd_families must have one family per rung "
                    f"of mtd_trims ({len(self.mtd_trims)}), got "
                    f"{len(self.mtd_families)}")
            if self.mtd_families[0] != "base":
                raise ValueError(
                    f"defense mtd_families[0] must be 'base' (level 0 is "
                    f"bitwise the configured aggregator), got "
                    f"{self.mtd_families[0]!r}")
            for f in self.mtd_families:
                if f not in MTD_FAMILIES:
                    raise ValueError(
                        f"defense mtd_families entries must be one of "
                        f"{MTD_FAMILIES}, got {f!r}")
        if not (0.0 <= self.mtd_down <= self.mtd_up <= 1.0):
            raise ValueError(
                f"defense needs 0 <= mtd_down <= mtd_up <= 1, got "
                f"down={self.mtd_down} up={self.mtd_up}")
