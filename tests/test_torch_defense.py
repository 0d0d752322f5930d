"""The port's defense modules (``repro_torch.defense``) against the
reference's, function by function, on the same numpy inputs.

* ``DefenseConfig`` (copied) and ``RunConfig``'s defense checks: the same
  validation messages, mtd under a tiered topology included;
* ``ewma_scatter_update(_rows)``: duplicates, an out-of-range and a
  negative index, under JAX's gather/scatter index rules;
* ``_slot_channels``/``_slot_scores`` with stacked (async) and unstacked
  (sync) bases (the robust center is K1's plain route here);
* collusion: the ``_projection`` constants bitwise, ``project_deltas``
  within rtol 1e-5 of the reference's ``segment_sum`` (the port sums each
  bucket in a fixed order), ``clique_scores``' values, its exact
  permutation equivariance and its self-pair guard;
* the learned head: ``feature_matrix``, ``learned_observe``,
  ``auc_from_hist``;
* the mtd ladders: each rung against the reference's function of the same
  name (not the registry twin), both ladder shapes at every level, and
  level 0 bitwise the base rule's params;
* one ``Defense.observe`` step with the reference's fold-108 coins
  replayed: ``status`` and the counters exact, ``rep`` close.

Tolerances: f32 sums in other orders — rtol 1e-5 and atol 1e-6, except
for the anomaly scores and the reputation they feed (atol 1e-5): the
cosine channel divides cosines, each good to about 1e-7 in f32, by a MAD
scale floored at 0.05, which amplifies an ordering difference up to 20x.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.defense.adaptive as ref_adaptive  # noqa: E402
import repro.defense.collusion as ref_collusion  # noqa: E402
import repro.defense.learned as ref_learned  # noqa: E402
import repro.defense.reputation as ref_reputation  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.defense import DefenseConfig as RefDefenseConfig  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine.aggregators import acc_stats as ref_acc_stats  # noqa: E402
from repro.engine.registry import make_aggregator as ref_make_aggregator  # noqa: E402
import repro_torch.defense.adaptive as pt_adaptive  # noqa: E402
import repro_torch.defense.collusion as pt_collusion  # noqa: E402
import repro_torch.defense.learned as pt_learned  # noqa: E402
import repro_torch.defense.reputation as pt_reputation  # noqa: E402
from repro_torch.core import load_metric as pt_lm  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.defense import DefenseConfig  # noqa: E402
from repro_torch.engine import RunConfig  # noqa: E402
from repro_torch.engine.aggregators import acc_stats  # noqa: E402
from repro_torch.engine.registry import make_aggregator  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(got, exp, what="", **tol):
    np.testing.assert_allclose(_np(got), np.asarray(exp), err_msg=what, **(tol or TOL))


# ---------------------------------------------------------------------------
# (1) config: the copied DefenseConfig and RunConfig's checks
# ---------------------------------------------------------------------------

BAD_DEFENSE = [
    dict(threshold=0.0), dict(ewma=0.0), dict(q_decay=1.5), dict(p_probation=-0.1),
    dict(p_readmit=2.0), dict(clip=-1.0), dict(clip=math.inf), dict(stale_gain=1.5),
    dict(detector="oracle"), dict(learned_lr=0.0), dict(d_sketch=4),
    dict(sketch_ewma=1.5), dict(clique_thresh=1.0), dict(clique_min_obs=0),
    dict(mtd_window=0), dict(mtd_trims=()), dict(mtd_trims=(0.0, 0.6)),
    dict(mtd_families=("base", "trimmed_mean")),
    dict(mtd=True, mtd_families=("base",)),
    dict(mtd=True, mtd_trims=(0.0, 0.2), mtd_families=("trimmed_mean", "base")),
    dict(mtd=True, mtd_trims=(0.0, 0.2), mtd_families=("base", "krum")),
    dict(mtd_up=0.05, mtd_down=0.1),
]


@pytest.mark.parametrize("kw", BAD_DEFENSE, ids=lambda kw: ",".join(kw))
def test_defense_config_messages_equal(kw):
    with pytest.raises(ValueError) as ref_err:
        RefDefenseConfig(**kw)
    with pytest.raises(ValueError) as pt_err:
        DefenseConfig(**kw)
    assert str(pt_err.value) == str(ref_err.value)


def test_defense_config_fields_and_constants_equal():
    import dataclasses

    from repro.defense import config as ref_config
    from repro_torch.defense import config as pt_config

    assert ([(f.name, f.default) for f in dataclasses.fields(DefenseConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(RefDefenseConfig)])
    assert pt_config.DETECTORS == ref_config.DETECTORS
    assert pt_config.MTD_FAMILIES == ref_config.MTD_FAMILIES
    full = dict(detector="learned", collusion=True, mtd=True,
                mtd_families=["base", "coordinate_median"], mtd_trims=[0.0, 0.2])
    assert dataclasses.asdict(DefenseConfig(**full)) == dataclasses.asdict(
        RefDefenseConfig(**full))


BAD_RUN = [
    dict(defense_kwargs={"threshold": 0.5}),
    dict(defense=True, defense_kwargs={"threshold": -1.0}),
    dict(defense=True, defense_kwargs={"colusion": True}),
    dict(defense=True, defense_kwargs={"mtd": True}, topology="hierarchical",
         topology_kwargs={"tiers": (4,)}),
    dict(defense=True, defense_kwargs={"mtd": True}, topology="gossip",
         topology_kwargs={"nodes": 4}),
]


@pytest.mark.parametrize("kw", BAD_RUN, ids=range(len(BAD_RUN)))
def test_run_config_defense_messages_equal(kw):
    base = dict(n_clients=16, k=4, m=4, mode="async", buffer_size=3)
    with pytest.raises(ValueError) as ref_err:
        RefRunConfig(**base, **kw)
    with pytest.raises(ValueError) as pt_err:
        RunConfig(**base, **kw)
    assert str(pt_err.value) == str(ref_err.value)


def test_run_config_resolves_defense_as_the_reference():
    kw = dict(n_clients=16, k=4, defense=True,
              defense_kwargs={"threshold": 0.4, "mtd": True, "mtd_window": 3})
    assert RunConfig(**kw).resolved_defense() == DefenseConfig(**kw["defense_kwargs"])
    assert RunConfig().resolved_defense() is None
    # reputation and quarantine alone ride a tiered topology, as in the reference
    tiered = dict(kw, defense_kwargs={"threshold": 0.4}, topology="hierarchical",
                  topology_kwargs={"tiers": (4,)})
    assert RunConfig(**tiered).resolved_defense().threshold == 0.4
    assert RefRunConfig(**tiered).resolved_defense().threshold == 0.4
    # meshes and cohort sharding (slice F) are validated as the reference
    # validates them: under sync both raise, with its messages
    for later in (dict(mesh_shards=2), dict(shard_cohort=True)):
        with pytest.raises(ValueError) as ref:
            RefRunConfig(**kw, **later)
        with pytest.raises(ValueError) as got:
            RunConfig(**kw, **later)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# (2) the scatter-EWMAs
# ---------------------------------------------------------------------------

SCATTER_CASES = {
    "duplicate_and_pad": ([1, 1, 3, 99], [True, True, True, False]),
    "out_of_range_valid": ([0, 99, 2, 3], [True, True, True, True]),
    "negative_wraps": ([-1, 0, -5, 2], [True, True, True, True]),
    "all_masked": ([1, 1, 3, 99], [False] * 4),
}


@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_ewma_scatter_update_equals_reference(case):
    idx, mask = SCATTER_CASES[case]
    rng = np.random.default_rng(1)
    vec = rng.standard_normal(4).astype(np.float32)
    vals = rng.standard_normal(4).astype(np.float32)
    exp = ref_lm.ewma_scatter_update(_j(vec), _j(np.asarray(idx, np.int32)), _j(vals),
                                     _j(mask), 0.5)
    got = pt_lm.ewma_scatter_update(_t(vec), torch.tensor(idx), _t(vals),
                                    torch.tensor(mask), 0.5)
    assert _np(got).tobytes() == np.asarray(exp).tobytes()
    rows = rng.standard_normal((4, 3)).astype(np.float32)
    mat = rng.standard_normal((4, 3)).astype(np.float32)
    exp = ref_lm.ewma_scatter_update_rows(_j(mat), _j(np.asarray(idx, np.int32)),
                                          _j(rows), _j(mask), 0.25)
    got = pt_lm.ewma_scatter_update_rows(_t(mat), torch.tensor(idx), _t(rows),
                                         torch.tensor(mask), 0.25)
    assert _np(got).tobytes() == np.asarray(exp).tobytes()


def test_ewma_scatter_update_reference_values():
    """``tests/test_defense.py``'s case: duplicate slots both add their
    step, the masked out-of-range pad writes nothing."""
    out = pt_lm.ewma_scatter_update(torch.zeros(4), torch.tensor([1, 1, 3, 99]),
                                    torch.tensor([1.0, 1.0, 0.5, 7.0]),
                                    torch.tensor([True, True, True, False]), 0.5)
    np.testing.assert_allclose(_np(out), [0.0, 1.0, 0.0, 0.25])
    # a masked in-range slot adds +0.0 (as the reference's does: -0.0 turns
    # +0.0); an out-of-range slot adds nothing, not even to a -0.0
    vec = np.asarray([-0.0, 0.5, -0.0, -0.0], np.float32)
    idx, mask = np.asarray([0, 1, 99, -7], np.int32), np.asarray([False, False, True, True])
    got = pt_lm.ewma_scatter_update(_t(vec), _t(idx).long(), torch.ones(4), _t(mask), 0.5)
    exp = ref_lm.ewma_scatter_update(_j(vec), _j(idx), jnp.ones(4), _j(mask), 0.5)
    assert _np(got).tobytes() == np.asarray(exp).tobytes()
    assert _np(got).tobytes() == np.asarray([0.0, 0.5, -0.0, -0.0], np.float32).tobytes()


# ---------------------------------------------------------------------------
# (3) per-slot scores
# ---------------------------------------------------------------------------

SHAPES = {"conv": {"w": (3, 3, 1, 4), "b": (4,)}, "fc": {"w": (12, 5), "b": (5,)}}


def _cohort(b=8, seed=0, stacked=True, attackers=(0,), scale=-3.0):
    """A cohort of honest deltas around a shared direction with attacker
    slots scaled by ``scale``; ``bases`` stacked (B, ...) or not."""
    rng = np.random.default_rng(seed)
    g = _tree(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES)
    drift = _tree(lambda s: 0.05 * rng.standard_normal(s).astype(np.float32), SHAPES)

    def upd(gl, dl):
        d = dl[None] + 0.03 * rng.standard_normal((b,) + gl.shape).astype(np.float32)
        d[list(attackers)] *= scale
        return (gl[None] + d).astype(np.float32)

    updated = {k: {n: upd(g[k][n], drift[k][n]) for n in g[k]} for k in g}
    bases = (_tree(lambda x: np.broadcast_to(x, (b,) + x.shape).copy(), g)
             if stacked else g)
    return updated, bases


VALIDS = {"all": [True] * 8, "partial": [True, True, False, True, True, True, False, True],
          "one": [True] + [False] * 7, "none": [False] * 8}


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("valid", list(VALIDS))
def test_slot_channels_and_scores_equal(stacked, valid):
    updated, bases = _cohort(stacked=stacked, attackers=(0, 5))
    v = np.asarray(VALIDS[valid])
    exp = ref_reputation._slot_channels(_tree(_j, updated), _tree(_j, bases), _j(v))
    got = pt_reputation._slot_channels(_tree(_t, updated), _tree(_t, bases), _t(v))
    for name, g, e in zip(("s_norm", "s_dir", "norm"), got, exp):
        _close(g, e, name, **SCORE_TOL)
    stale = np.arange(8, dtype=np.int32)
    for cfg in (dict(), dict(stale_gain=0.5, clip=1.0)):
        exp = ref_reputation._slot_scores(_tree(_j, updated), _tree(_j, bases), _j(v),
                                          _j(stale), RefDefenseConfig(**cfg))
        got = pt_reputation._slot_scores(_tree(_t, updated), _tree(_t, bases), _t(v),
                                         _t(stale), DefenseConfig(**cfg))
        _close(got, exp, str(cfg), **SCORE_TOL)
    if valid == "all":
        scores = _np(got)
        assert scores[[0, 5]].min() > np.delete(scores, [0, 5]).max()


# ---------------------------------------------------------------------------
# (4) collusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_sketch", [8, 16, 64])
def test_projection_constants_bitwise(d_sketch):
    shapes = ((3, 3, 1, 4), (4,), (12, 5), (5,), ())
    got = pt_collusion._projection(shapes, d_sketch)
    exp = ref_collusion._projection(shapes, d_sketch)
    assert pt_collusion.PROJECTION_SEED == ref_collusion.PROJECTION_SEED
    for (gh, gs), (eh, es) in zip(got, exp):
        assert gh.dtype == eh.dtype and gh.tobytes() == eh.tobytes()
        assert gs.dtype == es.dtype and gs.tobytes() == es.tobytes()
    for name in ("RESID_GATE", "CENTER_GATE", "FLIP_HALF"):
        assert getattr(pt_collusion, name) == getattr(ref_collusion, name)


def test_bucket_plan_lists_each_bucket_in_column_order():
    h = np.asarray([2, 0, 2, 1, 0, 2, 3, 0], np.int32)
    plan = pt_collusion._bucket_plan(h, 5)
    assert plan.shape == (5, 3)
    np.testing.assert_array_equal(plan, [[1, 4, 7], [3, 8, 8], [0, 2, 5], [6, 8, 8],
                                         [8, 8, 8]])


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("d_sketch", [8, 64])
def test_project_deltas_equals_segment_sum(stacked, d_sketch):
    updated, bases = _cohort(stacked=stacked, seed=3)
    updated["fc"]["b"][2] = (bases["fc"]["b"][2] if stacked else bases["fc"]["b"])
    exp = ref_collusion.project_deltas(_tree(_j, updated), _tree(_j, bases), d_sketch)
    got = pt_collusion.project_deltas(_tree(_t, updated), _tree(_t, bases), d_sketch)
    _close(got, exp)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=1), 1.0, rtol=1e-5)


def test_project_deltas_zero_delta_is_a_zero_row():
    updated, bases = _cohort(b=4, seed=3)
    updated = {k: {n: np.where(np.arange(4).reshape((-1,) + (1,) * (u.ndim - 1)) == 2,
                               bases[k][n], u) for n, u in v.items()}
               for k, v in updated.items()}
    rows = _np(pt_collusion.project_deltas(_tree(_t, updated), _tree(_t, bases), 16))
    np.testing.assert_array_equal(rows[2], np.zeros(16, np.float32))


def _clique_inputs(seed, b=12, d=32, n_colluders=3):
    """``tests/test_collusion.py``'s regime: honest histories share a loose
    consensus, the first ``n_colluders`` rows a tight poison direction."""
    rng = np.random.default_rng(seed)
    consensus = rng.standard_normal(d).astype(np.float32)
    poison = rng.standard_normal(d).astype(np.float32)
    hists = np.stack(
        [poison + 0.05 * rng.standard_normal(d).astype(np.float32)
         for _ in range(n_colluders)]
        + [consensus + 0.6 * rng.standard_normal(d).astype(np.float32)
           for _ in range(b - n_colluders)])
    obs = np.full((b,), 5.0, np.float32)
    obs[-1] = 1.0  # one history not seen often enough
    valid = np.ones((b,), bool)
    valid[-2] = False
    return hists, obs, valid, np.arange(b, dtype=np.int32)


def _clique(mod, cfg_cls, hists, obs, valid, idx, conv):
    cfg = cfg_cls(collusion=True, clique_min_obs=2)
    return [_np(x) for x in mod.clique_scores(conv(hists), conv(obs), conv(valid),
                                              conv(idx), cfg)]


@pytest.mark.parametrize("seed", range(4))
def test_clique_scores_equal_and_permutation_equivariant(seed):
    hists, obs, valid, idx = _clique_inputs(seed)
    got = _clique(pt_collusion, DefenseConfig, hists, obs, valid, idx, _t)
    exp = _clique(ref_collusion, RefDefenseConfig, hists, obs, valid, idx, _j)
    for g, e in zip(got, exp):
        _close(g, e)
    perm = np.random.default_rng(seed + 1).permutation(len(idx))
    permuted = _clique(pt_collusion, DefenseConfig, hists[perm], obs[perm], valid[perm],
                       idx[perm], _t)
    for g, p in zip(got, permuted):
        assert g[perm].tobytes() == p.tobytes()  # exactly, not within an ulp
    if seed == 0:
        assert got[0][:3].min() > 0.5 and got[0][3:].max() < 0.2


def test_clique_scores_never_self_pair():
    hists, obs, valid, idx = _clique_inputs(3, n_colluders=2)
    idx[1] = idx[0]  # the "coalition" is one client popped twice
    s_clique, _ = _clique(pt_collusion, DefenseConfig, hists, obs, valid, idx, _t)
    assert s_clique.max() < 0.2
    exp, _ = _clique(ref_collusion, RefDefenseConfig, hists, obs, valid, idx, _j)
    _close(s_clique, exp)


def test_flip_channel_equals_reference():
    rng = np.random.default_rng(11)
    consensus = rng.standard_normal(32).astype(np.float32)
    hists = np.stack([consensus + 0.3 * rng.standard_normal(32).astype(np.float32)
                      for _ in range(7)] + [-consensus])
    args = (hists, np.full((8,), 5.0, np.float32), np.ones(8, bool),
            np.arange(8, dtype=np.int32))
    got = _clique(pt_collusion, DefenseConfig, *args, _t)
    exp = _clique(ref_collusion, RefDefenseConfig, *args, _j)
    _close(got[1], exp[1])
    assert got[1][-1] > 0.8


def test_collusion_observe_equals_reference():
    updated, bases = _cohort(stacked=True, seed=5, attackers=(1, 4))
    n, d = 10, 16
    rng = np.random.default_rng(6)
    state = {"sketch": rng.standard_normal((n, d)).astype(np.float32),
             "sk_obs": np.asarray([0, 3, 1, 5, 2, 0, 4, 3, 1, 2], np.float32),
             "clique_hits": np.float32(2.0)}
    idx = np.asarray([1, 3, 4, 6, 7, 9, 0, 0], np.int32)
    valid = np.asarray([True, True, True, True, True, True, False, False])
    exp_state, *exp = ref_collusion.collusion_observe(
        _tree(_j, state), _tree(_j, updated), _tree(_j, bases), _j(idx), _j(valid),
        RefDefenseConfig(collusion=True, d_sketch=d, clique_min_obs=2))
    got_state, *got = pt_collusion.collusion_observe(
        _tree(_t, state), _tree(_t, updated), _tree(_t, bases), _t(idx).long(),
        _t(valid), DefenseConfig(collusion=True, d_sketch=d, clique_min_obs=2))
    _close(got_state["sketch"], exp_state["sketch"])
    assert _np(got_state["sk_obs"]).tobytes() == np.asarray(exp_state["sk_obs"]).tobytes()
    assert float(got_state["clique_hits"]) == float(exp_state["clique_hits"])
    for g, e in zip(got, exp):
        _close(g, e)


# ---------------------------------------------------------------------------
# (5) the learned head
# ---------------------------------------------------------------------------


def _feature_inputs(seed=0, b=8):
    rng = np.random.default_rng(seed)
    f = lambda: rng.random(b).astype(np.float32)  # noqa: E731
    return dict(s_norm=f(), s_dir=f(), s_clique=f(), s_flip=f(),
                staleness=rng.integers(0, 5, b).astype(np.int32),
                ages=rng.integers(-1, 9, b).astype(np.int32),
                losses=(rng.random(b) * 3).astype(np.float32),
                valid=np.asarray([True] * 6 + [False] * 2))


@pytest.mark.parametrize("drop", [(), ("ages",), ("losses",), ("ages", "losses")])
def test_feature_matrix_equals_reference(drop):
    kw = _feature_inputs()
    exp = ref_learned.feature_matrix(**{k: None if k in drop else _j(v)
                                        for k, v in kw.items()})
    got = pt_learned.feature_matrix(**{k: None if k in drop else _t(v)
                                       for k, v in kw.items()})
    assert tuple(got.shape) == (8, pt_learned.N_FEATURES)
    _close(got, exp)


def test_learned_observe_equals_reference_over_steps():
    cfg = dict(detector="learned", learned_lr=1.0)
    rng = np.random.default_rng(4)
    zeros = {"lw": np.zeros((1, 8), np.float32), "auc": np.zeros((2, 16), np.float32)}
    ref_state, pt_state = _tree(_j, zeros), _tree(_t, zeros)
    valid = np.asarray([True] * 7 + [False])
    for step in range(30):
        feats = (rng.random((8, 8)) * 0.2).astype(np.float32)
        labels = np.zeros(8, bool)
        labels[:2] = True
        feats[:2, 2] = 0.9
        feats[:, 7] = 1.0
        ref_state, exp = ref_learned.learned_observe(ref_state, _j(feats), _j(valid),
                                                     _j(labels), RefDefenseConfig(**cfg))
        pt_state, got = pt_learned.learned_observe(pt_state, _t(feats), _t(valid),
                                                   _t(labels), DefenseConfig(**cfg))
        _close(got, exp, f"p {step}")
        _close(pt_state["lw"], ref_state["lw"], f"lw {step}")
        np.testing.assert_array_equal(_np(pt_state["auc"]), np.asarray(ref_state["auc"]))
    assert pt_learned.auc_from_hist(_np(pt_state["auc"])) > 0.85
    # cold start: sigmoid(0) = 0.5 scores, below the default threshold
    _, p = pt_learned.learned_observe(_tree(_t, zeros), _t(feats), _t(valid),
                                      _t(labels), DefenseConfig(**cfg))
    np.testing.assert_allclose(_np(p), 0.5)


@pytest.mark.parametrize("case", ["empty", "perfect", "ties", "random"])
def test_auc_from_hist_equals_reference(case):
    hist = np.zeros((2, 16))
    if case == "perfect":
        hist[0, 12], hist[1, 2] = 3.0, 5.0
    elif case == "ties":
        hist[0, 8] = hist[1, 8] = 2.0
    elif case == "random":
        hist = np.random.default_rng(0).integers(0, 9, (2, 16)).astype(np.float32)
    got, exp = pt_learned.auc_from_hist(hist), ref_learned.auc_from_hist(hist)
    assert got == exp or (math.isnan(got) and math.isnan(exp))


# ---------------------------------------------------------------------------
# (6) the mtd ladders
# ---------------------------------------------------------------------------


def _ladder_inputs(seed=3, b=8, stacked=False):
    updated, bases = _cohort(b=b, seed=seed, stacked=stacked, attackers=(2,), scale=8.0)
    g = bases if not stacked else _tree(lambda x: x[0].copy(), bases)
    w = np.asarray([1.0, 0.5, 1.0, 0.0, 1.0, 0.7, 1.0, 1.0], np.float32)
    return g, updated, bases, w


RUNGS = [("_trimmed_mean_delta", (0.2,)), ("_trimmed_mean_delta", (0.35,)),
         ("_coordinate_median_delta", ()), ("_norm_clip_delta", ())]


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("weights", ["mixed", "empty"])
@pytest.mark.parametrize("rung,extra", RUNGS, ids=lambda x: str(x))
def test_each_rung_equals_the_reference_function(rung, extra, stacked, weights):
    g, updated, bases, w = _ladder_inputs(stacked=stacked)
    if weights == "empty":
        w = np.zeros_like(w)
    exp = getattr(ref_adaptive, rung)(_tree(_j, g), _tree(_j, updated), _tree(_j, bases),
                                      _j(w), *extra)
    got = getattr(pt_adaptive, rung)(_tree(_t, g), _tree(_t, updated), _tree(_t, bases),
                                     _t(w), *extra)
    for k in exp:
        for n in exp[k]:
            _close(got[k][n], exp[k][n], f"{rung} {k}.{n}")
    if weights == "empty":  # params stand
        for k in g:
            for n in g[k]:
                assert _np(got[k][n]).tobytes() == g[k][n].tobytes()


def _base_apply(make, accs):
    agg = make("fedavg")

    def base_apply(gp, u, b, wv, ix):
        acc = agg.accumulate(agg.init(gp), u, b, wv)
        return agg.finalize(gp, acc), accs(acc)

    return base_apply


LADDERS = {"trims": ((0.0, 0.1, 0.2, 0.35), None),
           "families": ((0.0, 0.2, 0.0, 0.0),
                        ("base", "trimmed_mean", "coordinate_median", "norm_clip"))}


@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("level", [0, 1, 2, 3, 9])
def test_adaptive_aggregate_equals_reference(ladder, level):
    trims, families = LADDERS[ladder]
    g, updated, bases, w = _ladder_inputs()
    idx = np.arange(8, dtype=np.int32)
    ref_apply = ref_adaptive.adaptive_aggregate(
        _base_apply(ref_make_aggregator, ref_acc_stats), trims, families=families)
    pt_base = _base_apply(make_aggregator, acc_stats)
    pt_apply = pt_adaptive.adaptive_aggregate(pt_base, trims, families=families)
    exp, _ = ref_apply(_tree(_j, g), _tree(_j, updated), _tree(_j, bases), _j(w), _j(idx),
                       jnp.int32(level))
    args = (_tree(_t, g), _tree(_t, updated), _tree(_t, bases), _t(w), _t(idx))
    got, _ = pt_apply(*args, level)
    for k in exp:
        for n in exp[k]:
            _close(got[k][n], exp[k][n], f"level {level} {k}.{n}")
    if level == 0:  # bitwise the base rule within the port
        base, _ = pt_base(*args)
        for k in base:
            for n in base[k]:
                assert torch.equal(got[k][n], base[k][n])


# ---------------------------------------------------------------------------
# (7) one Defense.observe step with replayed coins
# ---------------------------------------------------------------------------

OBSERVE_CFGS = {
    "zscore_mtd": dict(threshold=0.3, p_probation=0.5, p_readmit=0.5, mtd=True,
                       mtd_window=1, mtd_up=0.05, mtd_down=0.01),
    "collusion_learned": dict(threshold=0.3, p_probation=0.5, p_readmit=0.5,
                              collusion=True, detector="learned", clique_min_obs=1,
                              d_sketch=16),
}


@pytest.mark.parametrize("name", list(OBSERVE_CFGS))
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_observe_with_replayed_coins_equals_reference(name, stacked):
    kw = OBSERVE_CFGS[name]
    n, b = 12, 8
    rng = np.random.default_rng(7)
    ref_def = ref_reputation.Defense(n, RefDefenseConfig(**kw))
    pt_def = pt_reputation.Defense(n, DefenseConfig(**kw))
    state = {k: np.asarray(v) for k, v in ref_def.init().items()}
    state["status"] = np.asarray([0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 0, 2], np.int32)
    state["rep"] = rng.random(n).astype(np.float32) * 0.6
    state["quarantined"] = np.float32(3.0)
    if "sketch" in state:
        state["sketch"] = rng.standard_normal((n, 16)).astype(np.float32)
        state["sk_obs"] = rng.integers(0, 4, n).astype(np.float32)
    updated, bases = _cohort(b=b, seed=8, stacked=stacked, attackers=(0, 3))
    idx = np.asarray([0, 2, 3, 5, 7, 8, 11, 0], np.int32)
    valid = np.asarray([True] * 7 + [False])
    stale = np.asarray([0, 1, 0, 2, 0, 0, 3, 0], np.int32)
    losses = (rng.random(b) * 2).astype(np.float32)
    ages = rng.integers(0, 6, b).astype(np.int32)
    key = jax.random.PRNGKey(3)
    exp_state, exp_excl, exp_ws = ref_def.observe(
        _tree(_j, state), key, _tree(_j, updated), _tree(_j, bases), _j(idx), _j(valid),
        _j(stale), losses=_j(losses), ages=_j(ages))
    coins = {"defense/probation": np.asarray(jax.random.uniform(
                 jax.random.fold_in(key, 0), (n,))),
             "defense/readmit": np.asarray(jax.random.uniform(
                 jax.random.fold_in(key, 1), (n,)))}
    draws = ReplayDraws({}, [coins], "cpu").step(0).sub("defense")
    got_state, got_excl, got_ws = pt_def.observe(
        _tree(_t, state), draws, _tree(_t, updated), _tree(_t, bases),
        _t(idx).long(), _t(valid), _t(stale), losses=_t(losses), ages=_t(ages))
    assert sorted(got_state) == sorted(exp_state)
    for key_ in got_state:
        g, e = _np(got_state[key_]), np.asarray(exp_state[key_])
        assert g.dtype == e.dtype and g.shape == e.shape, key_
        if key_ == "rep":
            _close(g, e, key_, **SCORE_TOL)
        elif key_ in ("sketch", "lw"):
            _close(g, e, key_)
        else:
            np.testing.assert_array_equal(g, e, err_msg=key_)
    np.testing.assert_array_equal(_np(got_excl), np.asarray(exp_excl))
    if exp_ws is None:
        assert got_ws is None
    else:
        _close(got_ws, exp_ws)
    # the step moved clients along every edge of the chain
    before, after = state["status"], _np(got_state["status"])
    assert ((before == 0) & (after == 1)).any() and ((before == 1) & (after == 2)).any()
    assert ((before == 2) & (after != 2)).any()
    assert pt_def.report(got_state) == ref_def.report(exp_state) or name != "zscore_mtd"
