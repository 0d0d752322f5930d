"""``repro_torch.engine.robust`` against ``repro.engine.robust`` on the same
cohort stacks (numpy, from a seed).

``coordinate_median`` is bitwise equal to the reference: the pick sums at
most two nonzero terms among exact zeros, so any summation order gives the
same bits. ``trimmed_mean`` and ``norm_clip`` are within rtol 1e-6 / atol
1e-7 (their sums run in another order; ``norm_clip``'s through K1's plain
version); where a rogue slot's large terms cancel in ``norm_clip``'s sum,
the atol grows by 1e-6 of the terms' magnitude, the bound ``chip_smoke.py``
holds K1 to. The ``stats`` counters are equal, an empty cohort leaves the
params bitwise, ``additive``/``stat_names`` equal the reference's for every
aggregator, and the order statistics reject staleness kwargs with the
reference's message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.engine import aggregator_names as ref_aggregator_names  # noqa: E402
from repro.engine.registry import make_aggregator as ref_make  # noqa: E402
from repro_torch.engine import aggregator_names  # noqa: E402
from repro_torch.engine.registry import make_aggregator  # noqa: E402
from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

B = 9


def _stack(seed, b=B, stacked_bases=True, rogue=None):
    rng = np.random.default_rng(seed)
    g = {"conv": {"w": rng.standard_normal((3, 3, 1, 4)).astype(np.float32),
                  "b": np.zeros(4, np.float32)},
         "fc": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32)}}
    updates = {k: {kk: (v + rng.standard_normal((b,) + v.shape)).astype(np.float32)
                   for kk, v in layer.items()} for k, layer in g.items()}
    if rogue is not None:  # one slot goes rogue with a large delta
        for layer in updates:
            for kk in updates[layer]:
                base = g[layer][kk]
                updates[layer][kk][0] = base + rogue * (updates[layer][kk][0] - base)
    bases = g
    if stacked_bases:
        bases = {k: {kk: (v + 0.1 * rng.standard_normal((b,) + v.shape))
                     .astype(np.float32) for kk, v in layer.items()}
                 for k, layer in g.items()}
    return g, updates, bases


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _run_both(name, kwargs, g, updates, bases, mask, staleness):
    ref = ref_make(name, **kwargs)
    pt = make_aggregator(name, **kwargs)
    rw = ref.weigh(jnp.asarray(mask), jnp.asarray(staleness))
    pw = pt.weigh(torch.from_numpy(mask), torch.from_numpy(staleness))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    racc = ref.accumulate(ref.init(g), updates, bases, rw)
    pacc = pt.accumulate(pt.init(_t(g)), _t(updates), _t(bases), pw)
    return (pt.finalize(_t(g), pacc), pacc), (ref.finalize(g, racc), racc)


MASKS = {
    "all_valid": np.ones(B, bool),
    "odd_count": np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool),  # 7 valid
    "even_count": np.array([1, 0, 1, 1, 0, 1, 1, 0, 1], bool),  # 6 valid
    "one_valid": np.array([0, 0, 0, 0, 1, 0, 0, 0, 0], bool),
    "two_valid": np.array([0, 1, 0, 0, 1, 0, 0, 0, 0], bool),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(got, exp, bitwise, what, scale=None):
    """Bitwise, or within rtol 1e-6 / atol 1e-7; with ``scale`` (a tree of
    sum_c |w_c d_c|, as ``chip_smoke.py`` bounds K1) the atol grows by
    1e-6 of it, for sums whose terms cancel."""
    for layer, leaves in exp.items():
        for name, val in leaves.items():
            g = _np(got[layer][name])
            if bitwise:
                assert g.tobytes() == _np(val).tobytes(), f"{what} {layer}.{name}"
                continue
            atol = 1e-7 + (0.0 if scale is None else 1e-6 * scale[layer][name])
            assert np.all(np.abs(g - _np(val)) <= 1e-6 * np.abs(_np(val)) + atol), (
                f"{what} {layer}.{name}: max diff {np.abs(g - _np(val)).max()}")


@pytest.mark.parametrize("stacked_bases", [True, False])
@pytest.mark.parametrize("mask", list(MASKS))
def test_coordinate_median_bitwise(mask, stacked_bases):
    g, updates, bases = _stack(1, stacked_bases=stacked_bases)
    (got, pacc), (exp, racc) = _run_both("coordinate_median", {}, g, updates, bases,
                                         MASKS[mask], np.zeros(B, np.int32))
    _check(got, exp, True, mask)
    _check(pacc["delta"], racc["delta"], True, f"{mask} delta")
    assert float(pacc["stats"]["unweighted"]) == float(racc["stats"]["unweighted"])
    assert float(pacc["count"]) == float(racc["count"]) == MASKS[mask].sum()


@pytest.mark.parametrize("trim", [0.0, 0.2, 0.35, 0.49])
@pytest.mark.parametrize("mask", list(MASKS))
def test_trimmed_mean_within_tolerance(mask, trim):
    g, updates, bases = _stack(2, rogue=50.0)
    (got, pacc), (exp, racc) = _run_both("trimmed_mean", {"trim": trim}, g, updates,
                                         bases, MASKS[mask], np.zeros(B, np.int32))
    _check(got, exp, False, mask)
    assert float(pacc["stats"]["unweighted"]) == float(racc["stats"]["unweighted"])


@pytest.mark.parametrize("stacked_bases", [True, False])
@pytest.mark.parametrize("clip", [0.5, 3.0, 1e3])
def test_norm_clip_within_tolerance(clip, stacked_bases):
    g, updates, bases = _stack(3, stacked_bases=stacked_bases, rogue=1000.0)
    mask = MASKS["odd_count"]
    staleness = np.random.default_rng(4).integers(0, 5, B).astype(np.int32)
    before = k1.launches
    (got, pacc), (exp, racc) = _run_both("norm_clip", {"clip": clip}, g, updates,
                                         bases, mask, staleness)
    assert k1.launches == before  # the CPU takes K1's plain version
    # the magnitude of each coordinate's terms, clipped weights included
    ws = make_aggregator("norm_clip", clip=clip).weigh(
        torch.from_numpy(mask), torch.from_numpy(staleness)).numpy()
    deltas = {k: {kk: updates[k][kk].astype(np.float64) - bases[k][kk]
                  for kk in updates[k]} for k in updates}
    norm = np.sqrt(sum((d.reshape(B, -1) ** 2).sum(1)
                       for layer in deltas.values() for d in layer.values()))
    wc = ws * np.minimum(1.0, clip / np.maximum(norm, 1e-12))
    terms = {k: {kk: (np.abs(wc).reshape((-1,) + (1,) * (d.ndim - 1)) * np.abs(d)).sum(0)
                 for kk, d in layer.items()} for k, layer in deltas.items()}
    per_param = {k: {kk: v / float(racc["wsum"]) for kk, v in layer.items()}
                 for k, layer in terms.items()}
    _check(got, exp, False, f"clip {clip}", per_param)
    _check(pacc["dsum"], racc["dsum"], False, "dsum", terms)
    np.testing.assert_allclose(float(pacc["wsum"]), float(racc["wsum"]), rtol=1e-6)
    assert float(pacc["stats"]["clipped"]) == float(racc["stats"]["clipped"])
    if clip < 1e3:
        assert float(pacc["stats"]["clipped"]) >= 1


def test_norm_clip_bounds_a_scaled_attacker():
    g, updates, _ = _stack(4, rogue=1000.0)
    agg = make_aggregator("norm_clip", clip=1.0, staleness_mode="const")
    w = agg.weigh(torch.from_numpy(MASKS["all_valid"]), torch.zeros(B, dtype=torch.int32))
    out = agg.finalize(_t(g), agg.accumulate(agg.init(_t(g)), _t(updates), _t(g), w))
    norm = np.sqrt(sum(((out[k][kk].numpy() - g[k][kk]) ** 2).sum()
                       for k in g for kk in g[k]))
    assert norm <= 1.0 + 1e-5


@pytest.mark.parametrize("name", ["norm_clip", "trimmed_mean", "coordinate_median"])
def test_empty_cohort_leaves_params_bitwise(name):
    g, updates, bases = _stack(5)
    none = np.zeros(B, bool)
    (got, pacc), (exp, racc) = _run_both(name, {}, g, updates, bases, none,
                                         np.zeros(B, np.int32))
    _check(got, g, True, "empty")
    _check(exp, g, True, "empty (reference)")
    for key, val in racc["stats"].items():
        assert float(pacc["stats"][key]) == float(val) == 0.0


@pytest.mark.parametrize("name", ["fedavg", "fedbuff", "fedprox", "norm_clip",
                                  "trimmed_mean", "coordinate_median"])
def test_additive_and_stat_names_equal_the_reference(name):
    # every port aggregator is one of the reference's (whose registry may
    # also hold aggregators that other test files register)
    assert set(aggregator_names()) <= set(ref_aggregator_names())
    assert name in aggregator_names()
    pt, ref = make_aggregator(name), ref_make(name)
    assert (pt.name, pt.additive, pt.stat_names) == (ref.name, ref.additive,
                                                      ref.stat_names)
    g, _, _ = _stack(6)
    acc = pt.init(_t(g))
    assert sorted(acc.get("stats", {})) == sorted(ref.stat_names)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name,kwargs", [
    ("trimmed_mean", {"staleness_mode": "poly"}),
    ("trimmed_mean", {"staleness_exp": 0.5}),
    ("coordinate_median", {"staleness_mode": "const", "staleness_exp": 1.0}),
    ("trimmed_mean", {"trim": 0.5}),
    ("trimmed_mean", {"trim": -0.1}),
    ("norm_clip", {"clip": 0.0}),
])
def test_bad_kwargs_rejected_as_the_reference(name, kwargs):
    got = _message(lambda: make_aggregator(name, **kwargs))
    assert got is not None and got == _message(lambda: ref_make(name, **kwargs))
