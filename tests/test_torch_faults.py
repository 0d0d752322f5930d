"""``repro_torch.faults`` against ``repro.faults`` on the same inputs.

The registry and its validation messages, fault by fault; the fault set's
hooks under replayed coins (the reference's ``bernoulli`` is ``uniform <
rate``, so the port is fed the reference's uniforms): hit masks, state and
effects exact; ``Effects`` merge, identity and ``effects_hit`` exact;
``corrupt_updates`` and ``collude_updates`` with missed slots bitwise and
hit slots within rtol 1e-6 (on fed noise; exp, sums of squares and fused
multiply-adds may round differently by an ulp, so where ``base + delta``
cancels the bound is 1e-6 of the leaf's scale); ``_collude_direction``
bitwise.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as ref_faults  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.faults import inject as ref_inject  # noqa: E402
from repro_torch import faults as pt_faults  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.engine import RunConfig  # noqa: E402
from repro_torch.faults import inject as pt_inject  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N, B = 24, 8
ENGINE_FAULTS = ("collude", "corrupt", "dropout", "scale_attack", "sign_flip",
                 "stale_replay", "straggler")


def _public(names):
    return [n for n in names if not n.startswith("_")]  # tests register "_..."


def test_registry_equals_the_reference():
    assert pt_faults.BUILTIN_FAULTS == ref_faults.BUILTIN_FAULTS
    assert _public(pt_faults.known_fault_names()) == _public(ref_faults.known_fault_names())
    assert _public(pt_faults.fault_names()) == _public(ref_faults.fault_names())
    assert set(pt_faults.fault_names()) >= set(pt_faults.BUILTIN_FAULTS)
    with pytest.raises(ValueError, match="unknown fault 'nope'.*registered"):
        pt_faults.make_fault("nope", N, 0.1)
    from repro_torch.faults import registry

    try:
        pt_faults.register_fault("_test_dup_port")(lambda n, rate: None)
        with pytest.raises(ValueError, match="already registered"):
            pt_faults.register_fault("_test_dup_port")(lambda n, rate: None)
        assert "_test_dup_port" in pt_faults.known_fault_names()
    finally:
        registry._FAULTS.pop("_test_dup_port", None)


def _message(fn):
    """The ValueError's message, with the names that tests register
    (``_...``) dropped from a ``registered:`` list."""
    try:
        fn()
    except ValueError as e:
        return re.sub(r"\b_\w+, ", "", str(e))
    return None


BAD_KWARGS = {
    "collude": [{"jitter": -1.0}, {"client_frac": 1.5}],
    "corrupt": [{"sigma": 0.0}, {"client_frac": -0.1}],
    "dropout": [{"client_frac": 2.0}],
    "scale_attack": [{"factor": 1.0}],
    "sign_flip": [{"client_frac": 1.01}],
    "stale_replay": [{"shift": 0}],
    "straggler": [{"stall": 0.0}],
    "replica_crash": [],
}


@pytest.mark.parametrize("name", sorted(BAD_KWARGS))
def test_fault_validation_messages_equal_the_reference(name):
    for rate in (-0.1, 1.5):
        got = _message(lambda: pt_faults.make_fault(name, N, rate))
        assert got is not None and got == _message(
            lambda: ref_faults.make_fault(name, N, rate))
    for kw in BAD_KWARGS[name]:
        got = _message(lambda: pt_faults.make_fault(name, N, 0.1, **kw))
        assert got is not None and got == _message(
            lambda: ref_faults.make_fault(name, N, 0.1, **kw)), kw
    fault = pt_faults.make_fault(name, N, 0.3)
    ref = ref_faults.make_fault(name, N, 0.3)
    assert (fault.channels, fault.scope, fault.async_only, fault.rate) == (
        ref.channels, ref.scope, ref.async_only, ref.rate)
    assert (fault.on_pop is None, fault.on_dispatch is None) == (
        ref.on_pop is None, ref.on_dispatch is None)


CONFIG_CASES = [
    dict(faults=("nope",)),
    dict(faults="dropout, nope,corrupt"),
    dict(faults=("dropout",), fault_rate=1.5),
    dict(faults=("dropout",), fault_rate=-0.5),
    dict(faults=("dropout",), fault_kwargs={"corrupt": {"sigma": 2.0}}),
    dict(fault_kwargs={"dropout": {}}),
    dict(fault_exposure=True),
    dict(mode="sync", buffer_size=None, redispatch_timeout=5.0),
    dict(redispatch_timeout=-1.0),
    dict(redispatch_timeout=0.0),
    dict(redispatch_timeout=5.0, redispatch_retries=-1),
]


@pytest.mark.parametrize("case", CONFIG_CASES)
def test_config_validation_messages_equal_the_reference(case):
    base = dict(n_clients=N, k=4, mode="async", buffer_size=3)
    kw = {**base, **case}
    got = _message(lambda: RunConfig(**kw))
    assert got is not None and got == _message(lambda: RefRunConfig(**kw))


def test_config_accepts_the_robustness_tier():
    kw = dict(n_clients=N, k=4, mode="async", faults="dropout, corrupt",
              fault_rate=0.2, fault_kwargs={"corrupt": {"sigma": 2.0}},
              redispatch_timeout=3.0, redispatch_retries=2, fault_exposure=True)
    cfg, ref = RunConfig(**kw), RefRunConfig(**kw)
    assert cfg.fault_names() == ref.fault_names() == ("dropout", "corrupt")
    fs, rfs = cfg.resolved_faults(), ref.resolved_faults()
    assert fs.names() == rfs.names() and fs.channels == rfs.channels
    assert RunConfig(n_clients=N, k=4).resolved_faults() is None


def test_fault_set_rejects_serve_scope_and_duplicates():
    with pytest.raises(ValueError, match="serve"):
        pt_faults.FaultSet([pt_faults.make_fault("replica_crash", N, 0.1)])
    with pytest.raises(ValueError, match="duplicate"):
        pt_faults.FaultSet([pt_faults.make_fault("dropout", N, 0.1),
                            pt_faults.make_fault("dropout", N, 0.2)])


def _coins(key, name, i, shape):
    """The reference's draws for fault ``i`` of a set under ``key``."""
    ki = jax.random.fold_in(key, i)
    if name == "collude":
        return {f"{name}/hit": np.asarray(jax.random.uniform(jax.random.fold_in(ki, 0),
                                                             shape)),
                f"{name}/jitter": np.asarray(jax.random.normal(
                    jax.random.fold_in(ki, 1), shape, jnp.float32))}
    return {f"{name}/hit": np.asarray(jax.random.uniform(ki, shape))}


def _eq(got, exp, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(exp), err_msg=what)


@pytest.mark.parametrize("name", ENGINE_FAULTS)
@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_fault_hooks_equal_the_reference_on_replayed_coins(name, rate):
    """A two-fault set (``name`` second, so its draws fold 1): init, then
    the hook, with the reference's keys on one side and its uniforms fed
    to the port on the other."""
    names = ("dropout", name) if name != "dropout" else ("corrupt", name)
    rs = ref_faults.FaultSet(ref_faults.make_fault(nm, N, rate) for nm in names)
    ps = pt_faults.FaultSet(pt_faults.make_fault(nm, N, rate) for nm in names)
    k_init, k_hook = jax.random.split(jax.random.PRNGKey(3))
    init = {}
    if name == "collude":  # client_frac 0.25: the only prone draw
        init["collude/prone"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(k_init, 1), (N,)))
    rstate = rs.init(k_init)
    rng = np.random.default_rng(5)
    idx = rng.permutation(N)[:B]
    idx[-2:] = 0  # padded slots point at client 0 ...
    valid = np.ones(B, bool)
    valid[-2:] = False  # ... and are invalid
    if name == "straggler":
        shape = (N,)
        send = rng.random(N) < 0.5
        latency = rng.exponential(size=N).astype(np.float32)
    else:
        shape = (B,)
    step = {}
    for i, nm in enumerate(names):
        step.update(_coins(k_hook, nm, i, shape if nm == name else (B,)))
    draws = ReplayDraws(init, [step], "cpu")
    pstate = ps.init(draws)
    for nm in names:
        for key in ("prone", "injected", "exposed"):
            _eq(pstate[nm][key], rstate[nm][key], f"init {nm}.{key}")
    if name == "straggler":
        rstate, rlat = rs.on_dispatch(rstate, k_hook, jnp.asarray(send),
                                      jnp.asarray(latency))
        pstate, plat = ps.on_dispatch(pstate, draws.step(0), torch.from_numpy(send),
                                      torch.from_numpy(latency))
        _eq(plat, rlat, "latency")
    else:
        rstate, reff = rs.on_pop(rstate, k_hook, jnp.asarray(idx), jnp.asarray(valid))
        pstate, peff = ps.on_pop(pstate, draws.step(0), torch.from_numpy(idx),
                                 torch.from_numpy(valid))
        for field in pt_inject.Effects._fields:
            got, exp = getattr(peff, field).numpy(), np.asarray(getattr(reff, field))
            assert got.dtype == exp.dtype, field
            if field == "collude":  # exp of the fed jitter: an ulp apart at most
                np.testing.assert_array_equal(got > 0, exp > 0)
                np.testing.assert_allclose(got, exp, rtol=1e-6)
            else:
                _eq(got, exp, field)
        _eq(pt_inject.effects_hit(peff), ref_inject.effects_hit(reff), "effects_hit")
    for nm in names:
        for key in ("prone", "injected", "exposed"):
            _eq(pstate[nm][key], rstate[nm][key], f"{nm}.{key}")
    assert ps.counters(pstate) == rs.counters(rstate)
    for nm, arr in ps.exposure(pstate).items():
        _eq(arr, rs.exposure(rstate)[nm], f"exposure {nm}")


def _random_effects(rng, shape):
    kill = rng.random(shape) < 0.3
    return dict(
        kill=kill,
        delta_scale=np.where(rng.random(shape) < 0.3,
                             rng.choice([-1.0, 10.0, -3.0], shape), 1.0).astype(np.float32),
        noise_sigma=np.where(rng.random(shape) < 0.3, 0.7, 0.0).astype(np.float32),
        replay_shift=np.where(rng.random(shape) < 0.3, 1 << 20, 0).astype(np.int32),
        collude=np.where(rng.random(shape) < 0.3,
                         rng.lognormal(size=shape), 0.0).astype(np.float32),
    )


def _both(fields):
    return (pt_inject.Effects(**{k: torch.from_numpy(v) for k, v in fields.items()}),
            ref_inject.Effects(**{k: jnp.asarray(v) for k, v in fields.items()}))


def test_effects_merge_identity_and_hit_exact():
    pid, rid = pt_inject.identity_effects((B,)), ref_inject.identity_effects((B,))
    for field in pt_inject.Effects._fields:
        _eq(getattr(pid, field), getattr(rid, field), field)
    assert not pt_inject.effects_hit(pid).any()
    rng = np.random.default_rng(0)
    (pa, ra), (pb, rb) = _both(_random_effects(rng, (B,))), _both(_random_effects(rng, (B,)))
    pm, rm = pt_inject.merge_effects(pa, pb), ref_inject.merge_effects(ra, rb)
    for field in pt_inject.Effects._fields:
        got, exp = getattr(pm, field).numpy(), np.asarray(getattr(rm, field))
        assert got.dtype == exp.dtype
        _eq(got, exp, field)
    _eq(pt_inject.effects_hit(pm), ref_inject.effects_hit(rm), "effects_hit")
    # identity merges to itself
    same = pt_inject.merge_effects(pa, pid)
    for field in pt_inject.Effects._fields:
        assert torch.equal(getattr(same, field), getattr(pa, field))


def _tree(rng, b=None):
    lead = () if b is None else (b,)
    return {"conv": {"w": rng.standard_normal(lead + (3, 3, 1, 4)).astype(np.float32),
                     "b": rng.standard_normal(lead + (4,)).astype(np.float32)},
            "fc": {"w": rng.standard_normal(lead + (6, 5)).astype(np.float32),
                   "b": rng.standard_normal(lead + (5,)).astype(np.float32)}}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _check_slots(got, exp, hit, updated, bases):
    """Missed slots keep the input bitwise; hit slots match within rtol
    1e-6, and within 1e-6 of the leaf's scale where ``base + delta``
    cancels (a one-ulp difference in a term of that size)."""
    for path in (("conv", "w"), ("conv", "b"), ("fc", "w"), ("fc", "b")):
        g = got[path[0]][path[1]].numpy()
        e = np.asarray(exp[path[0]][path[1]])
        u = updated[path[0]][path[1]]
        scale = max(np.abs(u).max(), np.abs(bases[path[0]][path[1]]).max())
        np.testing.assert_array_equal(g[~hit], u[~hit], err_msg=f"{path} missed")
        np.testing.assert_array_equal(e[~hit], u[~hit])
        np.testing.assert_allclose(g[hit], e[hit], rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=f"{path} hit")
        assert not np.array_equal(g[hit], u[hit])


@pytest.mark.parametrize("stacked_bases", [True, False])
@pytest.mark.parametrize("channels", [(True, False), (False, True), (True, True)])
def test_corrupt_updates_matches_the_reference(stacked_bases, channels):
    has_scale, has_noise = channels
    rng = np.random.default_rng(1)
    updated = _tree(rng, B)
    bases = _tree(rng, B if stacked_bases else None)
    fields = _random_effects(rng, (B,))
    fields["delta_scale"][:2] = (-1.0, 10.0)  # at least one hit per channel
    fields["noise_sigma"][2] = 0.5
    peff, reff = _both(fields)
    key = jax.random.PRNGKey(9)
    exp = ref_inject.corrupt_updates(updated, bases, reff, key, has_scale, has_noise)
    # the reference's noise, leaf j (sorted order) from fold_in(key, j), fed
    paths = ["conv/b", "conv/w", "fc/b", "fc/w"]
    shapes = {"conv/b": (B, 4), "conv/w": (B, 3, 3, 1, 4), "fc/b": (B, 5),
              "fc/w": (B, 6, 5)}
    fed = {f"noise/{p}": np.asarray(jax.random.normal(jax.random.fold_in(key, j),
                                                      shapes[p], jnp.float32))
           for j, p in enumerate(paths)}
    got = pt_inject.corrupt_updates(_t(updated), _t(bases), peff,
                                    ReplayDraws(fed, [], "cpu"), has_scale, has_noise)
    hit = np.zeros(B, bool)
    if has_scale:
        hit |= fields["delta_scale"] != 1.0
    if has_noise:
        hit |= fields["noise_sigma"] > 0
    _check_slots(got, exp, hit, updated, bases)
    # identity effects: every slot bitwise its input
    same = pt_inject.corrupt_updates(_t(updated), _t(bases),
                                     pt_inject.identity_effects((B,)),
                                     ReplayDraws(fed, [], "cpu"), True, True)
    for (p, a), (_, b) in zip(tree_paths(same), tree_paths(_t(updated))):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("stacked_bases", [True, False])
def test_collude_updates_matches_the_reference(stacked_bases):
    rng = np.random.default_rng(2)
    updated = _tree(rng, B)
    bases = _tree(rng, B if stacked_bases else None)
    fields = _random_effects(rng, (B,))
    fields["collude"][0] = 1.3
    peff, reff = _both(fields)
    exp = ref_inject.collude_updates(updated, bases, reff)
    got = pt_inject.collude_updates(_t(updated), _t(bases), peff)
    _check_slots(got, exp, fields["collude"] > 0, updated, bases)


@pytest.mark.parametrize("shapes", [
    ((4,), (3, 3, 1, 4), (5,), (6, 5)),
    ((32,), (5, 5, 1, 32), (64,), (5, 5, 32, 64)),
    ((7,),),
])
def test_collude_direction_bitwise(shapes):
    got = pt_inject._collude_direction(shapes)
    exp = ref_inject._collude_direction(shapes)
    assert pt_inject.COLLUDE_SEED == ref_inject.COLLUDE_SEED
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and g.tobytes() == e.tobytes()
