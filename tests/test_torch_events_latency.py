"""The port's event engine and latency samplers against the reference:
``pop_events``/``apply_pop`` exactly (exhausted kernel tiles included),
the samplers on replayed reference draws, and statistically on native
torch draws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.sim import events as ref_ev  # noqa: E402
from repro.sim import latency as ref_lat  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core.draws import GeneratorDraws, ReplayDraws  # noqa: E402
from repro_torch.sim import events as pt_ev  # noqa: E402
from repro_torch.sim import latency as pt_lat  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

KEY = jax.random.PRNGKey(0)


def _scheduled(n, send, lat, seed_dropped=None):
    """Reference event state after one dispatch, and its port copy."""
    ev = ref_ev.init_event_state(n)
    dropped = (np.zeros(n, bool) if seed_dropped is None
               else np.random.default_rng(seed_dropped).random(n) < 0.3)
    ev = ref_ev.schedule_completions(
        ev, jnp.asarray(send), jnp.float32(1.5), jnp.asarray(lat),
        jnp.int32(3), jnp.asarray(dropped))
    pt = pt_ev.schedule_completions(
        pt_ev.init_event_state(n, "cpu"), torch.from_numpy(send),
        torch.tensor(1.5), torch.from_numpy(lat),
        torch.tensor(3, dtype=torch.int32), torch.from_numpy(dropped))
    return ev, pt


def _assert_state_equal(pt_state, ref_state):
    got = state_to_jax(pt_state)
    for key, val in ref_state.items():
        np.testing.assert_array_equal(got[key], np.asarray(val), err_msg=key)


@pytest.mark.parametrize("n,k,frac,use_kernel", [
    (50, 8, 0.5, False),
    (50, 8, 0.5, True),
    (200, 16, 0.05, True),  # fewer events than k: exhausted tiles
    (8, 4, 0.0, True),
])
def test_pop_events_matches_reference(n, k, frac, use_kernel):
    rng = np.random.default_rng(n + k)
    send = rng.random(n) < frac
    lat = (rng.random(n) * 10 + 0.1).astype(np.float32)
    ev, pt = _scheduled(n, send, lat, seed_dropped=n)
    _assert_state_equal(pt, ev)
    for _ in range(3):
        t, idx, valid, ev = ref_ev.pop_events(ev, k, use_kernel=use_kernel)
        pt_t, pt_idx, pt_valid, pt = pt_ev.pop_events(pt, k,
                                                      use_kernel=use_kernel)
        np.testing.assert_array_equal(pt_t.numpy(), np.asarray(t))
        np.testing.assert_array_equal(pt_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(pt_valid.numpy(), np.asarray(valid))
        _assert_state_equal(pt, ev)


def test_exhausted_tile_never_resurrects_a_popped_event():
    """The reference's kernel path emits duplicate real indices for its
    +inf filler slots (tests/test_sim_events.py); the same (t, idx) fed to
    the port's apply_pop must leave the popped client idle."""
    n = 8
    send = np.arange(n) == 0
    ev, pt = _scheduled(n, send, np.full(n, 2.0, np.float32))
    t, idx = ref_ev.next_k_events(ev["t_done"], 4, use_kernel=True)
    assert len(set(np.asarray(idx).tolist())) < 4  # duplicates present
    _, ref_idx, ref_valid, ev2 = ref_ev.apply_pop(ev, t, idx)
    pt_t, pt_idx, pt_valid, pt2 = pt_ev.apply_pop(
        pt, torch.from_numpy(np.array(t)),
        torch.from_numpy(np.array(idx)).long())
    assert int(pt_valid.sum()) == 1
    assert np.isinf(pt2["t_done"].numpy()).all()
    np.testing.assert_array_equal(pt_idx.numpy(), np.asarray(ref_idx))
    _assert_state_equal(pt2, ev2)


def test_scatter_set_drops_masked_duplicates():
    x = torch.zeros(5)
    idx = torch.tensor([2, 2, 4, 0])
    mask = torch.tensor([True, False, True, False])
    out = pt_ev.scatter_set(x, idx, mask, torch.tensor([1.0, 9.0, 2.0, 9.0]))
    np.testing.assert_array_equal(out.numpy(), [0, 0, 1, 0, 2])


def _replay_latency_draws(key, n, profile):
    """The reference's primitive draws inside sample_latency
    (sim/latency.py:118-128) under its own key split."""
    k_c, k_t = jax.random.split(key)
    sites = {}
    if profile.compute_sigma > 0:
        sites["latency_compute"] = np.asarray(jax.random.normal(k_c, (n,), jnp.float32))
    if profile.comm_rate > 0:
        sites["latency_comm"] = np.asarray(jax.random.exponential(k_t, (n,), jnp.float32))
    return sites


@pytest.mark.parametrize("name", sorted(ref_lat.PROFILES))
def test_samplers_on_replayed_draws(name):
    prof = ref_lat.get_profile(name)
    pt_prof = pt_lat.get_profile(name)
    assert dataclass_fields(pt_prof) == dataclass_fields(prof)
    n = 257
    k_speed, k_lat, k_gap, k_drop = jax.random.split(jax.random.fold_in(KEY, 7), 4)
    init = {"speed": np.asarray(jax.random.normal(k_speed, (n,), jnp.float32))}
    step = _replay_latency_draws(k_lat, n, prof)
    if prof.avail_gap > 0:
        step["avail_gap"] = np.asarray(jax.random.exponential(k_gap, (n,), jnp.float32))
    if prof.dropout > 0:
        step["dropout"] = np.asarray(jax.random.uniform(k_drop, (n,)))
    d = ReplayDraws(init, [step], "cpu")
    speed = pt_lat.client_speed(d, n, pt_prof)
    ref_speed = ref_lat.client_speed(k_speed, n, prof)
    np.testing.assert_allclose(speed.numpy(), np.asarray(ref_speed), rtol=1e-6)
    d0 = d.step(0)
    lat = pt_lat.sample_latency(d0, pt_prof, speed)
    ref_l = ref_lat.sample_latency(k_lat, prof, ref_speed)
    # exp and fused multiply-add may round differently by an ulp
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_l), rtol=1e-6)
    np.testing.assert_allclose(
        pt_lat.sample_avail_gap(d0, pt_prof, n).numpy(),
        np.asarray(ref_lat.sample_avail_gap(k_gap, prof, n)), rtol=1e-6)
    np.testing.assert_array_equal(
        pt_lat.sample_dropout(d0, pt_prof, n).numpy(),
        np.asarray(ref_lat.sample_dropout(k_drop, prof, n)))
    assert pt_prof.mean_latency() == prof.mean_latency()


def dataclass_fields(p):
    import dataclasses

    return dataclasses.astuple(p)


@pytest.mark.parametrize("name", ["datacenter", "lognormal", "mobile"])
def test_native_draws_match_closed_forms(name):
    """Torch-generated draws: mean latency within 5% of the closed form
    (as tests/test_sim_events.py holds the reference), dropout rate near
    its hazard, mean availability gap near its configured mean."""
    p = pt_lat.get_profile(name)
    d = GeneratorDraws(0, "cpu")
    n = 200_000
    speed = pt_lat.client_speed(d, n, p)
    lat = pt_lat.sample_latency(d, p, speed)
    assert abs(float(lat.mean()) - p.mean_latency()) / p.mean_latency() < 0.05
    assert bool((lat > 0).all())
    if p.dropout > 0:
        assert abs(float(pt_lat.sample_dropout(d, p, n).float().mean())
                   - p.dropout) < 0.01
    if p.avail_gap > 0:
        gap = pt_lat.sample_avail_gap(d, p, n)
        assert abs(float(gap.mean()) - p.avail_gap) / p.avail_gap < 0.02


def test_event_state_round_trips_through_convert():
    ev = ref_ev.init_event_state(16)
    pt = state_from_jax({k: np.asarray(v) for k, v in ev.items()}, "cpu")
    assert pt["disp_ver"].dtype == torch.int32 and pt["dropped"].dtype == torch.bool
    _assert_state_equal(pt, ev)
