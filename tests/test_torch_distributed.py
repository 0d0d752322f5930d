"""The port's ``core/distributed.py`` against the reference's.

  * The functions copied from the reference (``cohort_padding``,
    ``resolve_fleet_shards``, ``scheduler_comm_bytes``, ``FLEET_AXIS``) give
    its values and its messages; ``fleet_mesh`` keeps its first clause.
  * The sharded pop: a hypothesis property that the merge of D shards'
    local next-k (``merge_next_k``, D in 1..8, ragged fleets padded with
    ``+inf``, dense ties, idle clients) equals a global top-k in values,
    indices and tie order. The reference's own property
    (``tests/test_sharded_pop.py::test_sharded_pop_matches_global_topk``)
    is red, so the global top-k held here is the reference's unsharded
    ``sim/events.py::next_k_events(use_kernel=False)``, with the port's as
    a second witness. Then the reference's three fixed cases through the
    real ``sharded_next_k_events`` on gloo worlds of 2 and 4 ranks.
  * ``oldest_age_step_sharded``: ties to the lower *global* index
    (reference ``test_sharded_engine.py:180``), on worlds of 2 and 4.
  * ``markov_step_sharded``: a replayed step equals its definition (each
    rank's coins from its own sub-stream), and over 400 rounds its
    Var[X] sits near ``load_metric.optimal_var`` and E[X] near n/k.

The worlds are spawned once each (``repro_torch.launch.ranks``) and run
every case of this file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as ref_dist  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.sim import events as ref_events  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import load_metric  # noqa: E402
from repro_torch.kernels.event_topk import next_k_plain  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.sim import events as pt_events  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

WORLDS = (2, 4)
MARKOV = dict(n=400, k=40, m=10, rounds=400)


# ---------------------------------------------------------------------------
# the copied functions
# ---------------------------------------------------------------------------


def test_copied_functions_match_the_reference():
    assert dist.FLEET_AXIS == ref_dist.FLEET_AXIS
    for b, shards in ((3, 8), (8, 8), (9, 8), (5, 1), (256, 3), (0, 4)):
        assert dist.cohort_padding(b, shards) == ref_dist.cohort_padding(b, shards)
    for n, k, d in ((16384, 256, 1), (1_000_000, 150_000, 8), (48, 8, 2)):
        assert dist.scheduler_comm_bytes(n, k, d) == ref_dist.scheduler_comm_bytes(n, k, d)
    for n, shards, avail in ((16, 0, 8), (16, 0, 3), (10, 0, 8), (7, 0, 4),
                             (16, 4, 8), (12, 0, 5)):
        assert dist.resolve_fleet_shards(n, shards, avail) == \
            ref_dist.resolve_fleet_shards(n, shards, avail)
    for fn, args in ((dist.cohort_padding, (3, 0)),
                     (dist.resolve_fleet_shards, (16, 3, 8))):
        ref_fn = getattr(ref_dist, fn.__name__)
        with pytest.raises(ValueError) as ref:
            ref_fn(*args)
        with pytest.raises(ValueError) as got:
            fn(*args)
        assert str(got.value) == str(ref.value)


def test_fleet_mesh_error_keeps_the_reference_clause():
    with pytest.raises(ValueError) as ref:
        ref_dist.fleet_mesh(64)
    with pytest.raises(ValueError) as got:
        dist.fleet_mesh(64)
    clause = "requested 64 fleet shards but only 1 devices are available"
    assert str(ref.value).startswith(clause)
    assert str(got.value).startswith(clause)
    assert "--mesh-shards" in str(got.value)


def test_world_of_one_is_scoped():
    """``world_of_one`` makes a group only when none exists and ends only
    the group it made; a mesh inside it is the world of one."""
    torch_dist = torch.distributed
    assert not torch_dist.is_initialized()
    with dist.world_of_one():
        assert torch_dist.get_world_size() == 1
        assert dist.fleet_mesh(0) == dist.FleetMesh(size=1, rank=0)
        with dist.world_of_one():  # nested: the outer group, left as it was
            assert torch_dist.get_world_size() == 1
        assert torch_dist.is_initialized()
        x = torch.tensor([-0.0, float("nan"), 3.0])
        assert dist.psum(x, dist.fleet_mesh(1)).numpy().tobytes() == x.numpy().tobytes()
    assert not torch_dist.is_initialized()


# ---------------------------------------------------------------------------
# the pop merge, in one process
# ---------------------------------------------------------------------------


def _merged_pop(times: np.ndarray, k: int, d: int):
    """``sharded_next_k_events``' schedule with D shards in one process."""
    t = torch.as_tensor(times, dtype=torch.float32)
    n = t.shape[0]
    shard = -(-n // d)
    kk = min(k, shard)
    cand_t, cand_i = [], []
    for r in range(d):
        block = t[r * shard:(r + 1) * shard]
        block = torch.cat([block, torch.full((shard - block.shape[0],), float("inf"))])
        lt, li = next_k_plain(block, kk)
        cand_t.append(lt)
        cand_i.append(li + r * shard)
    return dist.merge_next_k(cand_t, cand_i, k)


def _check_against_global(times, k, d):
    times = np.asarray(times, np.float32)
    ref_t, ref_i = ref_events.next_k_events(jnp.asarray(times), k, use_kernel=False)
    ref_t, ref_i = np.asarray(ref_t), np.asarray(ref_i)
    pt_t, pt_i = pt_events.next_k_events(torch.as_tensor(times), k, use_kernel=False)
    got_t, got_i = _merged_pop(times, k, d)
    np.testing.assert_array_equal(got_t.numpy(), ref_t)
    np.testing.assert_array_equal(pt_t.numpy(), ref_t)
    valid = np.isfinite(ref_t)
    np.testing.assert_array_equal(got_i.numpy()[valid], ref_i[valid])
    np.testing.assert_array_equal(pt_i.numpy()[valid], ref_i[valid])


def test_merged_pop_matches_global_topk():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    # a small value pool forces heavy ties; +inf models idle clients
    times_st = st.lists(
        st.one_of(st.sampled_from([1.0, 2.0, 3.0, float("inf")]),
                  st.floats(0.25, 100.0, allow_nan=False, allow_infinity=False,
                            width=32)),
        min_size=1, max_size=37)

    @settings(deadline=None, max_examples=40)
    @given(data=st.data())
    def check(data):
        times = data.draw(times_st)
        k = data.draw(st.integers(1, len(times)))
        d = data.draw(st.integers(1, 8))
        _check_against_global(times, k, d)

    check()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_merged_pop_fixed_cases(d):
    # ragged n, all tied: indices 0..k-1 in order (lower-global-index ties)
    n = 4 * d + 3
    t, idx = _merged_pop(np.full(n, 7.5, np.float32), 5, d)
    np.testing.assert_array_equal(t.numpy(), np.full(5, 7.5))
    np.testing.assert_array_equal(idx.numpy(), np.arange(5))
    # all idle: nothing valid
    t, _ = _merged_pop(np.full(2 * d + 1, np.inf, np.float32), 3, d)
    assert not np.isfinite(t.numpy()).any()


# ---------------------------------------------------------------------------
# the real functions on spawned worlds
# ---------------------------------------------------------------------------


def _pop_cases(world):
    rng = np.random.default_rng(world)
    cases = [
        {"name": "tied", "op": "pop", "times": np.full(4 * world + 3, 7.5), "k": 5},
        {"name": "idle", "op": "pop", "times": np.full(2 * world + 1, np.inf), "k": 3},
    ]
    n = 3 * world + 1
    times = np.where(np.arange(n) % 3 == 0, 2.0, np.inf)
    cases.append({"name": "apply_pop", "op": "pop", "times": times, "k": n})
    for i in range(6):
        n = int(rng.integers(world, 6 * world + 5))
        times = rng.choice([1.0, 2.0, np.inf, 0.5], size=n)
        times = np.where(rng.random(n) < 0.3, rng.random(n) * 10, times)
        cases.append({"name": f"random{i}", "op": "pop", "times": times,
                      "k": int(rng.integers(1, n + 1))})
    return cases


def _oldest_cases(world):
    n = 4 * world
    tied = np.full(n, 5, np.int32)
    older = tied.copy()
    older[n - 1] = 9
    return [{"name": "oldest_tied", "op": "oldest", "ages": tied, "k": 4},
            {"name": "oldest_older", "op": "oldest", "ages": older, "k": 4, "reps": 2}]


def _markov_cases(world):
    n, k, m = MARKOV["n"], MARKOV["k"], MARKOV["m"]
    probs = load_metric.optimal_probs(n, k, m).astype(np.float32)
    rng = np.random.default_rng(0)
    ages = rng.integers(0, m + 3, size=n).astype(np.int32)
    per = n // world
    replay = [{f"{r}/select": rng.random(per).astype(np.float32) for r in range(world)}
              for _ in range(2)]
    return [{"name": "markov_replay", "op": "markov", "ages": ages, "probs": probs,
             "m": m, "rounds": 2, "draws": replay},
            {"name": "markov_stats", "op": "markov", "ages": np.zeros(n, np.int32),
             "probs": probs, "m": m, "rounds": MARKOV["rounds"], "seed": 3}]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in WORLDS:
        cases = _pop_cases(world) + _oldest_cases(world) + _markov_cases(world)
        res = ranks.run_cases_on_ranks(cases, world,
                                       str(tmp_path_factory.mktemp(f"w{world}")))
        out[world] = {c["name"]: (c, r) for c, r in zip(cases, res)}
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pop_matches_global_topk_on_ranks(worlds, world):
    for name, (case, got) in worlds[world].items():
        if case["op"] != "pop":
            continue
        times = np.asarray(case["times"], np.float32)
        ref_t, ref_i = ref_events.next_k_events(jnp.asarray(times), case["k"],
                                                use_kernel=False)
        np.testing.assert_array_equal(got["t"], np.asarray(ref_t), err_msg=name)
        valid = np.isfinite(np.asarray(ref_t))
        np.testing.assert_array_equal(got["idx"][valid], np.asarray(ref_i)[valid],
                                      err_msg=name)
    _, tied = worlds[world]["tied"]
    np.testing.assert_array_equal(tied["idx"], np.arange(5))
    _, idle = worlds[world]["idle"]
    assert not np.isfinite(idle["t"]).any()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pop_feeds_apply_pop(worlds, world):
    # end to end through the event-engine bookkeeping: popped clients go
    # idle, invalid slots never write back
    case, got = worlds[world]["apply_pop"]
    ev = pt_events.init_event_state(len(case["times"]), "cpu")
    ev = {**ev, "t_done": torch.as_tensor(case["times"], dtype=torch.float32)}
    t, idx_safe, valid, ev2 = pt_events.apply_pop(
        ev, torch.as_tensor(got["t"]), torch.as_tensor(got["idx"]))
    pending = np.flatnonzero(np.isfinite(case["times"]))
    assert int(valid.sum()) == len(pending)
    np.testing.assert_array_equal(np.sort(idx_safe.numpy()[valid.numpy()]), pending)
    assert torch.isinf(ev2["t_done"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_oldest_age_sharded_tie_break_low_index(worlds, world):
    n, k = 4 * world, 4
    _, (tied,) = worlds[world]["oldest_tied"]
    # all ages tied: the k winners are exactly the k lowest global indices,
    # whichever rank holds them
    np.testing.assert_array_equal(np.sort(tied["chosen"]), np.arange(k))
    np.testing.assert_array_equal(tied["sel"], np.arange(n) < k)
    np.testing.assert_array_equal(tied["new_ages"], np.where(np.arange(n) < k, 0, 6))
    # a strictly older client beats the tied block; the other slots take
    # the lowest tied indices; the same input gives the same selection
    _, (older, again) = worlds[world]["oldest_older"]
    assert older["sel"][n - 1]
    np.testing.assert_array_equal(np.sort(older["chosen"]), [0, 1, 2, n - 1])
    np.testing.assert_array_equal(older["sel"], again["sel"])


@pytest.mark.parametrize("world", WORLDS)
def test_markov_step_sharded_replayed(worlds, world):
    case, got = worlds[world]["markov_replay"]
    per = MARKOV["n"] // world
    ages = case["ages"].copy()
    for r, table in enumerate(case["draws"]):
        u = np.concatenate([table[f"{q}/select"] for q in range(world)])
        want = u < case["probs"][np.minimum(ages, case["m"])]
        np.testing.assert_array_equal(got["sel"][r], want)
        assert got["count"][r] == want.sum()
        ages = (ages + 1) * (1 - want)
        assert len(u) == per * world


@pytest.mark.parametrize("world", WORLDS)
def test_markov_step_sharded_statistics(worlds, world):
    n, k, m = MARKOV["n"], MARKOV["k"], MARKOV["m"]
    _, got = worlds[world]["markov_stats"]
    np.testing.assert_array_equal(got["count"], got["sel"].sum(axis=1))
    stats = load_metric.empirical_load_stats(got["sel"][100:])  # past burn-in
    assert abs(stats["mean_X"] - n / k) < 0.1 * n / k
    target = ref_lm.optimal_var(n, k, m)
    assert target == pytest.approx(load_metric.optimal_var(n, k, m))
    assert abs(stats["var_X"] - target) < 0.25 * target + 0.5
    assert stats["var_X"] < 0.5 * load_metric.random_selection_var(n, k)
