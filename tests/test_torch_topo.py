"""``repro_torch.topo`` and its pieces against ``repro.topo``.

* The copied ``topo/graph.py``: registry, every validation message,
  ``assign``, ``parents``, ``gossip_mixing`` and ``describe`` equal the
  reference's.
* ``tiered_apply`` against the reference's on the same numpy-seeded stacks
  (fedavg, fedbuff, norm_clip; tiers (4,), (4, 2), (8, 4, 2) and gossip;
  stacked and unstacked bases; weight-0 padded slots), within rtol 1e-5 /
  atol 1e-6: both sum the same f32 products in other orders (K1's FMA walk
  against ``segment_sum`` of per-slot products), tighter than the
  reference's own tiered-vs-sharded tolerance (rtol 5e-4, atol 1e-5,
  ``tests/test_topo.py``). Telemetry (``clipped``) is exact.
* Within the port: tiered == flat within the same tolerance, the
  reference's rejection messages, a NaN slot stays in its tier-0 node,
  the fallback for an aggregator without a node form.
* ``make_hop_latency`` on replayed draws equals the reference's fold-104
  hop draws; the heartbeat functions; the per-tier accumulators over a
  random selection sequence (exact moments, per node);
  ``tier_suspect_counts``; K1's segmented route's plain version against
  ``jax.ops.segment_sum`` of per-slot products.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.topo.graph as ref_graph  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.engine import aggregators as ref_aggs  # noqa: E402
from repro.engine import robust as ref_robust  # noqa: E402
from repro.topo import heartbeat as ref_hb  # noqa: E402
from repro.topo import reduce as ref_reduce  # noqa: E402
import repro_torch.topo.graph as pt_graph  # noqa: E402
from repro_torch.core import load_metric as pt_lm  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.engine import aggregators as pt_aggs  # noqa: E402
from repro_torch.engine import robust as pt_robust  # noqa: E402
from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from repro_torch.topo import heartbeat as pt_hb  # noqa: E402
from repro_torch.topo import reduce as pt_reduce  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

N = 16
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# the copied graph module
# ---------------------------------------------------------------------------

BAD_TOPOLOGIES = [
    dict(name="bad", kind="ring"),
    dict(name="bad", kind="star", tier_sizes=(4,)),
    dict(name="bad", kind="hier"),
    dict(name="bad", kind="gossip", tier_sizes=(8, 2)),
    dict(name="bad", kind="hier", tier_sizes=(4, 0)),
    dict(name="bad", kind="hier", tier_sizes=(2, 8)),
    dict(name="bad", kind="hier", tier_sizes=(4,), tier_profiles=("datacenter",)),
    dict(name="bad", heartbeat_timeout=-1.0),
    dict(name="bad", kind="gossip", tier_sizes=(4,), gossip_rounds=-1),
    dict(name="bad", kind="gossip", tier_sizes=(4,), gossip_degree=3),
    dict(name="bad", kind="gossip", tier_sizes=(4,), gossip_degree=4),
]


@pytest.mark.parametrize("kw", BAD_TOPOLOGIES, ids=range(len(BAD_TOPOLOGIES)))
def test_validation_messages_equal_the_reference(kw):
    with pytest.raises(ValueError) as ref:
        ref_graph.Topology(**kw)
    with pytest.raises(ValueError) as got:
        pt_graph.Topology(**kw)
    assert str(got.value) == str(ref.value)


def _both(fn):
    """``fn(module)``'s outcome on both graph modules: the value, or the
    exception's type and message."""
    out = []
    for mod in (ref_graph, pt_graph):
        try:
            out.append(("ok", fn(mod)))
        except Exception as exc:  # noqa: BLE001
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("name,kw", [
    ("star", {}), ("star", {"heartbeat_timeout": 2.5}),
    ("hierarchical", {}), ("hierarchical", {"tiers": (4, 2)}),
    ("hierarchical", {"tiers": 5, "heartbeat_timeout": 30.0}),
    ("hierarchical", {"tiers": (8, 4, 2), "profiles": ("mobile", "lognormal",
                                                         "datacenter", "uniform")}),
    ("gossip", {}), ("gossip", {"nodes": 8, "degree": 4, "rounds": 3}),
    ("gossip", {"nodes": 4, "degree": 2, "rounds": 0}),
    ("ring-of-fire", {}),
])
def test_registry_and_maps_equal_the_reference(name, kw):
    def probe(mod):
        topo = mod.make_topology(name, **kw)
        out = {"fields": dataclasses.astuple(topo), "describe": topo.describe(),
               "star": topo.is_star, "tiers": topo.n_tiers}
        for n in (16, 17, 48, 1000):
            if topo.tier_sizes and topo.tier_sizes[0] > n:
                continue
            out[f"assign{n}"] = topo.assign(n).tolist()
        out["parents"] = [p.tolist() for p in topo.parents()]
        if topo.kind == "gossip":
            out["mix"] = topo.gossip_mixing().tolist()
        return out

    ref, got = _both(probe)
    assert got == ref


def test_fleet_validation_and_registry_equal_the_reference():
    assert pt_graph.topology_names() == ref_graph.topology_names()
    ref, got = _both(lambda m: m.make_topology("hierarchical", tiers=(64,)).validate(16))
    assert ref[0] == "ValueError" and got == ref
    ref, got = _both(lambda m: m.make_topology("star").gossip_mixing())
    assert ref[0] == "ValueError" and got == ref
    ref, got = _both(lambda m: m.register_topology("star")(lambda: None))
    assert ref[0] == "ValueError" and got == ref
    assert pt_graph.make_topology("star").assign(5).dtype == np.int32


# ---------------------------------------------------------------------------
# tiered_apply against the reference
# ---------------------------------------------------------------------------

def _cohort(seed, b=10, pad=2):
    """A toy params tree and a cohort of ``b`` slots, the last ``pad``
    padded (weight 0, client 0), as numpy."""
    rng = np.random.default_rng(seed)
    g = {"b": rng.standard_normal(4).astype(np.float32),
         "w": rng.standard_normal((3, 4)).astype(np.float32)}
    updates = {k: rng.standard_normal((b,) + v.shape).astype(np.float32)
               for k, v in g.items()}
    bases = {k: rng.standard_normal((b,) + v.shape).astype(np.float32)
             for k, v in g.items()}
    w = rng.uniform(0.1, 1.0, b).astype(np.float32)
    idx = rng.integers(0, N, b).astype(np.int32)
    w[b - pad:] = 0.0
    idx[b - pad:] = 0
    return g, updates, bases, w, idx


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.from_numpy(np.array(tree))


AGGS = {
    "fedavg": (ref_aggs.make_fedavg, pt_aggs.make_fedavg, {}),
    "fedbuff": (ref_aggs.make_fedbuff, pt_aggs.make_fedbuff, {}),
    "norm_clip": (ref_robust.make_norm_clip, pt_robust.make_norm_clip, {"clip": 3.0}),
}
TOPOS = {
    "hier4": ("hierarchical", {"tiers": (4,)}),
    "hier4x2": ("hierarchical", {"tiers": (4, 2)}),
    "hier8x4x2": ("hierarchical", {"tiers": (8, 4, 2)}),
    "gossip4": ("gossip", {"nodes": 4, "degree": 2, "rounds": 2}),
}


def _assert_close(got, ref, rtol=RTOL, atol=ATOL):
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
@pytest.mark.parametrize("topo_name", list(TOPOS))
@pytest.mark.parametrize("agg_name", list(AGGS))
def test_tiered_apply_matches_the_reference(agg_name, topo_name, stacked):
    make_ref, make_pt, kw = AGGS[agg_name]
    name, tkw = TOPOS[topo_name]
    g, updates, bases, w, idx = _cohort(list(AGGS).index(agg_name) * 10
                                        + list(TOPOS).index(topo_name))
    b_ref = _jax(bases) if stacked else _jax(g)
    b_pt = _torch(bases) if stacked else _torch(g)
    ref_p, ref_stats = ref_reduce.tiered_apply(
        make_ref(**kw), ref_graph.make_topology(name, **tkw), N,
        stacked_bases=stacked)(_jax(g), _jax(updates), b_ref, jnp.asarray(w),
                               jnp.asarray(idx))
    got_p, got_stats = pt_reduce.tiered_apply(
        make_pt(**kw), pt_graph.make_topology(name, **tkw), N,
        stacked_bases=stacked)(_torch(g), _torch(updates), b_pt, torch.from_numpy(w),
                               torch.from_numpy(idx.astype(np.int64)))
    _assert_close(got_p, ref_p)
    assert set(got_stats) == set(ref_stats)
    for k, v in ref_stats.items():
        assert float(got_stats[k]) == float(v), k
    if agg_name == "norm_clip" and topo_name == "hier4":
        assert float(ref_stats["clipped"]) > 0  # the clip bit


@pytest.mark.parametrize("tiers", [(4,), (4, 2), (8, 4, 2)])
@pytest.mark.parametrize("agg_name", list(AGGS))
def test_tiered_equals_flat_within_the_port(agg_name, tiers):
    _, make_pt, kw = AGGS[agg_name]
    agg = make_pt(**kw)
    g, updates, bases, w, idx = map(_torch, _cohort(7))
    flat = agg.finalize(g, agg.accumulate(agg.init(g), updates, bases, w))
    tiered, _ = pt_reduce.tiered_apply(
        agg, pt_graph.make_topology("hierarchical", tiers=tiers), N)(
        g, updates, bases, w, idx.long())
    for k in g:
        torch.testing.assert_close(tiered[k], flat[k], rtol=RTOL, atol=ATOL)


def test_gossip_converges_to_the_flat_reduction():
    agg = pt_aggs.make_fedavg()
    g, updates, bases, w, idx = map(_torch, _cohort(2))
    flat = agg.finalize(g, agg.accumulate(agg.init(g), updates, bases, w))
    gossiped, _ = pt_reduce.tiered_apply(
        agg, pt_graph.make_topology("gossip", nodes=4, degree=2, rounds=64), N)(
        g, updates, bases, w, idx.long())
    for k in g:
        torch.testing.assert_close(gossiped[k], flat[k], rtol=5e-4, atol=1e-5)


def test_fallback_without_a_node_form_matches_the_node_form():
    agg = pt_aggs.make_fedbuff()
    plain = dataclasses.replace(agg, accumulate_nodes=None)
    g, updates, bases, w, idx = map(_torch, _cohort(3))
    seg = torch.from_numpy(pt_graph.make_topology("hierarchical", tiers=(4,))
                           .assign(N))[idx.long()]
    nodes = pt_reduce.tier0_accums(agg, g, updates, bases, w, seg, 4)
    slots = pt_reduce.tier0_accums(plain, g, updates, bases, w, seg, 4)
    for k in ("dsum", "wsum"):
        got, exp = slots[k], nodes[k]
        if isinstance(exp, dict):
            for kk in exp:
                torch.testing.assert_close(got[kk], exp[kk], rtol=RTOL, atol=ATOL)
        else:
            torch.testing.assert_close(got, exp, rtol=RTOL, atol=ATOL)


def test_rejections_equal_the_reference():
    cases = [
        (dataclasses.replace(ref_aggs.make_fedavg(), additive=False),
         dataclasses.replace(pt_aggs.make_fedavg(), additive=False), "hierarchical"),
        (ref_aggs.make_fedavg(), pt_aggs.make_fedavg(), "star"),
    ]
    for ref_agg, pt_agg, name in cases:
        with pytest.raises(ValueError) as ref:
            ref_reduce.tiered_apply(ref_agg, ref_graph.make_topology(name), N)
        with pytest.raises(ValueError) as got:
            pt_reduce.tiered_apply(pt_agg, pt_graph.make_topology(name), N)
        assert str(got.value) == str(ref.value)
    # over a mesh (slice F) both accept the hierarchy and return the hook
    from repro.core import distributed as ref_dist
    from repro_torch.core import distributed as pt_dist

    assert callable(ref_reduce.tiered_apply(
        ref_aggs.make_fedavg(), ref_graph.make_topology("hierarchical"), N,
        mesh=ref_dist.fleet_mesh(1), axis="fleet"))
    assert callable(pt_reduce.tiered_apply(
        pt_aggs.make_fedavg(), pt_graph.make_topology("hierarchical"), N,
        mesh=pt_dist.FleetMesh(size=1, rank=0)))


@pytest.mark.parametrize("agg_name", list(AGGS))
def test_a_nan_slot_stays_in_its_node(agg_name):
    _, make_pt, kw = AGGS[agg_name]
    agg = make_pt(**kw)
    g, updates, bases, w, idx = map(_torch, _cohort(4, pad=0))
    updates["w"][3, 1, 2] = float("nan")
    seg = torch.from_numpy(pt_graph.make_topology("hierarchical", tiers=(4,))
                           .assign(N))[idx.long()]
    acc = pt_reduce.tier0_accums(agg, g, updates, bases, w, seg, 4)
    key = "usum" if agg_name == "fedavg" else "dsum"
    bad = torch.isnan(acc[key]["w"]).flatten(1).any(dim=1)
    expect = torch.zeros(4, dtype=torch.bool)
    expect[seg[3]] = True
    if agg_name == "norm_clip":  # the NaN norm poisons the slot's whole delta
        assert torch.equal(bad, expect)
        assert torch.isnan(acc[key]["b"][seg[3]]).all()
    else:
        assert torch.equal(bad, expect)
        assert not torch.isnan(acc[key]["b"]).any()


# ---------------------------------------------------------------------------
# K1's segmented route (plain version) against segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,N_,E", [(10, 37, 4), (64, 256, 8), (7, 5, 9), (1, 3, 1)])
def test_segmented_plain_matches_segment_sum_of_slot_products(C, N_, E):
    rng = np.random.default_rng(C * N_ + E)
    P = rng.standard_normal((C, N_)).astype(np.float32)
    w = rng.uniform(0, 1, C).astype(np.float32)
    seg = rng.integers(0, E, C).astype(np.int32)
    w[-1] = 0.0
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(P) * jnp.asarray(w)[:, None],
                                         jnp.asarray(seg), num_segments=E))
    before = k1.launches
    got = k1.fedavg_reduce_leaves([torch.from_numpy(P)], torch.from_numpy(w),
                                  torch.from_numpy(seg), E)[0]
    assert k1.launches == before  # the plain version: no kernel launch
    assert got.shape == (E, N_)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    empty = np.setdiff1d(np.arange(E), seg)
    assert (got.numpy()[empty] == 0).all()


def test_segmented_route_rejects_bad_maps():
    P, w = torch.zeros((3, 4)), torch.ones(3)
    with pytest.raises(ValueError, match="int32"):
        k1.fedavg_reduce_leaves([P], w, torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="int32"):
        k1.fedavg_reduce_leaves([P], w, torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="num_segments"):
        k1.fedavg_reduce_leaves([P], w, torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="without a segment map"):
        k1.fedavg_reduce_leaves([P], w, None, 3)


# ---------------------------------------------------------------------------
# hop latency, heartbeat, tier accumulators, suspect census
# ---------------------------------------------------------------------------

def _hop_draws(topo, key, n):
    """The reference's hop draws (``make_hop_latency``): ``split(key, hops
    + links - 1)``, hop ``i``'s ``sample_latency`` splitting its key into
    the compute normal and the comm exponential."""
    hops = topo.n_tiers + 1
    if topo.kind == "gossip":
        links = max(topo.gossip_rounds, 1)
        sizes = [n] + [int(topo.tier_sizes[0])] * topo.gossip_rounds
    else:
        links = 1
        sizes = [n] + [int(s) for s in topo.tier_sizes]
    keys = jax.random.split(key, hops + links - 1)
    out = {}
    for i, size in enumerate(sizes):
        k_c, k_t = jax.random.split(keys[i])
        out[f"hop/{i}/latency_compute"] = np.asarray(
            jax.random.normal(k_c, (size,), jnp.float32))
        out[f"hop/{i}/latency_comm"] = np.asarray(
            jax.random.exponential(k_t, (size,), jnp.float32))
    return out


@pytest.mark.parametrize("name,kw", [
    ("hierarchical", {"tiers": (4, 2)}),
    ("hierarchical", {"tiers": (8, 4, 2), "profiles": ("lognormal", "datacenter",
                                                         "mobile", "datacenter")}),
    ("gossip", {"nodes": 4, "degree": 2, "rounds": 3}),
])
def test_hop_latency_on_replayed_draws_equals_the_reference(name, kw):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 104)
    ref_topo = ref_graph.make_topology(name, **kw)
    ref = np.asarray(ref_reduce.make_hop_latency(ref_topo, N)(key))
    hop = pt_reduce.make_hop_latency(pt_graph.make_topology(name, **kw), N)
    draws = ReplayDraws({}, [_hop_draws(ref_topo, key, N)], "cpu").step(0)
    got = hop(draws.sub("hop")).numpy()
    assert got.shape == (N,) and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert pt_reduce.make_hop_latency(pt_graph.make_topology("star"), N) is None


def test_heartbeat_functions_equal_the_reference():
    rng = np.random.default_rng(0)
    n = 12
    mask = rng.random(n) < 0.5
    idx = rng.permutation(n)[:5]
    arrived = np.array([True, False, True, True, False])
    t = rng.uniform(0, 10, 5).astype(np.float32)
    ref = ref_hb.init_heartbeat(n)
    ref = ref_hb.beat(ref, jnp.asarray(mask), jnp.float32(3.5))
    ref_sc = jnp.where(jnp.asarray(arrived), jnp.asarray(idx), n)
    ref = ref_hb.beat_at(ref, ref_sc, jnp.asarray(t))
    got = pt_hb.init_heartbeat(n, "cpu")
    assert torch.equal(got["last_beat"], torch.zeros(n))
    got = pt_hb.beat(got, torch.from_numpy(mask), torch.tensor(3.5))
    got = pt_hb.beat_at(got, torch.from_numpy(idx), torch.from_numpy(arrived),
                        torch.from_numpy(t))
    np.testing.assert_array_equal(got["last_beat"].numpy(), np.asarray(ref["last_beat"]))
    now = np.float32(9.0)
    np.testing.assert_array_equal(
        pt_hb.expired(got["last_beat"], torch.tensor(now), 4.0).numpy(),
        np.asarray(ref_hb.expired(ref["last_beat"], now, 4.0)))


@pytest.mark.parametrize("n,e", [(16, 4), (17, 5), (48, 4), (1000, 64)])
def test_tier_accumulators_equal_the_reference(n, e):
    rng = np.random.default_rng(n + e)
    assign = pt_graph.make_topology("hierarchical", tiers=(e,)).assign(n)
    blocks = pt_lm.tier_blocks(assign)
    ref = ref_lm.init_tier_accum(n, e)
    got = pt_lm.init_tier_accum(n, e)
    gaps = [[] for _ in range(e)]
    last = np.full(n, -1)
    for r in range(40):
        sel = rng.random(n) < 0.3
        ref = ref_lm.update_tier_accum(ref, jnp.asarray(sel), jnp.asarray(assign))
        got = pt_lm.update_tier_accum(got, torch.from_numpy(sel), blocks)
        for c in np.flatnonzero(sel & (last >= 0)):
            gaps[assign[c]].append(r - last[c])
        last = np.where(sel, r, last)
    for key, val in ref.items():
        assert got[key].numpy().tobytes() == np.asarray(val).tobytes(), key
    stats = pt_lm.tier_stats_from_accum(got)
    assert stats == pytest.approx(ref_lm.tier_stats_from_accum(ref), nan_ok=True)
    assert stats["tier_num_samples"] == [len(x) for x in gaps]
    for i, x in enumerate(gaps):
        if x:
            assert stats["tier_mean_X"][i] == pytest.approx(np.mean(x), rel=1e-6)
            assert stats["tier_var_X"][i] == pytest.approx(np.var(x), rel=1e-5,
                                                          abs=1e-6)


def test_tier_blocks_cover_each_client_once():
    assign = pt_graph.make_topology("hierarchical", tiers=(5,)).assign(17)
    table = pt_lm.tier_blocks(assign).numpy()
    assert table.shape == (5, 4)
    flat = table[table < 17]
    np.testing.assert_array_equal(np.sort(flat), np.arange(17))
    for node, row in enumerate(table):
        assert (assign[row[row < 17]] == node).all()
    with pytest.raises(ValueError, match="contiguous"):
        pt_lm.tier_blocks(np.array([0, 1, 0], np.int32))


@pytest.mark.parametrize("name,kw", [("star", {}),
                                     ("hierarchical", {"tiers": (4, 2)}),
                                     ("gossip", {"nodes": 5})])
def test_tier_suspect_counts_equal_the_reference(name, kw):
    status = np.random.default_rng(1).integers(0, 3, 40)
    assert pt_reduce.tier_suspect_counts(pt_graph.make_topology(name, **kw), 40,
                                         status) \
        == ref_reduce.tier_suspect_counts(ref_graph.make_topology(name, **kw), 40,
                                          status)
