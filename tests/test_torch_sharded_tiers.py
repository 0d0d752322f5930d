"""The sharded cases of slices C, D and E in the port, on a gloo world of 2
ranks (spawned once; every case runs sharded and one-device in the same
ranks):

  * a hierarchical (4, 2) topology with a heartbeat: sharded == one
    device bit for bit, per-tier accumulators included
    (``tests/test_topo.py::test_sharded_hierarchical_bit_for_bit``);
  * the tiered reduction cohort-parallel, async and sync: allclose to the
    replicated run (``test_cohort_sharded_*hierarchical*``; RTOL/ATOL of
    ``test_torch_cohort_engine.py``);
  * the armed defense (mtd under the scale attack): the defense state and
    params bitwise (``tests/test_defense.py::
    test_armed_sharded_matches_single``);
  * the quarantine mask and the collusion sketches over fleets of 8, 12
    and 16 clients, bitwise (``test_quarantine_mask_sharded_matches_single``,
    ``tests/test_collusion.py::test_collusion_sharded_matches_single_ragged``);
  * the chaos stack (every engine fault and a re-dispatch deadline) with
    fault exposure, bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import ranks  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

SMALL = dict(name="paper-cnn-mnist-tiers", image_size=8, conv_channels=(4, 8),
             fc_width=32)
N = 16
CFG = dict(n_clients=N, k=4, m=4, policy="markov", rounds=5, local_epochs=1,
           batch_size=5, eval_every=2, mode="async", buffer_size=3,
           profile="mobile")
HIER = {"topology": "hierarchical", "topology_kwargs": {"tiers": (4, 2)}}
ATTACK = dict(faults=("scale_attack",), fault_rate=1.0,
              fault_kwargs={"scale_attack": {"factor": -3.0, "client_frac": 0.25}})
ARMED_MTD = dict(defense=True, defense_kwargs={"threshold": 0.3, "mtd": True,
                                               "mtd_window": 2, "mtd_up": 0.05,
                                               "mtd_down": 0.01}, **ATTACK)
COLLUDE = dict(faults=("collude",), fault_rate=1.0,
               fault_kwargs={"collude": {"client_frac": 0.25, "jitter": 0.1}})
ARMED_COLLUSION = dict(defense=True, fault_exposure=True,
                       defense_kwargs={"threshold": 0.3, "collusion": True,
                                       "detector": "learned", "clique_min_obs": 2},
                       **COLLUDE)
CHAOS = dict(faults=("dropout", "straggler", "stale_replay", "corrupt", "sign_flip",
                     "collude"), fault_rate=0.5, redispatch_timeout=2.0,
             fault_exposure=True)
RAGGED_NS = (8, 12, 16)
RTOL, ATOL = 5e-4, 1e-5


def _task(n=N):
    return {"n": n, "data": (f"mnist-tiers{n}", 10, 8, 1, 120, 64), "cnn": SMALL}


def _case(name, drive="per_step", n=N, **kw):
    return {"name": name, "task": _task(n), "drive": drive,
            "cfg": {**CFG, "n_clients": n, "mesh_shards": 0, **kw}}


def _cases():
    out = [
        _case("hier", topology="hierarchical",
              topology_kwargs={"tiers": (4, 2), "heartbeat_timeout": 50.0}),
        _case("hier-fired", topology="hierarchical",
              topology_kwargs={"tiers": (4, 2), "heartbeat_timeout": 3.0}),
        _case("coh-hier", "run_engine", shard_cohort=True, **HIER),
        _case("coh-hier-sync", "run_engine", shard_cohort=True, mode="sync",
              buffer_size=None, profile="lognormal", **HIER),
        _case("armed", "chunked", rounds=8, **ARMED_MTD),
        _case("chaos", "chunked", rounds=6, **CHAOS),
    ]
    for n in RAGGED_NS:
        out.append(_case(f"quarantine{n}", "chunked", n=n, rounds=6, defense=True,
                         defense_kwargs={"threshold": 0.3}, **ATTACK))
        out.append(_case(f"collusion{n}", "chunked", n=n, rounds=6, **ARMED_COLLUSION))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    res = ranks.run_cases_on_ranks(cases + [ranks.single_case(c) for c in cases], 2,
                                   str(tmp_path_factory.mktemp("w2")))
    k = len(cases)
    return {c["name"]: (a, b) for c, a, b in zip(cases, res[:k], res[k:])}


def _same_bits(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _same_bits(a[key], b[key], f"{path}/{key}")
    else:
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path


def _close(a, b, path=""):
    if isinstance(a, dict):
        for key in a:
            _close(a[key], b[key], f"{path}/{key}")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("name", ["hier", "hier-fired"])
def test_sharded_hierarchical_bit_for_bit(world, name):
    sharded, single = world[name]
    for key in ("send", "loss", "state", "eval"):
        _same_bits(sharded[key], single[key], key)
    assert "tier_acc" in sharded["state"] and "hb" in sharded["state"]
    if name == "hier-fired":  # the heartbeat excluded updates
        assert float(single["state"]["stats"]["hb_expired"]) > 0


@pytest.mark.parametrize("name", ["coh-hier", "coh-hier-sync"])
def test_cohort_sharded_hierarchical_matches_replicated(world, name):
    coh, ref = world[name]
    np.testing.assert_array_equal(coh["selection"], ref["selection"])
    _close(coh["params"], ref["params"], "params")
    for key, val in ref["load_stats"].items():
        np.testing.assert_allclose(coh["load_stats"][key], val, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_armed_sharded_matches_single(world):
    sharded, single = world["armed"]
    _same_bits(sharded["state"]["defense"], single["state"]["defense"])
    _same_bits(sharded["state"]["params"], single["state"]["params"])
    assert float(single["state"]["defense"]["quarantined"]) > 0


@pytest.mark.parametrize("n", RAGGED_NS)
def test_quarantine_mask_sharded_matches_single(world, n):
    sharded, single = world[f"quarantine{n}"]
    _same_bits(sharded["state"]["defense"], single["state"]["defense"])
    _same_bits(sharded["state"]["params"], single["state"]["params"])


@pytest.mark.parametrize("n", RAGGED_NS)
def test_collusion_sharded_matches_single(world, n):
    sharded, single = world[f"collusion{n}"]
    assert sharded["state"]["defense"]["sketch"].shape[0] == n
    _same_bits(sharded["state"]["defense"], single["state"]["defense"])
    _same_bits(sharded["state"]["params"], single["state"]["params"])


def test_chaos_sharded_matches_single(world):
    sharded, single = world["chaos"]
    for key in ("send", "loss", "state"):
        _same_bits(sharded[key], single[key], key)
    faults = single["state"]["faults"]
    assert sum(float(f["injected"]) for f in faults.values()) > 0
    assert float(single["state"]["stats"]["rd_expired"]) > 0
