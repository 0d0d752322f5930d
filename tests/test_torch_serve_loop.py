"""The serving loop of the port against the reference's
(``repro.serve.loop.run_serve_loop``) on the same trace and weights: the
reduced tinyllama (f32), the same seed-0 params in both packages, the
synthetic ring of ``tests/test_serve.py`` (slot v % H holds the params
times 1 + 0.01 v), and the reference's random draws fed through ``ReplayDraws``
under its own key schedule (``split(PRNGKey(seed))`` into the router's
init key and ``k_dec``; decision d from ``fold_in(k_dec, d)``, tick t's
crash coins from ``fold_in(fold_in(k_dec, 2^24), t)``):

* markov routing with rejections and full picks: every decision,
  admission, stream (replica, version, staleness, ticks, tokens) and
  ``serve_stats`` count equal the reference's, the moments allclose at
  rtol 1e-6; the last tick's logits of a two-slot pool allclose at
  atol 1e-4 (the reference vmaps batch-1 caches, the port runs one
  batch-S step: f32 sums in another order);
* crash failover replayed: the crash set, failover and revival counts,
  reputation-penalized routing and every stream's tokens equal the
  reference's; at stagger 0 the tokens equal the calm run's;
* the fault, ``restart_ticks`` and ``reputation_penalty`` messages;
* a ring miss at stagger >= H;
* one reduced mamba2 pool: the tokens equal the reference's;
* ``launch.serve_fleet`` on the CPU: the summary's keys and flags are the
  reference driver's (read from its source), ``--device`` added.
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.faults import make_fault as ref_make_fault  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro.serve import ReplicaPool as RefPool  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.serve import VersionStore as RefStore  # noqa: E402
from repro.serve import run_serve_loop as ref_run  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.faults import make_fault  # noqa: E402
from repro_torch.launch import serve_fleet  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.serve import ReplicaPool, Request, VersionStore, run_serve_loop  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL_LOGITS = 1e-4
STEPS = 160  # replayed decisions / ticks fed (more than any run here makes)


def _setup(arch, h=4, latest=3):
    """Both packages' models and stores over one ring, built in numpy from
    the port's seed-0 params (the reference's model needs no init)."""
    cfg = get_arch(arch).reduced()
    model = factory.build(cfg)
    params = convert.lm_params_to_jax(model.init(torch.Generator().manual_seed(0)))
    lo = max(latest - (h - 1), 0)
    slot_ver = [0] * h
    for v in range(lo, latest + 1):
        slot_ver[v % h] = v
    hist = jax.tree.map(lambda p: np.stack([p * np.float32(1.0 + 0.01 * v)
                                            for v in slot_ver]), params)
    ref_store = RefStore(jax.tree.map(jnp.asarray, hist), jnp.asarray(latest, jnp.int32), h)
    store = VersionStore(convert.lm_params_from_jax(hist, "cpu"),
                         torch.tensor(latest, dtype=torch.int32), h)
    return {"cfg": cfg, "ref_model": ref_factory.build(ref_get_arch(arch).reduced()),
            "ref_store": ref_store, "model": model, "store": store}


@pytest.fixture(scope="module")
def lm():
    return _setup("tinyllama-1.1b")


def _trace(vocab, n, seed, prompt=4, burst=2):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, tick=i // burst, prompt=rng.integers(0, vocab, prompt).astype(np.int32),
                 gen_len=int(2 + (i * 7) % 4)) for i in range(n)]


def _replay(seed, R, router_m=None, probs=None):
    """The reference loop's draws under its keys (module docstring)."""
    k_init, k_dec = jax.random.split(jax.random.PRNGKey(seed))
    k_crash = jax.random.fold_in(k_dec, 1 << 24)
    init = {}
    if router_m is not None:
        pi = jnp.asarray(ref_lm.steady_state(probs).astype(np.float32))
        init["router/policy_init"] = np.asarray(
            jax.random.choice(k_init, router_m + 1, (R,), p=pi))
    idx = jnp.arange(STEPS)
    sel = np.asarray(jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(k_dec, i),
                                                           (R,)))(idx))
    hit = np.asarray(jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(k_crash, i),
                                                           (R,)))(idx))
    return ReplayDraws(init, [{"router/select": sel[i], "crash/hit": hit[i]}
                              for i in range(STEPS)], "cpu")


def _both(lm, trace, *, ref_faults=None, faults=None, markov_m=None, seed=0, pools=None,
          **kw):
    pools = pools or {}
    ref = ref_run(lm["ref_model"], lm["ref_store"], [RefRequest(**r) for r in trace],
                  seed=seed, faults=ref_faults, pool=pools.get("ref"), **kw)
    probs = None
    if markov_m is not None:
        probs = np.asarray(ref_lm.optimal_probs(kw["n_replicas"], 1, markov_m), np.float32)
    port = run_serve_loop(lm["model"], lm["store"], [Request(**r) for r in trace],
                          faults=faults, device="cpu", pool=pools.get("port"),
                          draws=_replay(seed, kw["n_replicas"], markov_m, probs), **kw)
    return ref, port


def _assert_same(ref, port):
    for name in ("ticks", "decisions", "rejections", "queue_left", "tokens_out",
                 "staleness_max"):
        assert getattr(port, name) == getattr(ref, name), name
    want = {r.rid: r for r in ref.results}
    assert sorted(want) == sorted(r.rid for r in port.results)
    for res in port.results:
        w = want[res.rid]
        for name in ("replica", "version", "staleness", "arrival_tick",
                     "first_token_tick", "done_tick", "tokens", "migrations"):
            assert getattr(res, name) == getattr(w, name), (res.rid, name)
    ss, ws = port.serve_stats, ref.serve_stats
    assert ss.keys() == ws.keys()
    for key in ("num_samples", "decisions", "replica_num_samples", "ring_miss", "crashes",
                "failed_over", "revived"):
        assert ss[key] == ws[key], key
    for key in ("mean_X", "var_X", "replica_mean_X", "replica_var_X"):
        np.testing.assert_allclose(ss[key], ws[key], rtol=1e-6)


def test_markov_loop_equals_reference(lm):
    trace = _trace(lm["cfg"].vocab_size, 10, seed=3)
    pools = {"ref": RefPool(lm["ref_model"], 3, 2, 9, stagger=1),
             "port": ReplicaPool(lm["model"], 3, 2, 9, stagger=1, device="cpu")}
    pools["ref"].refresh(lm["ref_store"])
    pools["port"].refresh(lm["store"])
    ref, port = _both(lm, trace, router="markov", markov_m=10, n_replicas=3, slots=2,
                      pools=pools)
    _assert_same(ref, port)
    assert port.rejections > 0 and len(port.results) == 10
    assert {r.staleness for r in port.results} == {0, 1, 2}

    # one more tick of the drained pools: two fresh streams on replica 2
    for r in trace[:2]:
        pools["ref"].join(2, RefRequest(**{**r, "gen_len": 4}), 0)
        pools["port"].join(2, Request(**{**r, "gen_len": 4}), 0)
    ref_pool, port_pool = pools["ref"], pools["port"]
    want, _ = ref_pool._tick_fn(ref_pool.params[2], ref_pool.pools[2], ref_pool.cur_tok[2])
    with torch.no_grad():
        got, _ = port_pool._tick_fn(port_pool.params[2], port_pool.pools[2],
                                    port_pool.cur_tok[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("router,restart,penalty", [
    ("round_robin", 0, 0.0),
    ("least_loaded", 2, 0.5),
])
def test_crash_failover_replayed_equals_reference(lm, router, restart, penalty):
    trace = [{**r, "tick": r["rid"] % 3} for r in _trace(lm["cfg"].vocab_size, 8, seed=11,
                                                          prompt=5)]
    kw = dict(router=router, n_replicas=3, slots=2, ctx=10, stagger=0,
              restart_ticks=restart, reputation_penalty=penalty)
    ref, chaos = _both(lm, trace, ref_faults=[ref_make_fault("replica_crash", 3, 0.3)],
                       faults=[make_fault("replica_crash", 3, 0.3)], **kw)
    _assert_same(ref, chaos)
    assert chaos.serve_stats["crashes"] > 0 and chaos.serve_stats["failed_over"] > 0
    assert len(chaos.results) == len(trace) and chaos.queue_left == 0
    assert (chaos.serve_stats["revived"] > 0) == (restart > 0)
    calm = run_serve_loop(lm["model"], lm["store"], [Request(**r) for r in trace],
                          device="cpu", **kw)
    calm_tokens = {r.rid: r.tokens for r in calm.results}
    for res in chaos.results:
        assert res.tokens == calm_tokens[res.rid], f"stream {res.rid} diverged across failover"


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_fault_and_option_messages_equal_reference(lm):
    ref_args = (lm["ref_model"], lm["ref_store"], [])
    args = (lm["model"], lm["store"], [])
    crash, ref_crash = make_fault("replica_crash", 2, 0.1), ref_make_fault("replica_crash", 2, 0.1)
    cases = [
        ({"faults": [make_fault("dropout", 4, 0.1)]},
         {"faults": [ref_make_fault("dropout", 4, 0.1)]}),
        ({"faults": [dataclasses.replace(crash, name="brownout")]},
         {"faults": [dataclasses.replace(ref_crash, name="brownout")]}),
        ({"restart_ticks": -1}, {"restart_ticks": -1}),
        ({"reputation_penalty": -0.5}, {"reputation_penalty": -0.5}),
    ]
    for kw, ref_kw in cases:
        got = _message(lambda: run_serve_loop(*args, device="cpu", **kw))
        assert got == _message(lambda: ref_run(*ref_args, **ref_kw))
    assert "engine-scope" in _message(
        lambda: run_serve_loop(*args, device="cpu", faults=cases[0][0]["faults"]))


def test_ring_miss_at_stagger_ge_h():
    lm = _setup("tinyllama-1.1b", h=4, latest=10)  # retained: 7..10
    trace = [Request(rid=i, tick=i, prompt=np.arange(4, dtype=np.int32) + i, gen_len=2)
             for i in range(2)]
    kw = dict(router="round_robin", n_replicas=2, slots=2, ctx=8, device="cpu")
    miss = run_serve_loop(lm["model"], lm["store"], trace, stagger=4, **kw)
    # replica 1 pins latest - 4 = 6 < 7: its read clips to 7 and is a miss
    assert miss.serve_stats["ring_miss"] == 1
    assert {r.version for r in miss.results} == {10, 7}
    calm = run_serve_loop(lm["model"], lm["store"], trace, stagger=1, **kw)
    assert calm.serve_stats["ring_miss"] == 0


def test_mamba2_pool_equals_reference():
    ssm = _setup("mamba2-370m")
    trace = _trace(ssm["cfg"].vocab_size, 5, seed=5)
    ref, port = _both(ssm, trace, router="round_robin", n_replicas=2, slots=2, ctx=9)
    _assert_same(ref, port)
    assert len(port.results) == 5


def _reference_driver_keys():
    """Flags and ``--out`` keys of ``repro.launch.serve_fleet``, from its
    source (running it would train the reference)."""
    tree = ast.parse((ROOT / "src/repro/launch/serve_fleet.py").read_text())
    flags, out_keys = [], None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flags.append(node.args[0].value)
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dump_json":
            out_keys = [k.value for k in node.args[1].keys]
    return flags, out_keys


def test_serve_fleet_cli_on_cpu(tmp_path, capsys):
    flags, out_keys = _reference_driver_keys()
    out = tmp_path / "fleet.json"
    argv = ["--device", "cpu", "--clients", "8", "--k", "2", "--rounds", "2", "--chunk", "1",
            "--ticks-per-chunk", "4", "--out", str(out)]
    summary = serve_fleet.main(argv)
    assert list(summary) == out_keys
    assert json.loads(out.read_text()).keys() == set(out_keys)
    assert set(summary["cli_args"]) == {f.lstrip("-").replace("-", "_") for f in flags} | {
        "device"}
    assert summary["streams"] > 0 and summary["tokens"] > 0
    assert len(summary["serve_stats"]) == 2
    assert "chunk 1: trained to v" in capsys.readouterr().out
    crashed = serve_fleet.main(argv[:-2] + ["--replicas", "3", "--crash-rate", "0.5"])
    assert crashed["streams"] > 0
    assert sum(s["crashes"] for s in crashed["serve_stats"]) > 0
