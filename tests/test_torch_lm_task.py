"""The LM as the federated workload (``repro_torch.fl.make_lm_task``) and the
centralized ``launch.train`` driver against the reference on the CPU.

- ``make_lm_task``'s client documents and held-out set equal the
  reference's exactly (the same numpy token stream and windows).
- A replayed ``fl_train --arch tinyllama-1.1b --device cpu`` run (the task
  and run config the driver builds from its flags) against the reference's
  ``SyncEngine`` on the reference's task, from the reference's initial
  params and, through ``ReplayDraws``, its random draws: send masks, cohort
  indices and ages equal exactly; params after every round within rtol
  1e-4 / atol 1e-5 and eval losses within rtol 1e-5 (f32 sums in other
  orders, compounding over the local steps). The analogue of
  ``tests/test_fl_system.py::test_lm_task_federated``.
- ``fl_async --arch`` on the CPU, one device and two gloo ranks
  (``--mesh-shards 2``: the sharded engine cuts ``docs`` by leaf): finite
  losses.
- ``launch.train`` for 10 steps with a checkpoint written and read back bit
  for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.engine.sync as ref_sync_mod  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import load_metric as ref_lm  # noqa: E402
from repro.engine import RunConfig as RefRunConfig  # noqa: E402
from repro.engine import SyncEngine as RefSyncEngine  # noqa: E402
from repro.fl import make_lm_task as ref_make_lm_task  # noqa: E402
import repro_torch.engine.sync as pt_sync_mod  # noqa: E402
from repro_torch.checkpoint.store import load_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core.draws import ReplayDraws  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.engine import make_engine  # noqa: E402
from repro_torch.fl import make_lm_task  # noqa: E402
from repro_torch.launch import _fl_cli, fl_async, fl_train, train  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

ARCH = "tinyllama-1.1b"
N, K, M, ROUNDS, EPOCHS, BS, SEED = 12, 3, 4, 3, 1, 4, 0
ARGV = ["--arch", ARCH, "--device", "cpu", "--clients", str(N), "--k", str(K),
        "--m", str(M), "--rounds", str(ROUNDS), "--local-epochs", str(EPOCHS),
        "--batch-size", str(BS), "--lr", "0.05", "--seed", str(SEED)]
CFG = dict(mode="sync", n_clients=N, k=K, m=M, policy="markov", rounds=ROUNDS,
           local_epochs=EPOCHS, batch_size=BS, lr0=0.05, seed=SEED, eval_every=1)


@pytest.mark.parametrize("seq_len,docs,seed", [(64, 8, 0), (32, 4, 3)])
def test_documents_equal_the_reference(seq_len, docs, seed):
    ref = ref_make_lm_task(ref_get_arch(ARCH).reduced(), 6, seq_len=seq_len,
                           docs_per_client=docs, seed=seed)
    got = make_lm_task(get_arch(ARCH).reduced(), 6, seq_len=seq_len, docs_per_client=docs,
                       seed=seed, device="cpu")
    assert got.name == ref.name and got.examples_per_client == ref.examples_per_client
    for key in ("docs",):
        np.testing.assert_array_equal(got.client_data[key].numpy(),
                                      np.asarray(ref.client_data[key]))
        np.testing.assert_array_equal(got.eval_data[key].numpy(),
                                      np.asarray(ref.eval_data[key]))
    assert got.client_data["docs"].shape == (6, docs, seq_len + 1)
    assert got.eval_data["docs"].shape == (32, seq_len + 1)
    # eval_fn's mean is eval_batch_fn's sum over the held-out documents / 32
    params = got.init(_generator_draws())
    mean = got.eval_fn(params)
    sums = got.eval_batch_fn(params, got.eval_data)
    np.testing.assert_allclose(float(sums["loss"]) / 32, float(mean["loss"]), rtol=1e-6)
    assert float(mean["accuracy"]) == -float(mean["loss"])


def _generator_draws():
    from repro_torch.core.draws import GeneratorDraws

    return GeneratorDraws(0, "cpu")


def reference_draws(examples, width):
    """The reference's calm sync draws (engine/sync.py init split(key, 3);
    per round fold_in(k_run, r) split into k_sel and k_local, then
    split(k_local, width) and split(kb, epochs)), as in
    ``tests/test_torch_sync_slice.py``; the params come from k_init."""
    k_init, k_policy, k_run = jax.random.split(jax.random.PRNGKey(SEED), 3)
    pi = jnp.asarray(ref_lm.steady_state(ref_lm.optimal_probs(N, K, M)).astype(np.float32))
    init = {"policy_init": np.asarray(jax.random.choice(k_policy, M + 1, shape=(N,), p=pi))}
    steps = []
    for r in range(ROUNDS):
        k_sel, k_local = jax.random.split(jax.random.fold_in(k_run, r))
        perms = np.stack([
            np.stack([np.asarray(jax.random.permutation(ke, examples))
                      for ke in jax.random.split(kb, EPOCHS)])
            for kb in jax.random.split(k_local, width)])
        steps.append({"select": np.asarray(jax.random.uniform(k_sel, (N,))),
                      "local_perm": perms})
    return k_init, init, steps


def _record_cohorts(mp, module, record):
    cohorts = []
    orig = module.cohort_indices

    def cohort_indices(selected, width):
        idx, w = orig(selected, width)
        record(cohorts, idx, w)
        return idx, w

    mp.setattr(module, "cohort_indices", cohort_indices)
    return cohorts


@pytest.fixture(scope="module")
def replay():
    mp = pytest.MonkeyPatch()
    try:
        args = fl_train.parse_args(ARGV)
        cfg = _fl_cli.build_run_config(args, mode="sync", eval_div=30)
        task_p = _fl_cli.build_task(args)
        assert cfg.eval_every == 1 and task_p.device == torch.device("cpu")
        task_r = ref_make_lm_task(ref_get_arch(ARCH).reduced(), N, seq_len=64,
                                  docs_per_client=8, seed=SEED)
        ref_cohorts = _record_cohorts(mp, ref_sync_mod, lambda c, i, w: jax.debug.callback(
            lambda i_, w_: c.append((np.array(i_), np.array(w_))), i, w))
        eng_r = RefSyncEngine(task_r, RefRunConfig(**CFG))
        state = eng_r.init()
        ref_steps = []
        for r in range(ROUNDS):
            state, aux = eng_r.step(state, r)
            ref_steps.append({"send": np.asarray(aux["send"]),
                              "ages": np.asarray(state["sched"]["ages"]),
                              "params": jax.tree.map(np.asarray, state["params"]),
                              "eval_loss": float(eng_r.evaluate(state)["loss"])})
        k_init, init, steps = reference_draws(task_p.examples_per_client,
                                              cfg.cohort_width())
        init_params = jax.tree.map(np.asarray, task_r.init(k_init))
        task_p = dataclasses.replace(
            task_p, init=lambda draws: lm_params_from_jax(init_params, "cpu"))
        pt_cohorts = _record_cohorts(mp, pt_sync_mod, lambda c, i, w: c.append(
            (i.numpy().copy(), w.numpy().copy())))
        eng_p = make_engine(task_p, cfg, draws=ReplayDraws(init, steps, "cpu"))
        state = eng_p.init()
        pt_steps = []
        for r in range(ROUNDS):
            state, aux = eng_p.step(state, r)
            pt_steps.append({"send": aux["send"].numpy(),
                             "ages": state["sched"]["ages"].numpy(),
                             "params": lm_params_to_jax(state["params"]),
                             "eval_loss": float(eng_p.evaluate(state)["loss"])})
    finally:
        mp.undo()
    return dict(ref=ref_steps, pt=pt_steps, ref_cohorts=list(ref_cohorts[:ROUNDS]),
                pt_cohorts=pt_cohorts, init=init_params)


def test_replayed_fl_train_discrete_outputs_equal(replay):
    assert len(replay["pt_cohorts"]) == len(replay["ref_cohorts"]) == ROUNDS
    for r, (pt, ref) in enumerate(zip(replay["pt"], replay["ref"])):
        np.testing.assert_array_equal(pt["send"], ref["send"], err_msg=f"send {r}")
        np.testing.assert_array_equal(pt["ages"], ref["ages"], err_msg=f"ages {r}")
        (pi, pw), (ri, rw) = replay["pt_cohorts"][r], replay["ref_cohorts"][r]
        np.testing.assert_array_equal(pi, ri, err_msg=f"cohort idx {r}")
        np.testing.assert_array_equal(pw, rw, err_msg=f"cohort weights {r}")
    assert sum(int(w.sum()) for _, w in replay["ref_cohorts"]) > 0


def test_replayed_fl_train_params_within_tolerance(replay):
    for r, (pt, ref) in enumerate(zip(replay["pt"], replay["ref"])):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref["params"]),
                                jax.tree.leaves(pt["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {r} {jax.tree_util.keystr(path)}")
        np.testing.assert_allclose(pt["eval_loss"], ref["eval_loss"], rtol=1e-5)
        assert np.isfinite(pt["eval_loss"])
    # training moved the params
    assert not np.allclose(replay["ref"][-1]["params"]["embed"], replay["init"]["embed"])


@pytest.mark.parametrize("shards", [None, 2], ids=["one_device", "mesh_shards_2"])
def test_fl_async_arch_runs_on_the_cpu(shards):
    argv = ["--arch", ARCH, "--device", "cpu", "--clients", "16", "--k", "4",
            "--rounds", "2", "--local-epochs", "1", "--batch-size", "4"]
    if shards:
        argv += ["--mesh-shards", str(shards)]
    res = fl_async.main(argv)
    hist = res.history()
    assert len(hist["eval_loss"]) >= 1 and np.isfinite(hist["eval_loss"]).all()
    assert np.isfinite(hist["train_loss"]).all()


def test_fl_async_mamba2_runs_on_the_cpu():
    """mamba2 as the FL workload: the clients' ``vmap(grad)`` goes through
    K6's Function (its plain routes here)."""
    res = fl_async.main(["--arch", "mamba2-370m", "--device", "cpu", "--clients", "16",
                         "--k", "4", "--rounds", "2", "--local-epochs", "1",
                         "--batch-size", "4"])
    hist = res.history()
    assert len(hist["eval_loss"]) >= 1 and np.isfinite(hist["eval_loss"]).all()
    assert np.isfinite(hist["train_loss"]).all()


def test_train_driver_mamba2_ten_steps():
    out = train.main(["--device", "cpu", "--arch", "mamba2-370m", "--steps", "10",
                      "--batch", "2", "--seq", "32", "--log-every", "5"])
    assert out["cfg"].name == "mamba2-370m-reduced" and out["cfg"].d_model == 1024
    assert len(out["losses"]) == 10 and np.isfinite(out["losses"]).all()


def test_train_driver_ten_steps_and_checkpoint_round_trip(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = train.main(["--device", "cpu", "--steps", "10", "--batch", "2", "--seq", "128",
                      "--target-params", "2e6", "--log-every", "5", "--checkpoint", ck])
    text = capsys.readouterr().out
    assert "final loss" in text and "checkpoint ->" in text
    assert len(out["losses"]) == 10 and np.isfinite(out["losses"]).all()
    restored, step = load_checkpoint(ck, out["params"])
    assert step == 10
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
