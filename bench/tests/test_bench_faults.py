"""A run of each cell, on the CPU at a tiny size with the cell's own limits,
with the timed path broken underneath: ``correct`` has to come out false.
The faults a one-chip cell can have: a step that returns its state
unchanged; half of the batch (the cohort) left out, the mean taken over the
rest; an answer altered where it is produced.

    python -m pytest -q bench/tests/test_bench_faults.py
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import control, harness  # noqa: E402

TINY = {
    # a cohort of about 6 with 10 local steps each: wide and long enough
    # that the mean over half of it shows in the models' norms
    "cnn_sync_markov": ({"train_examples": 2000, "test_examples": 500},
                        {"clients": 20, "k": 6, "local_epochs": 5}),
    "cnn_async_fleet": ({"train_examples": 1200, "test_examples": 500},
                        {"clients": 64, "k": 8, "buffer": 8}),
    "mamba2_train_8x2k": ({"d_model": 64, "n_layer": 2, "vocab_size": 512},
                          {"batch": 2, "seq": 512, "pool": 6}),
    "mamba2_prefill_4x2k": ({"d_model": 64, "n_layer": 2, "vocab_size": 512},
                            {"batch": 2, "seq": 512, "pool": 6, "verify_calls": 4,
                             "state_calls_from": 2, "state_calls": 1}),
}


# The Mamba2 cells that PERF.md keeps for later (the port carries the
# residual stream in bfloat16, where mamba2-370m states float32): their
# files stay, and these are the limits they were read with.
LATER = {
    "mamba2_train_8x2k": ("mamba2-370m", "train_8x2k", {
        "loss_gap": 1.1e-4, "update_median_gap": 0.2, "change_median_gap": 0.09}),
    "mamba2_prefill_4x2k": ("mamba2-370m", "prefill_4x2k", {
        "served_logit_gap": 0.33, "state_gap": 0.3}),
}


def spec_of(cell):
    if cell not in LATER:
        return harness.cell_spec(cell)
    config, traffic, limits = LATER[cell]
    return harness.CellSpec(
        cell, {"name": cell, "config": config, "traffic": traffic, "chips": 1},
        harness.load_json(harness.BENCH / "configs" / f"{config}.json"),
        harness.load_json(harness.BENCH / "workloads" / f"{traffic}.json"), limits, [], [])


def run_tiny(cell, **kw):
    spec = spec_of(cell)
    conf, traffic = TINY[cell]
    spec.config.update(conf)
    spec.traffic.update(traffic)
    return harness.run(cell, 20260518, 0.2, False, 0.0, "cpu", spec, **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    line = run_tiny(cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", ["cnn_sync_markov", "cnn_async_fleet"])
def test_fl_lower_precision_is_not_correct(cell):
    """The program under autocast to bfloat16, one precision below the
    CNN's float32: the evaluation's logits at the start tell it."""
    line = run_tiny(cell, within=lambda: control.autocast_bf16("cpu"))
    assert line["correct"] is False
    assert line["checks"]["eval_logit_gap"]["value"] > line["checks"]["eval_logit_gap"]["limit"]


# --- the FL sync cell ---------------------------------------------------------

def test_fl_state_unchanged(monkeypatch):
    from repro_torch.engine.sync import SyncEngine

    orig = SyncEngine.run_chunk

    def stuck(self, state, r0, length, with_history):
        return state, orig(self, state, r0, length, with_history)[1]

    monkeypatch.setattr(SyncEngine, "run_chunk", stuck)
    assert run_tiny("cnn_sync_markov")["correct"] is False


def test_fl_half_the_cohort_left_out(monkeypatch):
    import repro_torch.engine.sync as sync

    orig = sync.cohort_indices

    def half(selected, width):
        idx, mask = orig(selected, width)
        keep = torch.cumsum(mask, 0) <= torch.ceil(mask.sum() / 2)
        return idx, mask * keep

    monkeypatch.setattr(sync, "cohort_indices", half)
    assert run_tiny("cnn_sync_markov")["correct"] is False


def test_fl_admission_altered(monkeypatch):
    from bench.drivers import fl

    orig = fl.Cell._build

    def build(self):
        orig(self)
        policy = self.engine.policy
        step = policy.step

        def altered(state, draws, **kw):
            sel, state = step(state, draws, **kw)
            return sel.clone().index_fill_(0, torch.tensor([0]), True), state

        object.__setattr__(policy, "step", altered)

    monkeypatch.setattr(fl.Cell, "_build", build)
    line = run_tiny("cnn_sync_markov")
    assert line["correct"] is False
    assert line["checks"]["admissions_differing"]["value"] > 0


# --- the training cell --------------------------------------------------------

def _wrap_sgd(monkeypatch, wrap):
    from repro_torch.models import factory

    orig = factory._sgd_step
    monkeypatch.setattr(factory, "_sgd_step", lambda loss: wrap(orig(loss)))


def test_train_state_unchanged(monkeypatch):
    _wrap_sgd(monkeypatch, lambda f: lambda p, b, lr: (p, f(p, b, lr)[1]))
    assert run_tiny("mamba2_train_8x2k")["correct"] is False


def test_train_half_the_batch_left_out(monkeypatch):
    def half(f):
        return lambda p, b, lr: f(p, {k: v[: v.shape[0] // 2] for k, v in b.items()}, lr)

    _wrap_sgd(monkeypatch, half)
    assert run_tiny("mamba2_train_8x2k")["correct"] is False


# --- the prefill cell ---------------------------------------------------------

def test_prefill_answer_altered(monkeypatch):
    from repro_torch.models import transformer

    orig = transformer.unembed

    def altered(params, cfg, x, specs=None):
        out = orig(params, cfg, x, specs)
        return out.index_add(-1, torch.tensor([7]), torch.full(out.shape[:-1] + (1,), 50.0,
                                                               dtype=out.dtype))

    monkeypatch.setattr(transformer, "unembed", altered)
    assert run_tiny("mamba2_prefill_4x2k")["correct"] is False


def test_prefill_state_altered(monkeypatch):
    from repro_torch.models import transformer

    orig = transformer._ssm_prefill

    def altered(p, h, spec):
        out, state, tail = orig(p, h, spec)
        return out, state * 0.5, tail

    monkeypatch.setattr(transformer, "_ssm_prefill", altered)
    assert run_tiny("mamba2_prefill_4x2k")["correct"] is False


# --- the FL async cell --------------------------------------------------------

def test_async_state_unchanged(monkeypatch):
    from repro_torch.engine.async_engine import AsyncEngine

    orig = AsyncEngine.run_chunk

    def stuck(self, state, r0, length, with_history):
        return state, orig(self, state, r0, length, with_history)[1]

    monkeypatch.setattr(AsyncEngine, "run_chunk", stuck)
    assert run_tiny("cnn_async_fleet")["correct"] is False


def _patch_engine(monkeypatch, patch):
    from bench.drivers import fl

    orig = fl.Cell._build

    def build(self):
        orig(self)
        patch(self.engine)

    monkeypatch.setattr(fl.Cell, "_build", build)


def test_async_half_the_buffer_left_out(monkeypatch):
    def patch(engine):
        weigh = engine.aggregator.weigh

        def half(mask, staleness):
            keep = torch.cumsum(mask.to(torch.int64), 0) <= (mask.sum() + 1) // 2
            return weigh(mask & keep, staleness)

        object.__setattr__(engine.aggregator, "weigh", half)

    _patch_engine(monkeypatch, patch)
    assert run_tiny("cnn_async_fleet")["correct"] is False


def test_async_admission_altered(monkeypatch):
    def patch(engine):
        step = engine.policy.step

        def altered(state, draws, **kw):
            sel, state = step(state, draws, **kw)
            return sel.clone().index_fill_(0, torch.tensor([0]), True), state

        object.__setattr__(engine.policy, "step", altered)

    _patch_engine(monkeypatch, patch)
    assert run_tiny("cnn_async_fleet")["correct"] is False
