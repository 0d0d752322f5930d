"""CPU tests of the benchmark's harness: discovery by name, a cell added as
files alone, the frozen work formulas at the cells' shapes, the trace and
percentile arithmetic, and the imports of the harness and the references.

    python -m pytest -q bench/tests
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness, stats  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    spec = harness.cell_spec(cell)
    assert (harness.BENCH / "drivers" / f"{spec.traffic['kind']}.py").is_file()
    assert hasattr(harness.driver(spec.traffic["kind"]), "Cell")
    assert hasattr(harness.reference(spec.entry["config"]), "__doc__")
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert spec.limits, "a cell without limits cannot decide correct"


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_and_reference(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert (harness.BENCH / "reference" / f"{conf['name']}.py").is_file()


@pytest.mark.parametrize("name", ["cnn", "lm", "k1", "k2", "k6_fwd", "k6_bwd"])
def test_every_cost_file_has_cost(name):
    assert callable(harness.cost(name).cost)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


# --- the frozen formulas, against values worked by hand ---------------------

def _bound_ms(flops, nbytes, peak):
    return max(flops / peak, nbytes / 3.35e12) * 1e3


def test_k6_forward_bytes_bound_at_the_prefill_shape():
    # x 4*2048*32*64 bf16, B and C 4*2048*128 bf16, dt 4*2048*32 and A 32
    # f32 read; y f32 and the final state 4*32*64*128 f32 written
    flops, nbytes = harness.cost("k6_fwd").cost(B=4, S=2048, nh=32, hd=64, ds=128, L=256)
    x, bc, dt = 4 * 2048 * 32 * 64, 4 * 2048 * 128, 4 * 2048 * 32
    assert nbytes == 2 * (x + 2 * bc) + 4 * (dt + 32) + 4 * (x + 4 * 32 * 64 * 128)
    assert _bound_ms(flops, nbytes, 989e12) == pytest.approx(0.0329, abs=5e-5)


def test_k6_backward_bound_at_the_prefill_shape():
    flops, nbytes = harness.cost("k6_bwd").cost(B=4, S=2048, nh=32, hd=64, ds=128, L=256)
    # x, B, C bf16, dt, A and dy f32 read; dx, dB, dC bf16, ddt, dA (4 x 32)
    # and dh0 (4*32*64*128) f32 written
    x, bc, dt = 4 * 2048 * 32 * 64, 4 * 2048 * 128, 4 * 2048 * 32
    read = 2 * (x + 2 * bc) + 4 * (dt + 32 + x)
    written = 2 * (x + 2 * bc) + 4 * (dt + 4 * 32 + 4 * 32 * 64 * 128)
    assert nbytes == read + written == 148898432
    assert _bound_ms(flops, nbytes, 989e12) == pytest.approx(0.0444, abs=5e-5)


def test_cnn_flops_per_example():
    cfg = json.loads((harness.BENCH / "configs" / "paper-cnn-mnist.json").read_text())
    cnn = harness.cost("cnn")
    # conv1 28*28*32*25*2, conv2 14*14*64*800*2, fc1 3136*512*2, fc2 512*10*2
    assert cnn.cost(cfg, training=False) == 1254400 + 20070400 + 3211264 + 10240
    assert cnn.cost(cfg) == 3 * 24546304 - 1254400


def test_k1_and_k2_bounds_at_the_fl_shapes():
    cols = 832 + 51264 + 1606144 + 5130  # the CNN's parameters
    flops, nbytes = harness.cost("k1").cost(rows=30, cols=cols)
    assert _bound_ms(flops, nbytes, 67e12) == pytest.approx(0.0616, abs=5e-5)
    flops, nbytes = harness.cost("k2").cost(n=16384, k=256)
    assert nbytes == 65536 + 3072 and flops == 0


def test_mamba2_parameter_count_and_step_flops():
    cfg = json.loads((harness.BENCH / "configs" / "mamba2-370m.json").read_text())
    lm = harness.cost("lm")
    # the published 50277 tokens padded to 50288
    assert lm.n_params(cfg) == 368346624
    scan = harness.cost("k6_fwd").cost(B=8, S=2048, nh=32, hd=64, ds=128, L=256)[0] + \
        harness.cost("k6_bwd").cost(B=8, S=2048, nh=32, hd=64, ds=128, L=256)[0]
    assert lm.cost(cfg, 8, 2048, True) == 6 * 368346624 * 16384 + 48 * scan


# --- trace and percentile arithmetic ----------------------------------------

def test_union_idle_and_gaps():
    ivs = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert stats.merge(ivs) == [(0, 3), (5, 6), (8, 12)]
    assert stats.union_length(stats.clip(ivs, 0, 10)) == 3 + 1 + 2
    assert stats.gaps(ivs, -1, 10) == [(-1, 0), (3, 5), (6, 8)]


def test_p95_is_a_sample_with_five_percent_above():
    vals = list(range(1, 201))
    assert stats.p95(vals) == 190
    assert stats.p95([5.0]) == 5.0


def test_worst_leaf_gap_against_the_median_leaf():
    assert stats.worst_leaf_gap([1.0, 2.0, 0.0], [1.0, 2.0, 1e-9]) == pytest.approx(0.0, abs=1e-8)
    assert stats.worst_leaf_gap([1.1, 2.0, 3.0], [1.0, 2.0, 3.0]) == pytest.approx(0.05)
    assert stats.worst_leaf_gap([0.0, 2.0], [1.0, 2.0], keep=[False, True]) == 0.0


def test_trace_summary_names_idle_by_host_op():
    from bench import devtrace

    ops = [("k1", 0.0, 10.0), ("k2", 20.0, 30.0)]
    host = [(0.0, 100.0, "bench.fl.chunk"), (12.0, 18.0, "aten::item")]
    s = devtrace.TraceSummary(ops, 40e-6, 1, {},
                              devtrace._idle_by_host(ops, host, 0.0, 40.0))
    assert s.busy_s == pytest.approx(20e-6)
    assert s.idle_share == pytest.approx(0.5)
    assert s.idle_by_host == {"aten::item": pytest.approx(10e-6),
                              "bench.fl.chunk": pytest.approx(10e-6)}
    assert s.breakdown()["device_ops"][0][0] in ("k1", "k2")


# --- added as files alone ---------------------------------------------------

def test_a_cell_and_a_metric_added_as_files_alone(tmp_path, monkeypatch):
    """A new traffic, its limits and a new per-layer metric, as new files
    and new entries only, run end to end (CPU, a tiny size)."""
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((bench / "workloads" / "sync_markov.json").read_text())
    traffic.update(clients=12, k=3, local_epochs=1)
    (bench / "workloads" / "sync_tiny.json").write_text(json.dumps(traffic))
    (bench / "limits" / "cnn_sync_tiny.json").write_text(
        (bench / "limits" / "cnn_sync_markov.json").read_text())
    (bench / "metrics" / "rounds_traced.sync_tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    # a reader of its own overrides the shared one
    (bench / "metrics" / "idle_share.sync_tiny.py").write_text(
        "def read(ctx):\n    return 12.5\n")
    conf = json.loads((bench / "configs" / "paper-cnn-mnist.json").read_text())
    conf.update(name="paper-cnn-tiny", train_examples=1200, test_examples=500)
    (bench / "configs" / "paper-cnn-tiny.json").write_text(json.dumps(conf))
    shutil.copy(bench / "reference" / "paper-cnn-mnist.py", bench / "reference" / "paper-cnn-tiny.py")
    doc = json.loads(json.dumps(BENCH))
    doc["configs"].append({**doc["configs"][0], "name": "paper-cnn-tiny",
                           "file": "bench/configs/paper-cnn-tiny.json"})
    doc["workloads"].append({"name": "cnn_sync_tiny", "config": "paper-cnn-tiny",
                             "traffic": "sync_tiny", "chips": 1, "why": "a test"})
    doc["end_to_end"][0]["workloads"].append("cnn_sync_tiny")
    doc["per_layer"].append({"name": "rounds_traced.sync_tiny", "unit": "rounds",
                             "better": "higher", "source": "program_counter", "layer": "run loop",
                             "moves": "rounds_per_s", "workloads": ["cnn_sync_tiny"]})
    # an entry alone: read by the shared metrics/mfu.py
    for name in ("mfu.sync_tiny", "idle_share.sync_tiny"):
        doc["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                 "source": "host_clock", "layer": "cohort training",
                                 "moves": "rounds_per_s", "workloads": ["cnn_sync_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    for traced in (False, True):
        line = harness.run("cnn_sync_tiny", 7, 0.1, traced, 0.0, "cpu")
        assert line["correct"] is True
        assert line["attempted"] >= 2
        if traced:
            assert line["metrics"]["rounds_traced.sync_tiny"]["value"] == 2 * traffic["trace_chunks"]
            assert line["metrics"]["mfu.sync_tiny"]["value"] > 0
            assert line["metrics"]["idle_share.sync_tiny"]["value"] == 12.5
        else:
            assert set(line["metrics"]) == {"rounds_per_s", "setup_s"}


# --- imports ----------------------------------------------------------------

def _imports_of(path: Path):
    import ast

    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not set(_imports_of(path)) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_run_module_loads_jax_or_the_jax_package():
    """Load every driver, reference, reader and cost file (those of the
    cells kept for later too), and run a tiny sync cell, in a fresh
    process: no jax, jaxlib, flax or repro after."""
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from bench import harness\n"
        "for d in ('drivers', 'reference', 'metrics', 'cost'):\n"
        "    [harness.load_module(p) for p in sorted((harness.BENCH / d).glob('*.py'))]\n"
        "s = harness.cell_spec('cnn_sync_markov')\n"
        "s.config.update(train_examples=1200, test_examples=500)\n"
        "s.traffic.update(clients=12, k=3, local_epochs=1)\n"
        "harness.run('cnn_sync_markov', 3, 0.1, False, 0.0, 'cpu', s)\n"
        "bad = harness.forbidden_modules()\n"
        "print(json.dumps({'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": []}
