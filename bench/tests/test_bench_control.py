"""The controls of each cell, on the card at the cell's own size, have to
come out not correct under the cell's limits: the plain reference put in
the program's place and computed one precision below the configuration's
(wholly in bfloat16 for the float32 CNN), and the program itself under
``torch.autocast`` to bfloat16.

    python -m pytest -q -m cuda bench/tests/test_bench_control.py
"""
import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    from bench import control, harness

    limits = harness.cell_spec(cell).limits
    got = control.control_readings(cell, 4094967291)
    assert any(not math.isfinite(got[k]) or got[k] > lim for k, lim in limits.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_under_autocast_is_not_correct(card, cell):
    import time

    from bench import control, harness

    line = harness.run(cell, 4094967293, 3.0, False, time.time(), "cuda",
                       within=lambda: control.autocast_bf16("cuda"))
    assert line["correct"] is False, line["checks"]
