"""On the card, at each cell's own size and limits: the control (the
reference in float8, put in the program's place) fails the cell's check
on three seeds, and each fault planted in the program underneath a short
run comes out as not correct. Skips without a card.

    python -m pytest -m cuda gpvbench/tests/test_gpvbench_card.py
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from gpvbench import run
from gpvbench.tests import test_gpvbench_drivers as drivers

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, seed, control=False):
    ctx = run.make_ctx(MAN, cell, seed, 3.0, False, "cuda",
                       time.perf_counter())
    ctx.control = control
    return ctx, run.run_cell(MAN, ctx) if not control else \
        ctx.driver().run(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [9001, 9002, 9003])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(card, cell, seed):
    ctx, out = _run(cell, seed, control=True)
    r, limits = out["readings"], ctx.config["limits"]
    # a configuration's limits serve every kind of cell it has
    keys = [k for k in limits if k in r]
    assert keys
    assert any(r[f"control_{k}"] > limits[k] for k in keys), r
    assert all(r[k] <= limits[k] for k in keys), r


FAULT_CASES = [(cell, fault) for cell in CELLS
               for fault in drivers.FAULTS[drivers.driver_of(cell)]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULT_CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULT_CASES])
def test_faults_fail_the_check(card, cell, fault, monkeypatch):
    fault(monkeypatch)
    _, out = _run(cell, 9100)
    assert out["correct"] is False, out["checks"]
