"""Each driver end to end at tiny widths on the CPU, through the harness
(`tiny.run_tiny`, which skips only the look for a card); the real command
without a card; a cell and a metric added as new files only; and the
faults a served cell can have, planted in the program underneath, each
coming out as not correct."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpvbench.tests.tiny import TINY_LIMITS, run_tiny

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("trace", [0, 1], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(cell, trace):
    from gpvbench.run import cell_entries
    out = run_tiny(cell, seed=2 ** 31 + 11, trace=bool(trace))
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks" and out["checks"]
    _, e2e, layer = cell_entries(MAN, cell)
    if trace:
        # on the CPU there is no device trace: only span and counter
        # readers find something to read
        assert set(out["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
        for m in e2e:
            assert out["metrics"][m["name"]]["unit"] == m["unit"]


def test_the_command_needs_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "gpvbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_the_command_needs_the_program(tmp_path):
    shutil.copytree(ROOT / "gpvbench", tmp_path / "gpvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "gpvbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    shutil.copytree(ROOT / "gpvbench", tmp_path / "gpvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "gpvbench"
    traffic = json.loads((bench / "traffic" / "predict-greedy.json")
                         .read_text())
    traffic["templates"] = ["what is the {} next to ?"]
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "calls_seen.predict.py").write_text(
        'LAYER = "decode loop"\nUNIT = "calls"\n'
        'MOVES = "predict_images_per_s"\n\n\n'
        'def read(trace):\n    return len(trace.spans.durations("decode"))\n')
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "dummy-r50", "config": "gpv1-r50",
                             "traffic": "dummy-mix", "chips": 1,
                             "why": "a test cell"})
    man["per_layer"].append({"name": "calls_seen.predict", "unit": "calls",
                             "better": "higher", "source": "program_span",
                             "layer": "decode loop",
                             "moves": "predict_images_per_s",
                             "workloads": ["dummy-r50"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out = run_tiny("dummy-r50", trace=True, man=man, root=tmp_path)
    assert out["correct"] is True
    assert out["metrics"]["calls_seen.predict"]["value"] > 0
    assert (ROOT / "gpvbench" / "metrics" / "calls_seen.predict.py"
            ).exists() is False


def _alter_a_token(monkeypatch):
    """A token altered where it is produced: the decode loop's fourth
    token of every row is replaced by the next word."""
    import gpv_tpu_torch.engine as engine

    real = engine.greedy_decode

    def altered(*args, **kwargs):
        tokens, logits, steps = real(*args, **kwargs)
        tokens[:, 3] = (tokens[:, 3] + 1) % 60
        return tokens, logits, steps
    monkeypatch.setattr(engine, "greedy_decode", altered)


def _drop_half_the_batch(monkeypatch):
    """Half of the batch left out: the engine computes every other row of
    its batch and hands each answer to the row after it too (a server's
    batch is padded at its end, so its real rows are the first ones)."""
    from gpv_tpu_torch.engine import GPVEngine

    real = GPVEngine._greedy

    def half(self, images, qids, qvalid, vocab_mask, image_valid=None):
        keep = np.arange(0, len(qids), 2)
        tokens, boxes, rel = real(self, np.asarray(images)[keep],
                                  qids[keep], qvalid[keep], vocab_mask, None)
        idx = np.arange(len(qids)) // 2
        return tokens[idx], boxes[idx], rel[idx]
    monkeypatch.setattr(GPVEngine, "_greedy", half)


def _state_unchanged(monkeypatch):
    """A train step that returns its state unchanged: AdamW's update is
    skipped."""
    import torch
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _drop_half_the_train_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the train
    step uploads the first half of every batch's rows."""
    import gpv_tpu_torch.parallel.train_step as train_step

    real = train_step.batch_to_device

    def half(batch, device):
        k = len(batch["query_ids"]) // 2
        return real({key: v if key.startswith("query_uniq") else v[:k]
                     for key, v in batch.items()}, device)
    monkeypatch.setattr(train_step, "batch_to_device", half)


def _wrong_matching(monkeypatch):
    """The Hungarian matching off its optimum: every image's assignment
    rolled by one query. The reference matches on its own, so the
    localization losses part."""
    import gpv_tpu_torch.losses.criterion as criterion

    real = criterion.hungarian_match

    def rolled(*args, **kwargs):
        return real(*args, **kwargs).roll(1, dims=-1)
    monkeypatch.setattr(criterion, "hungarian_match", rolled)


def _none(monkeypatch):
    """No fault: the same run is correct under the same limits."""


# the faults each kind of cell can have, by its traffic's driver
FAULTS = {"predict": [_alter_a_token, _drop_half_the_batch],
          "serve": [_alter_a_token, _drop_half_the_batch],
          "train": [_state_unchanged, _drop_half_the_train_batch]}
# faults caught at tiny widths only: at random weights of the released
# widths every DETR query predicts about the same box, so any matching
# costs about the same and the losses cannot tell a wrong one
TINY_FAULTS = {"train": [_wrong_matching]}


def driver_of(cell: str) -> str:
    work = next(w for w in MAN["workloads"] if w["name"] == cell)
    return json.loads((ROOT / "gpvbench" / "traffic" /
                       f"{work['traffic']}.json").read_text())["driver"]


CASES = [(cell, fault) for cell in CELLS
         for fault in [_none] + FAULTS[driver_of(cell)]
         + TINY_FAULTS.get(driver_of(cell), [])]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in CASES])
def test_faults_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(cell, seed=5, config={"limits": TINY_LIMITS})
    assert out["correct"] is (fault is _none), out["checks"]
