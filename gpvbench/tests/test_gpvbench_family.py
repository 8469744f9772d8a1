"""A configuration's family (`family.py`): the lookup gives each
configuration the reference and counts GPV-1's always were (pinned
literals: the weights' names, shapes and kinds, the FLOPs, every
attention work item and its bound), and a second family comes as new
files only: its reference, counts, configuration, kernels file, a counter
on a stub kernel and its cell, run through the unchanged harness."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpvbench import family, run, trace
from gpvbench.flops import launches_bound_ms

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ROOT / "gpvbench" / "configs"

# What GPV-1's reference and counts gave before the family lookup, at the
# cells' sizes: B=20 480x640 images, 20 query tokens, 19 greedy steps; a
# train step of 120 rows, 64 unique queries, 20 answer tokens.
SPEC = {"len": 819,
        "sha256": "23382ee4c47b82cbf3563bdab853873159bbe961f5b65e422aad66"
                  "63b0ccdff1",
        "first": ["detr.backbone.0.body.conv1.weight", [64, 3, 7, 7],
                  "matrix"],
        "last": ["relevance_tokens", [2, 768], "embed"]}
R50_LAUNCHES = [
    (("detr_encoder_self", 20, 300, 300, 8, 32, False, 6, False),
     0.022008358208955223),
    (("detr_decoder_self", 20, 100, 100, 8, 32, False, 6, False),
     0.0073361194029850745),
    (("detr_decoder_cross", 20, 100, 300, 8, 32, False, 6, False),
     0.014672238805970149),
    (("bert_self", 20, 20, 20, 12, 64, True, 12, False),
     0.008804776119402984),
    (("coattention", 20, 100, 20, 16, 48, True, 3, True),
     0.01320537313432836),
    (("decode_self", 20, 1, 20, 8, 96, True, 57, False),
     0.02196014328358209),
    (("decode_cross", 20, 1, 120, 8, 96, True, 57, False),
     0.12653387462686566)]
DC5_LAUNCHES = [
    (("detr_encoder_self", 20, 1200, 1200, 8, 32, False, 6, False),
     0.17891526794742163),
    R50_LAUNCHES[1],
    (("detr_decoder_cross", 20, 100, 1200, 8, 32, False, 6, False),
     0.047684776119402986)] + R50_LAUNCHES[3:]
PINNED = {
    "gpv1-r50": (1393857105920.0, 21606676070400.0, R50_LAUNCHES,
                 0.21452088358208954),
    "gpv1-r50-dropout0": (1393857105920.0, 21606676070400.0, R50_LAUNCHES,
                          0.21452088358208954),
    "gpv1-dc5-r50": (2427523665920.0, 40212674150400.0, DC5_LAUNCHES,
                     0.40444033063398876)}


def _conf(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_lookup_gives_gpv1s_values(name):
    conf = _conf(name)
    assert conf["family"] == "gpv"
    ref, counts = family.reference(conf), family.counts(conf)
    model, V = conf["model"], conf["vocab_size"]
    spec = [[n, list(s), k] for n, s, k in ref.param_spec(model, V)]
    assert len(spec) == SPEC["len"]
    assert (spec[0], spec[-1]) == (SPEC["first"], SPEC["last"])
    assert hashlib.sha256(json.dumps(spec).encode()).hexdigest() == \
        SPEC["sha256"]
    predict, train, launches, bound = PINNED[name]
    assert counts.predict_flops(model, V, 20, 480, 640, 20, 19) == predict
    assert counts.train_flops(model, V, 120, 64, 480, 640, 20, 20) == train
    items = counts.predict_work(model, 20, 480, 640, 20, 19)
    assert list(items) == ["attention"]
    assert [(tuple(x), launches_bound_ms([x])) for x in items["attention"]
            ] == launches
    assert launches_bound_ms(items["attention"]) == bound
    # the predict driver's window sum: the parent reader's, call by call
    driver = run.load_file(ROOT / "gpvbench" / "drivers" / "predict.py",
                           "gpvbench_driver_predict")
    assert driver._window_work(counts, model, 20, 480, 640, 20,
                               [19, 19, 19]) == {
        "attention": sum([bound, bound, bound])}
    if name.endswith("dropout0"):
        assert hasattr(family.train_reference(conf), "train")


def test_a_configuration_names_its_family():
    conf = _conf("gpv1-r50")
    del conf["family"]
    with pytest.raises(ValueError, match="names no family"):
        family.reference(conf)
    with pytest.raises(ValueError, match="not a module name"):
        family.counts(dict(conf, family="../gpv"))


def test_kernel_kinds_keep_their_order():
    assert trace.kinds() == ("attention", "conv", "gemm", "copy")
    assert list(trace.group_table()) == list(trace.kinds())
    assert trace.counters() == {"attention": [
        "gpv_tpu_torch.ops.attention:fused_attention",
        "gpv_tpu_torch.ops.attention:fused_biattention"]}


def _recording(package: str, names, extra: str = "") -> str:
    """A module of the second family: GPV-1's module of `package`, each
    call of `names` recorded in `CALLED`."""
    return f'''
"""A second family: GPV-1's {package} module, every call recorded."""
from gpvbench.{package} import gpv as _gpv

CALLED = set()
{extra}

def _recorded(name):
    fn = getattr(_gpv, name)

    def call(*args, **kwargs):
        CALLED.add(name)
        return fn(*args, **kwargs)
    return call


{", ".join(names)} = map(_recorded, {tuple(names)!r})
'''


WRAPPED_REFERENCE = _recording(
    "reference", ["param_spec", "make_weights", "tokenize", "encode",
                  "answer_logits"], "Precision = _gpv.Precision\n")
WRAPPED_COUNTS = _recording("counts", ["predict_flops", "train_flops",
                                       "predict_work"])
# a stand-in for the program's module of a new hand kernel: its counter
STUB_PROGRAM = '''
def stub_kernel():
    """A kernel that is never launched."""


stub_kernel.variant_launches = {"run": 0}
'''
# the cell run twice through the harness, traced, on the CPU: as it is,
# then with the stub's count one launch a call above what the trace holds
DRIVE = '''
import json, time
import gpv_tpu_torch.engine as engine
import wrapped_program
from gpvbench import run, trace
from gpvbench.counts import wrapped as counts
from gpvbench.reference import wrapped as ref
from gpvbench.tests.tiny import tiny

real, off = engine.GPVEngine.predict, [0]


def predict(self, *args, **kwargs):
    wrapped_program.stub_kernel.variant_launches["run"] += off[0]
    return real(self, *args, **kwargs)


engine.GPVEngine.predict = predict
man, runs = run.manifest(), []
for off[0] in (0, 1):
    log = []
    ctx = tiny(run.make_ctx(man, "wrapped-predict", 7, 1.0, True, "cpu",
                            time.perf_counter()))
    ctx.log = log.append
    out = run.run_cell(man, ctx)
    runs.append({"correct": out["correct"], "log": log})
print(json.dumps({"runs": runs, "called": sorted(ref.CALLED | counts.CALLED),
                  "kinds": trace.kinds(), "group": trace.group_of(
                      "void wrapped_stub_run<4>", trace.group_table())}))
'''


def _git(cwd: Path, *args: str) -> str:
    return subprocess.run(["git", "-c", "user.name=t", "-c",
                           "user.email=t@example.com", *args], cwd=cwd,
                          check=True, capture_output=True, text=True).stdout


def _without(man: dict, cell: str, config: str) -> dict:
    """The manifest with the cell, its configuration and its name in every
    metric's `workloads` taken out."""
    out = json.loads(json.dumps(man))
    out["configs"] = [c for c in out["configs"] if c["name"] != config]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != cell]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != cell]
    return out


def test_a_new_family_is_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpvbench", copy / "gpvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    _git(copy, "init", "-q")
    _git(copy, "add", "-A")
    _git(copy, "commit", "-qm", "the benchmark")

    bench = copy / "gpvbench"
    (bench / "reference" / "wrapped.py").write_text(WRAPPED_REFERENCE)
    (bench / "counts" / "wrapped.py").write_text(WRAPPED_COUNTS)
    (copy / "wrapped_program.py").write_text(STUB_PROGRAM)
    conf = dict(_conf("gpv1-r50"), name="wrapped-r50", family="wrapped")
    (bench / "configs" / "wrapped-r50.json").write_text(json.dumps(conf))
    (bench / "kernels" / "stub-wrapped.json").write_text(json.dumps({
        "why": "a stub kernel", "fragments": ["wrapped_stub_"],
        "variants": {"stub_kernel.run": ["wrapped_stub_run"]},
        "counters": ["wrapped_program:stub_kernel"]}))
    man = json.loads((copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "wrapped-r50", "source": "a test",
                           "file": "gpvbench/configs/wrapped-r50.json",
                           "reduced": [], "why": "a second family"})
    man["workloads"].append({"name": "wrapped-predict",
                             "config": "wrapped-r50",
                             "traffic": "predict-greedy", "chips": 1,
                             "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "predict-greedy-r50" in m.get("workloads", []):
            m["workloads"].append("wrapped-predict")
    (copy / "BENCHMARK.json").write_text(json.dumps(man, indent=1) + "\n")

    # only added files, and the manifest's additions
    status = _git(copy, "status", "--porcelain", "--untracked-files=all")
    changed = sorted(line[3:] for line in status.splitlines()
                     if not line.startswith("??"))
    assert changed == ["BENCHMARK.json"], status
    base = json.loads(_git(copy, "show", "HEAD:BENCHMARK.json"))
    assert _without(man, "wrapped-predict", "wrapped-r50") == base
    assert len(man["configs"]) == len(base["configs"]) + 1
    assert len(man["workloads"]) == len(base["workloads"]) + 1

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", DRIVE],
                          cwd=copy, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["called"] == sorted(
        ["param_spec", "make_weights", "tokenize", "encode",
         "answer_logits", "predict_flops", "predict_work"])
    assert out["kinds"] == ["attention", "conv", "gemm", "copy", "stub"]
    assert out["group"] == "stub"
    as_is, off_by_one = out["runs"]
    assert as_is["correct"] is True and off_by_one["correct"] is True
    assert not any("lost records" in line for line in as_is["log"])
    lost = [line for line in off_by_one["log"] if "lost records" in line]
    assert lost and all("(stub: stub_kernel.run: 0 traced, " in line
                        for line in lost), off_by_one["log"]
