"""The manifest keeps to the benchmark's contract, every part it names is a
file found by name (a configuration's family's modules through
`family.py`), and nothing the benchmark runs reads JAX, the JAX package
or the JAX package's benchmark."""
from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gpv_tpu"}


def metric_module(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["gpvbench"]
    assert 1 <= len(MAN["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    cells = 24   # what a full check must fit, with every cell there can be
    assert (2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_every_part_found_by_name():
    from gpvbench import family
    confs = {}
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["file"].startswith("gpvbench/")
        family.reference(conf)
        family.counts(conf)
        confs[c["name"]] = conf
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        assert any(c["name"] == w["config"] for c in MAN["configs"])
        traffic = json.loads((BENCH / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        if traffic["driver"] == "train":
            family.train_reference(confs[w["config"]])
    for m in MAN["per_layer"]:
        mod = metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"],
                                                    m["moves"])
    assert list((BENCH / "kernels").glob("attention*.json"))


def test_every_cell_reports_setup_another_and_a_layer():
    from gpvbench.run import cell_entries
    pairs = set()
    for w in MAN["workloads"]:
        pairs.add((w["config"], w["traffic"]))
        _, e2e, layer = cell_entries(MAN, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])
    assert len(pairs) == len(MAN["workloads"])
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_import_rule(path):
    """No module of the benchmark imports JAX or the JAX package (top-level
    names compared whole: `gpv_tpu_torch` is the system under test); the
    references and the counts import nothing of the program; nothing reads
    the JAX package's benchmark or its results."""
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if {"reference", "counts"} & set(path.relative_to(BENCH).parts):
        assert "gpv_tpu_torch" not in tops
    text = path.read_text()
    for name in ("bench" + ".py", "BENCH" + "_r0", "gpv_tpu" + "/"):
        assert name not in text


FAMILY_MODULES = {("reference", "gpv"), ("reference", "gpv_train"),
                  ("counts", "gpv")}


def _names(path: Path):
    """Every module a file imports, as absolute dotted names, with each
    name it takes from one."""
    package = list(path.relative_to(ROOT).parent.parts)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package[:len(package) + 1 - node.level] \
                if node.level else []
            base = ".".join(parts + (node.module or "").split(".")).strip(".")
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def _not_a_family_module(path: Path) -> bool:
    rel = path.relative_to(BENCH)
    return "tests" not in rel.parts and rel != Path("family.py") and \
        (rel.parts[0], rel.stem) not in FAMILY_MODULES


@pytest.mark.parametrize("path", sorted(filter(_not_a_family_module,
                                               BENCH.rglob("*.py"))),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_only_the_lookup_names_a_family(path):
    """A family's modules are found through `family.py`: no other module of
    the harness imports GPV-1's reference, training reference or counts
    by name."""
    for name in _names(path):
        assert tuple(name.split(".")[-2:]) not in FAMILY_MODULES, name


def test_the_family_modules_are_named_as_the_rule_knows():
    gpv_train = BENCH / "reference" / "gpv_train.py"
    assert "gpvbench.reference.gpv" in set(_names(gpv_train))
    assert not _not_a_family_module(gpv_train)
