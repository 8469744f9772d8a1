"""Rules of the PyTorch port that no parity test sees.

- Nothing under gpv_tpu_torch/ and no line of chip_smoke.py imports jax,
  flax or gpv_tpu (the port keeps its own copies), nor PIL or h5py when
  it is imported (the card machine has neither).
- Entry points run on the card unless asked: an engine built without a
  device raises where CUDA is absent.
- CPU tensors take the plain versions and leave the launch counters at 0;
  tensors on any other non-CUDA device are refused.
- chip_smoke.py exits non-zero, printing no result, without a card and
  when it stands alone in a directory.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops import _cuda
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "gpv_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


PORT_FILES = sorted((ROOT / "gpv_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_gpv_tpu(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in BANNED, f"{path.name} imports {name}"


def _import_time_imports(tree):
    """Modules a file imports when it is imported: its module-level and
    class-level import statements, not those inside functions."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        else:
            yield from _import_time_imports(node)


def test_import_time_imports_skip_function_bodies():
    src = ("import PIL\ndef f():\n    import h5py\nclass A:\n"
           "    import h5py as h\n    def g(self):\n        import x\n"
           "try:\n    from PIL import Image\nexcept ImportError:\n    pass\n")
    assert list(_import_time_imports(ast.parse(src))) == ["PIL", "h5py",
                                                         "PIL"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_pil_or_h5py_at_import_time(path):
    """The card machine has neither: every module the card run imports
    must load without them, so they are imported where they are used."""
    tree = ast.parse(path.read_text(), str(path))
    for name in _import_time_imports(tree):
        assert name.split(".")[0] not in ("PIL", "h5py"), \
            f"{path.name} imports {name} at import time"


def test_kernel_sources_ship_as_package_data():
    """Every source that `_cuda` compiles exists and is matched by the
    package-data globs, so an installed package can still build it."""
    import tomllib
    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["gpv_tpu_torch"]
    pkg = ROOT / "gpv_tpu_torch"
    shipped = {p for g in globs for p in pkg.glob(g)}
    assert _cuda.SOURCES
    for name in _cuda.SOURCES:
        assert _cuda.CSRC / f"{name}.cu" in shipped


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    model = GPV(vocab_size=16, hidden_dim=32, co_att_num_layers=1,
                co_att_heads=4, co_att_intermediate=32,
                text_decoder_layers=1, text_decoder_heads=4,
                detr_cfg=dict(num_queries=4, hidden_dim=32, nheads=4,
                              num_encoder_layers=1, num_decoder_layers=1,
                              dim_feedforward=32,
                              backbone_layers=(1, 1, 1, 1)),
                bert_layers=1, bert_hidden=32, bert_heads=4,
                bert_vocab_size=100, bert_max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPVEngine(model, AnswerVocab.debug(size=16),
                  WordPieceTokenizer.debug())


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    A.fused_attention.launches = 0
    A.fused_biattention.launches = 0
    x = torch.randn(2, 5, 2, 8)
    y = torch.randn(2, 7, 2, 8)
    out = A.fused_attention(x, y, y, torch.ones(2, 7, dtype=torch.bool))
    torch.testing.assert_close(out, A.attend_plain(x, y, y))
    c1, c2 = A.fused_biattention(x, x, x, y, y, y)
    assert c1.shape == y.shape and c2.shape == x.shape
    assert A.fused_attention.launches == 0
    assert A.fused_biattention.launches == 0


def test_other_devices_are_refused():
    x = torch.empty(1, 3, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.fused_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        A.fused_biattention(x, x, x, x, x, x)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_launch_counts_lose_no_update_across_threads():
    """The serving workers launch kernels from several threads: 16
    threads counting 500 launches each, with a short switch interval,
    must total 8000."""
    import threading

    w = A.fused_biattention
    saved = w.launches, dict(w.variant_launches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w.launches, w.variant_launches = 0, dict.fromkeys(saved[1], 0)
        threads = [threading.Thread(
            target=lambda: [A._count(w, "tile") for _ in range(500)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert w.launches == w.variant_launches["tile"] == 8000
    finally:
        sys.setswitchinterval(old)
        w.launches, w.variant_launches = saved


def test_native_sources_ship_as_package_data():
    """Every C++ source the native runtime compiles is matched by the
    package-data globs, so an installed package can still build it."""
    import tomllib

    from gpv_tpu_torch.native import build
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]
    pkg = ROOT / "gpv_tpu_torch" / "native"
    shipped = {p for g in data["gpv_tpu_torch.native"] for p in pkg.glob(g)}
    for name in build.SOURCES:
        assert pkg / name in shipped


def test_data_files_ship_as_package_data():
    """The COCO synonyms behind the classification masks are matched by
    the package-data globs."""
    import tomllib
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]
    pkg = ROOT / "gpv_tpu_torch" / "evaluation"
    assert pkg / "coco_synonyms.json" in {
        p for g in data["gpv_tpu_torch.evaluation"] for p in pkg.glob(g)}
