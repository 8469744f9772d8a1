"""The training CLI under tensor parallelism on the CPU, and its checkpoints
across topologies (the port's counterpart of tests/test_e2e.py:248-296,
where an 8x1 checkpoint resumes under 4x2 and saves back a full one).

`cli.train` runs as two gloo ranks with `tpu.mesh.model=2` (each a fresh
process of tests/_torch_tp_worker.py with a timeout of its own): one step
of the global batch 8, rank 0's in-train eval on the gathered weights and
a `last` save. Its file is a model-1 trainer's (names and whole shapes);
a one-process trainer resumes it to the same state bit for bit, steps,
saves, and two model-2 ranks resume that file and gather it back bit for
bit.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from gpv_tpu_torch.train import checkpoint
from gpv_tpu_torch.train import trainer as trainer_mod
from gpv_tpu_torch.utils.config import load_config

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data  # noqa
from _torch_tp_worker import ROOT, run_ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("tp_cli_data"))


def _args(fake_data, out, *extra):
    return [f"data_dir={fake_data}", f"output_dir={out}", "exp_name=tp",
            "learning_datasets=cap_vqa",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)
            ] + TINY_OVERRIDES + [
        "training.num_val_samples={coco_vqa: 4, coco_cap: 4}",
        "device=cpu", "tb_dir=null", "training.num_workers=1",
        "eval.num_workers=0", "training.run_vis_at_launch=false",
        "training.ckpt_step=1"] + list(extra)


def _cli_ranks(d: Path, argv, resume: bool) -> list:
    d.mkdir(parents=True, exist_ok=True)
    (d / "spec.json").write_text(json.dumps(
        {"task": "cli", "argv": argv, "resume": resume}))
    return run_ranks(d, 2)


def _same(a, b, where="payload"):
    """Bit-equal nested payloads: tensors of one dtype and bits."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    else:
        assert a == b, (where, a, b)


def test_cli_train_tp_checkpoints_move_between_topologies(fake_data,
                                                          tmp_path):
    tp_out, one_out, back_out = (tmp_path / n for n in ("tp", "one", "back"))
    outs = _cli_ranks(tmp_path / "r1", _args(fake_data, tp_out,
                                             "tpu.mesh.model=2"), False)
    assert all("over gloo on cpu" in o for o in outs)
    assert sum("epoch 0 it 0 step 1 loss" in o for o in outs) == 1
    # rank 0 evaluated (at launch) on the weights gathered over the group
    assert ["epoch 0 eval: {" in o for o in outs] == [True, False]
    tp_last = tp_out / "tp" / "ckpts" / "last"
    assert (tp_out / "tp" / "ckpts" / "model").exists()
    assert json.loads(tp_last.with_name("last.meta.json").read_text()) == {
        "epoch": 0, "step": 1}
    written = torch.load(tp_last, weights_only=True)

    # one process (model 1) resumes it: names and whole shapes are a
    # model-1 trainer's, and its state is the file's, bit for bit
    cfg = load_config(ROOT / "configs", "exp/gpv", _args(
        fake_data, one_out, f"training.ckpt={tp_last}"))
    tr = trainer_mod.Trainer(cfg)
    assert tr.tp is None and tr.step == 1
    assert {k: tuple(v.shape) for k, v in tr.model.state_dict().items()} \
        == {k: tuple(v.shape) for k, v in written["model"].items()}
    _same(checkpoint._payload(tr.state), written)

    # it steps and saves; two model-2 ranks resume that file and gather it
    # back to the same state, bit for bit
    tr.train_step(tr.state, next(iter(tr.loaders["train"])))
    tr.step += 1
    tr.save_last(0)
    one_last = one_out / "tp" / "ckpts" / "last"
    saved = torch.load(one_last, weights_only=True)
    assert saved["step"] == 2  # the moments moved (the lr is 0 by then)
    assert not torch.equal(saved["optimizer"]["state"][0]["exp_avg"],
                           written["optimizer"]["state"][0]["exp_avg"])
    _cli_ranks(tmp_path / "r2", _args(fake_data, back_out, "tpu.mesh.model=2",
                                      f"training.ckpt={one_last}"), True)
    _same(torch.load(tmp_path / "r2" / "restored.pt", weights_only=True),
          saved)
