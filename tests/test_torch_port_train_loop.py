"""The port's training loop on the CPU: checkpoints, the pretrained-DETR
and ImageNet-backbone loaders against `gpv_tpu`'s, the train-time
metrics against `gpv_tpu.train.metrics`, the in-train engine taking fresh
weights, the `Trainer` on tests/_fake_data.py data (two-epoch run with
its checkpoints, resume, finetune resume, auto-resume, `.pth` resume and
the refusals), and the training CLIs."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.train import checkpoint as JCK
from gpv_tpu.train import metrics as JMET

from gpv_tpu_torch.datasets.coco import DATASET_CLASSES
from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.nn.layers import FrozenBatchNorm
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.train import checkpoint as PCK
from gpv_tpu_torch.train import metrics as PMET
from gpv_tpu_torch.train import trainer as trainer_mod
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import init_random, state_dict_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data  # noqa
from _torch_train_common import ARGS, H, W  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- pretrained loaders

# the JAX loaders convert the released layout: ResNet-50, DETR 6+6 at 256
FULL_DETR = dict(num_queries=10, num_classes=1, hidden_dim=256, nheads=8,
                 num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=64)


@pytest.fixture(scope="module")
def full_detr_pair():
    jm = JaxGPV(dropout=0.0, detr_cfg=dict(FULL_DETR, dropout=0.0), **ARGS)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                  jnp.zeros((1, 5), jnp.int32),
                                  jnp.zeros((1, 8), jnp.int32)))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, dict(v))


def _port_of(v):
    pm = GPV(dropout=0.0, detr_cfg=FULL_DETR, **ARGS)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return pm


def _frozen_by_name(v, jax_paths):
    """Port name -> loaded by the JAX loader (its '/'-paths under detr),
    through the bridge with each leaf filled 1 if loaded else 0."""
    filled = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(np.shape(x), float(
            p[0].key == "detr"
            and "/".join(k.key for k in p[1:]) in jax_paths), np.float32),
        v["params"])
    sd = state_dict_from_jax({"params": filled, "batch_stats": jax.tree.map(
        np.zeros_like, v["batch_stats"])})
    return {n for n, t in sd.items() if bool(torch.all(t == 1))}


def _same_weights(pm, jax_vars):
    want = state_dict_from_jax(jax_vars)
    for name, t in pm.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0,
                                   msg=name)


def test_load_pretr_detr_matches_jax(full_detr_pair, tmp_path):
    v = full_detr_pair
    pm = _port_of(v)
    # a DETR checkpoint of another class count: class_embed must not load
    src = GPV(detr_cfg=dict(FULL_DETR, num_classes=2), **ARGS).detr
    init_random(src, seed=3)
    path = tmp_path / "detr.pth"
    torch.save({"model": {f"module.{k}": t for k, t in
                          src.state_dict().items()}}, path)
    want_vars, jax_matched = JCK.load_pretr_detr(
        jax.tree.map(np.copy, v), path)
    got = PCK.load_pretr_detr(pm, path)
    _same_weights(pm, want_vars)
    assert got == _frozen_by_name(v, jax_matched)
    assert "detr.class_embed.weight" not in got
    assert "detr.query_embed.weight" in got


def test_load_imagenet_backbone_matches_jax(full_detr_pair, tmp_path):
    v = full_detr_pair
    pm = _port_of(v)
    trunk = GPV(detr_cfg=FULL_DETR, **ARGS).detr.trunk
    init_random(trunk, seed=4)
    sd = dict(trunk.state_dict())
    sd.update({"fc.weight": torch.zeros(1000, 2048),
               "fc.bias": torch.zeros(1000)})
    path = tmp_path / "resnet50.pth"
    torch.save(sd, path)
    want_vars = JCK.load_imagenet_backbone(jax.tree.map(np.copy, v), path)
    PCK.load_imagenet_backbone(pm, path)
    _same_weights(pm, want_vars)


# ------------------------------------------------- train-time metrics

class _StubEngine:
    """Fixed predictions for both packages' metric functions: the answer
    cycles over a few words, the boxes step with the row."""

    def __init__(self, vocab):
        self.vocab = vocab

    def predict(self, images, queries, vocab_mask=None):
        out = []
        for i, _ in enumerate(queries):
            boxes = np.tile([[0.5, 0.5, 0.3, 0.3]], (10, 1)) + 0.01 * i
            out.append({"answer": ("two", "dog", "a man")[i % 3],
                        "boxes": boxes.astype(np.float32),
                        "relevance": np.linspace(1, 0, 10)})
        return out


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("fake"))


@pytest.mark.parametrize("task,node,fn", [
    ("CocoVqa", "coco_vqa", "vqa_accuracy"),
    ("CocoClassification", "coco_classification", "cls_metrics"),
    ("CocoCaptioning", "coco_captioning", "cap_metrics"),
    ("CocoDetection", "coco_detection", "det_metrics"),
    ("RefCocop", "refcocop", "refexp_metrics")])
def test_train_metrics_match_jax(fake_data, task, node, fn):
    from gpv_tpu.datasets.coco import DATASET_CLASSES as JAX_DATASETS
    from gpv_tpu.utils.config import load_config as jax_load
    over = [f"data_dir={fake_data}",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)]
    jcfg = jax_load("configs", "exp/gpv", over).task_configs[node]
    pcfg = load_config("configs", "exp/gpv", over).task_configs[node]
    want = getattr(JMET, fn)(_StubEngine(JaxVocab.debug()),
                             JAX_DATASETS[task](jcfg, "val"), 4, 5)
    got = getattr(PMET, fn)(_StubEngine(AnswerVocab.debug()),
                            DATASET_CLASSES[task](pcfg, "val"), 4, 5)
    assert got == want


# ------------------------------------------------- trainer

def _cfg(data, out, *extra):
    nvs = ["training.num_val_samples={coco_vqa: 4, coco_cap: 4, "
           "coco_det: 4, coco_cls: 4, refcocop: 4}"]
    return load_config("configs", "exp/gpv", [
        f"data_dir={data}", f"output_dir={out}", "exp_name=e2e",
        "learning_datasets=all",
        "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W),
    ] + TINY_OVERRIDES + nvs + [
        "device=cpu", "tb_dir=null", "training.num_workers=1",
        "eval.num_workers=0", "training.ckpt_step=2",
        "training.query_dedup=true"] + list(extra))


EVAL_KEYS = {"vqa_acc", "cider", "bleu4", "cls_acc", "det_map",
             "model_selection_metric"}  # gpv_tpu's Trainer.evaluate keys


@pytest.fixture(scope="module")
def trained(fake_data, tmp_path_factory):
    """Two epochs of 3 steps each (24 samples, batch 8), a rolling
    checkpoint every 2 steps, the launch visualisation on, steps 1-3
    traced."""
    out = tmp_path_factory.mktemp("run")
    cfg = _cfg(fake_data, out, "training.num_epochs=2",
               "training.run_vis_at_launch=true", "training.profile_step=1")
    tr = trainer_mod.Trainer(cfg)
    init = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    results = tr.train()
    return cfg, tr, init, results


def test_trainer_runs_and_writes_its_files(trained):
    cfg, tr, init, results = trained
    assert set(results) == EVAL_KEYS
    assert all(np.isfinite(v) for v in results.values())
    assert tr.step == 6
    ckpt = Path(cfg.ckpt_dir)
    for name in ("model", "model.meta.json", "last", "last.meta.json"):
        assert (ckpt / name).exists(), name
    assert json.loads((ckpt / "last.meta.json").read_text()) == {
        "epoch": 1, "step": 6}
    vis = Path(cfg.exp_dir) / "training_visualizations" / "train_0"
    assert (vis / "index.html").exists() and (vis / "0.jpg").exists()
    assert (Path(cfg.exp_dir) / "tb_logs" / "trace.json").exists()
    for name, p in tr.model.named_parameters():
        changed = not torch.equal(p.detach(), init[name])
        assert changed == p.requires_grad, name
        if name.startswith(("bert.", "detr.backbone.0.body.layer1.",
                            "vision_token", "lang_token")):
            assert not changed, name


def test_in_train_engine_takes_current_weights(trained):
    _, tr, _, _ = trained
    fresh = GPVEngine(tr.model, tr.vocab, tr.tokenizer, device="cpu",
                      dtype=torch.float32)
    tr.engine.load_weights(tr.model)
    images = np.random.RandomState(0).randint(0, 255, (2, IMG_H, IMG_W, 3),
                                              ).astype(np.uint8)
    a = tr.engine.predict(images, ["what is this?", "dog"])
    b = fresh.predict(images, ["what is this?", "dog"])
    for x, y in zip(a, b):
        assert x["answer"] == y["answer"]
        np.testing.assert_array_equal(x["boxes"], y["boxes"])
    # the training model keeps its unfolded BN
    assert isinstance(tr.model.detr.trunk.bn1, FrozenBatchNorm)


def test_checkpoint_round_trip(trained, tmp_path):
    _, tr, _, _ = trained
    PCK.save_checkpoint(tmp_path, tr.state, {"epoch": 3, "x": 1.5},
                        name="snap")
    payload, meta = PCK.restore_checkpoint(tmp_path, "snap")
    assert meta == {"epoch": 3, "x": 1.5} and payload["step"] == tr.state.step
    for k, t in tr.model.state_dict().items():
        assert torch.equal(payload["model"][k], t), k
    opt = tr.state.optimizer.state_dict()
    for i, s in opt["state"].items():
        for k, t in s.items():
            assert torch.equal(payload["optimizer"]["state"][i][k], t)
    assert not list(tmp_path.glob(".*writing"))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError,
                       match="convert_orbax_checkpoint.py"):
        PCK.restore_checkpoint(tmp_path, "orbax")


def _state_equal(a, b):
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.step == b.step


@pytest.mark.parametrize("mode", ["resume", "finetune", "auto"])
def test_trainer_resume(trained, fake_data, tmp_path, mode):
    cfg, tr, _, _ = trained
    last = Path(cfg.ckpt_dir) / "last"
    best = json.loads((Path(cfg.ckpt_dir) / "model.meta.json").read_text())
    if mode == "auto":
        new_cfg = _cfg(fake_data, tmp_path, "training.auto_resume=true",
                       f"ckpt_dir={cfg.ckpt_dir}")
    else:
        new_cfg = _cfg(fake_data, tmp_path, f"training.ckpt={last}")
    new = trainer_mod.Trainer(new_cfg, finetune=(mode == "finetune"))
    _state_equal(new.state, tr.state)
    if mode == "finetune":  # finetune_distr does not restore step/epoch
        assert (new.step, new.last_epoch) == (0, -1)
    else:
        assert (new.step, new.last_epoch) == (6, 1)
    if mode == "auto":  # the best metric comes from the best checkpoint
        assert new.best_metric == best["model_selection_metric"]
        assert new.best_epoch == best["epoch"]


def test_trainer_resumes_from_reference_pth(trained, fake_data, tmp_path):
    cfg, tr, _, _ = trained
    path = tmp_path / "model.pth"
    torch.save({"model": tr.model.state_dict()}, path)
    new = trainer_mod.Trainer(_cfg(fake_data, tmp_path,
                                   f"training.ckpt={path}"))
    for k, t in tr.model.state_dict().items():
        assert torch.equal(new.model.state_dict()[k], t), k
    assert new.step == 0


def test_trainer_pretrained_detr_freeze_and_vocab_embed(fake_data,
                                                        tmp_path):
    """model.pretr_detr with training.freeze: the loaded detr leaves are
    frozen, a leaf the checkpoint lacks (class_embed of another class
    count) keeps training, with the reference's warning, at the frozen
    batch size; model.vocab_embed fills the answer vocabulary's
    embedding."""
    cfg = _cfg(fake_data, tmp_path)
    src = init_random(trainer_mod.build_gpv(cfg.model, 128), seed=5).detr
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith("class_embed")}
    sd["class_embed.weight"] = torch.zeros(5, 32)
    torch.save({"model": sd}, tmp_path / "detr.pth")
    embed = np.random.RandomState(0).randn(128, 32).astype(np.float32)
    np.save(tmp_path / "embed.npy", embed)
    with pytest.warns(RuntimeWarning, match="detr params were initialized"):
        tr = trainer_mod.Trainer(_cfg(
            fake_data, tmp_path, f"model.pretr_detr={tmp_path / 'detr.pth'}",
            "training.freeze=true", f"model.vocab_embed={tmp_path}/embed.npy"))
    frozen = {n for n, p in tr.model.named_parameters() if not p.requires_grad}
    assert "detr.class_embed.weight" not in frozen
    assert "detr.transformer.decoder.norm.weight" in frozen
    assert "detr_joiner.weight" not in frozen
    for name, t in sd.items():
        if not name.startswith("class_embed"):
            assert torch.equal(tr.model.detr.state_dict()[name], t), name
    np.testing.assert_array_equal(
        tr.model.answer_head.vocab_embed.detach().numpy(), embed)
    # the frozen phase trains at training.frozen_batch_size
    assert tr.loaders["train"].batch_size == 120


@pytest.mark.parametrize("override,exc,match", [
    ("tpu.mesh={data: 2, model: 1}", ValueError, "1 process"),
    ("tpu.mesh={data: -1, model: 2}", ValueError, "multiple of 2 processes"),
    ("tpu.distributed.num_processes=2", None, None),
    ("tpu.remat=true", None, None),
    ("tpu.infer_data_parallel=2", ValueError, "local devices")], ids=[
    "tpu.mesh={data: 2, model: 1}-item 26",
    "tpu.mesh={data: -1, model: 2}-item 26",
    "tpu.distributed.num_processes=2-item 26",
    "tpu.remat=true-item 27", "tpu.infer_data_parallel=2-item 20"])
def test_trainer_refuses_what_is_not_ported(fake_data, tmp_path, override,
                                            exc, match):
    """Items 26, 27, 20 and 30 are ported, so the cases hold what the JAX
    trainer does instead: a data axis other than the processes joined, a
    model axis (tensor parallelism) over one process, which needs two,
    and more inference devices than the host has raise, a process count
    without a coordinator address joins nothing (one process), and
    `tpu.remat` builds a rematerialising model."""
    cfg = _cfg(fake_data, tmp_path, override)
    if exc is not None:
        with pytest.raises(exc, match=match):
            trainer_mod.Trainer(cfg)
        return
    tr = trainer_mod.Trainer(cfg)
    assert (tr.world, tr.rank, tr.is_main) == (1, 0, True)
    remat = override == "tpu.remat=true"
    assert tr.model.remat is remat
    assert tr.model.detr.trunk.remat is remat
    assert tr.model.detr.transformer.remat is remat


def test_trainer_defaults_to_the_card(fake_data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg(fake_data, tmp_path)
    cfg["device"] = None
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer_mod.Trainer(cfg)


# ------------------------------------------------- CLIs

def test_cli_train_runs_and_saves_its_config(fake_data, tmp_path,
                                             monkeypatch):
    from gpv_tpu_torch.cli import train as cli
    seen = {}

    class Spy:
        def __init__(self, cfg, finetune=False):
            seen["cfg"], seen["finetune"] = cfg, finetune

        def train(self):
            return {"ok": 1}

    monkeypatch.setattr(trainer_mod, "Trainer", Spy)
    args = [f"data_dir={fake_data}", f"output_dir={tmp_path}",
            "exp_name=x", "learning_datasets=all",
            "training.batch_size=4"] + TINY_OVERRIDES + ["device=cpu"]
    assert cli.main(args) == {"ok": 1}
    cfg = seen["cfg"]
    assert seen["finetune"] is False
    assert int(cfg.training.batch_size) == 8  # TINY_OVERRIDES come later
    assert cfg.device == "cpu"
    assert sorted(cfg.learning_datasets) == [
        "CocoCaptioning", "CocoClassification", "CocoDetection", "CocoVqa"]
    saved = load_config(tmp_path / "x", "config", [])
    assert int(saved.training.batch_size) == 8


def test_cli_finetune_selects_refcocop(fake_data, tmp_path, monkeypatch):
    from gpv_tpu_torch.cli import finetune as cli
    seen = {}

    class Spy:
        def __init__(self, cfg, finetune=False):
            seen["cfg"], seen["finetune"] = cfg, finetune

        def train(self):
            return {}

    monkeypatch.setattr(trainer_mod, "Trainer", Spy)
    cli.main([f"data_dir={fake_data}", f"output_dir={tmp_path}",
              "training.ckpt=/x/model"] + TINY_OVERRIDES)
    assert seen["finetune"] is True
    assert list(seen["cfg"].learning_datasets) == ["RefCocop"]
    assert seen["cfg"].training.ckpt == "/x/model"


def test_cli_train_end_to_end(fake_data, tmp_path):
    from gpv_tpu_torch.cli import train as cli
    results = cli.main([f"data_dir={fake_data}", f"output_dir={tmp_path}",
                        "exp_name=cli", "learning_datasets=cap_vqa",
                        "task_configs.image_size={H: %d, W: %d}"
                        % (IMG_H, IMG_W)] + TINY_OVERRIDES + [
        "training.num_val_samples={coco_vqa: 4, coco_cap: 4}",
        "device=cpu", "tb_dir=null", "training.num_workers=1",
        "eval.num_workers=0", "training.run_vis_at_launch=false"])
    assert set(results) == {"vqa_acc", "cider", "bleu4",
                            "model_selection_metric"}
    assert (tmp_path / "cli" / "config.yaml").exists()
    assert (tmp_path / "cli" / "ckpts" / "model").exists()
