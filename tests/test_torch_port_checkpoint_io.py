"""The port's checkpoints on the CPU: async saves, loading the trainer's
own checkpoints through every entry point, and carrying a JAX run's orbax
checkpoint over.

- Async saves: the six cases of tests/test_checkpoint_async.py for
  `gpv_tpu_torch.train.checkpoint`, and AdamW steps taken while a save is
  in flight, which must not change what is restored (the port's AdamW
  updates in place).
- The trainer's checkpoints load everywhere: train one step through
  `gpv_tpu_torch.cli.train`, then `cli.compute_predictions
  eval.ckpt=<exp>/ckpts/model` writes the same boxes, relevance and
  answers as an engine given the trainer's weights in memory
  (`GPVEngine.load_weights`). A directory still raises, naming the
  converter.
- The converter (`convert_orbax_checkpoint.py`): the JAX package trains a
  tiny model 2 steps and saves it with its orbax `save_checkpoint`. The
  converted model equals `state_dict_from_jax` of the JAX parameters; its
  AdamW moments, mapped back through the JAX package's own torch-to-flax
  converter, equal optax's `mu` / `nu` per group; one more step on the
  same batch from the converted state in the port and from the orbax
  state in JAX gives parameters within the train-step tolerances of
  tests/test_torch_port_train_step.py (AdamW update: 1e-6 absolute); the
  output resumes the port's `Trainer` and loads in `build_engine`.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpv_tpu_torch.parallel.train_step import TrainState
from gpv_tpu_torch.train import checkpoint as PCK

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import TINY_OVERRIDES, make_fake_data  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
IMG_H, IMG_W = 48, 64


# ------------------------------------------------------------ async saves

def _state(seed):
    """A small TrainState with moments: a seeded two-layer model after one
    AdamW step, at `step` seed * 10."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 8))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.AdamW([{"params": list(model.parameters()),
                              "name": "others"}], lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    state = TrainState(model, opt, sched, seed * 10)
    _step(state, seed)
    return state


def _step(state, seed):
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(seed))
    state.optimizer.zero_grad()
    state.model(x).square().sum().backward()
    state.optimizer.step()
    state.scheduler.step()


def _copy(state):
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()})


def _assert_restores(payload, saved):
    model, opt = saved
    for k, v in model.items():
        assert torch.equal(payload["model"][k], v), k
    for i, s in opt.items():
        for k, v in s.items():
            assert torch.equal(payload["optimizer"]["state"][i][k], v), k


def test_async_save_restores_identically(tmp_path):
    state = _state(1)
    saved = _copy(state)
    PCK.save_checkpoint(tmp_path, state, {"epoch": 3}, async_write=True)
    PCK.wait_for_saves()
    payload, meta = PCK.restore_checkpoint(tmp_path)
    _assert_restores(payload, saved)
    assert payload["step"] == 10 and meta["epoch"] == 3
    assert payload["param_names"] == {"others": ["0.weight", "0.bias",
                                                 "1.weight", "1.bias"]}


def test_restore_joins_inflight_save(tmp_path):
    state = _state(2)
    saved = _copy(state)
    PCK.save_checkpoint(tmp_path, state, {"epoch": 1}, async_write=True)
    payload, _ = PCK.restore_checkpoint(tmp_path)  # no explicit wait
    _assert_restores(payload, saved)


def test_second_save_joins_first_on_same_path(tmp_path):
    s1, s2 = _state(3), _state(4)
    saved = _copy(s2)
    PCK.save_checkpoint(tmp_path, s1, {"epoch": 1}, async_write=True)
    PCK.save_checkpoint(tmp_path, s2, {"epoch": 2}, async_write=True)
    PCK.wait_for_saves()
    payload, meta = PCK.restore_checkpoint(tmp_path)
    _assert_restores(payload, saved)
    assert meta["epoch"] == 2


def test_previous_checkpoint_survives_failed_write(tmp_path, monkeypatch):
    """A write that fails raises at its join, once; the previous
    checkpoint stays whole, and a later save on the path goes on."""
    s1 = _state(7)
    saved = _copy(s1)
    PCK.save_checkpoint(tmp_path, s1, {"epoch": 1})  # sync, committed
    save = torch.save

    def disk_full(obj, f, *a, **k):
        Path(f).write_bytes(b"partial")
        raise IOError("disk full")
    monkeypatch.setattr(torch, "save", disk_full)
    PCK.save_checkpoint(tmp_path, _state(8), {"epoch": 2}, async_write=True)
    with pytest.raises(IOError, match="disk full"):
        PCK.wait_for_saves()
    with PCK._INFLIGHT_LOCK:
        assert not PCK._INFLIGHT
    PCK.wait_for_saves()  # raised once: nothing left to join
    payload, meta = PCK.restore_checkpoint(tmp_path)
    assert meta["epoch"] == 1
    _assert_restores(payload, saved)
    monkeypatch.setattr(torch, "save", save)
    s3 = _state(9)
    PCK.save_checkpoint(tmp_path, s3, {"epoch": 3}, async_write=True)
    payload, meta = PCK.restore_checkpoint(tmp_path)
    assert meta["epoch"] == 3 and payload["step"] == 90


def test_meta_never_describes_uncommitted_payload(tmp_path):
    """A stale `.model.writing` from a write cut short is replaced; the
    meta is written after the payload is in place."""
    (tmp_path / ".model.writing").write_text("garbage")
    PCK.save_checkpoint(tmp_path, _state(8), {"epoch": 5}, async_write=True)
    PCK.wait_for_saves()
    assert not (tmp_path / ".model.writing").exists()
    payload, meta = PCK.restore_checkpoint(tmp_path)
    assert meta["epoch"] == 5 and payload["step"] == 80


def test_distinct_names_write_concurrently(tmp_path):
    PCK.save_checkpoint(tmp_path, _state(5), {"epoch": 1}, name="model",
                        async_write=True)
    PCK.save_checkpoint(tmp_path, _state(6), {"epoch": 1, "step": 60},
                        name="last", async_write=True)
    with PCK._INFLIGHT_LOCK:
        assert len(PCK._INFLIGHT) <= 2
    PCK.wait_for_saves()
    assert PCK.restore_checkpoint(tmp_path, "model")[0]["step"] == 50
    assert PCK.restore_checkpoint(tmp_path, "last")[0]["step"] == 60


def test_steps_during_an_inflight_save_do_not_change_it(tmp_path,
                                                        monkeypatch):
    """The writer holds host copies taken at the save: AdamW steps taken
    while it writes (in place: parameters, moments, per-parameter step)
    leave the checkpoint at the saved state; the buffers are reused by the
    path's next save."""
    import threading
    gate = threading.Event()
    save = torch.save

    def slow_save(obj, f, *a, **k):
        gate.wait(timeout=60)
        return save(obj, f, *a, **k)
    monkeypatch.setattr(torch, "save", slow_save)
    state = _state(11)
    saved = _copy(state)
    PCK.save_checkpoint(tmp_path, state, {"epoch": 0}, async_write=True)
    for i in range(3):
        _step(state, 100 + i)
    assert not torch.equal(state.model[0].weight, saved[0]["0.weight"])
    gate.set()
    payload, _ = PCK.restore_checkpoint(tmp_path)
    _assert_restores(payload, saved)
    assert payload["step"] == 110
    buffers = PCK._BUFFERS[str((tmp_path / "model").resolve())]
    held = {k: v.data_ptr() for k, v in buffers.items()}
    later = _copy(state)
    PCK.save_checkpoint(tmp_path, state, {"epoch": 1}, async_write=True)
    PCK.wait_for_saves()
    assert {k: v.data_ptr() for k, v in buffers.items()} == held
    _assert_restores(PCK.restore_checkpoint(tmp_path)[0], later)


# --------------------------------------------- the trainer's checkpoints

@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("fake"))


def _overrides(data, out, *extra):
    return [f"data_dir={data}", f"output_dir={out}", "exp_name=f2",
            "learning_datasets=all",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W),
            ] + TINY_OVERRIDES + [
            "device=cpu", "tb_dir=null", "training.num_workers=1",
            "eval.num_workers=0", "eval.batch_size=4",
            "training.num_val_samples={coco_vqa: 2, coco_cap: 2, "
            "coco_det: 2, coco_cls: 2, refcocop: 2}"] + list(extra)


def test_trained_checkpoint_loads_through_compute_predictions(
        fake_data, tmp_path, monkeypatch):
    """Train one step through the CLI, then predict with its ckpts/model:
    equal to an engine given the trainer's weights in memory."""
    import h5py

    from gpv_tpu_torch.cli import compute_predictions
    from gpv_tpu_torch.cli import train as train_cli
    from gpv_tpu_torch.datasets.coco import DATASET_CLASSES
    from gpv_tpu_torch.infer.predictions import make_predictions
    from gpv_tpu_torch.train import trainer as trainer_mod
    from gpv_tpu_torch.utils.config import load_config

    made = []

    class Recorded(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(trainer_mod, "Trainer", Recorded)
    train_cli.main(_overrides(
        fake_data, tmp_path, "training.batch_size=16",
        "training.run_eval_at_launch=false",
        "training.run_vis_at_launch=false"))
    trainer, = made
    assert trainer.step == 1
    ckpt = Path(trainer.cfg.ckpt_dir) / "model"
    assert ckpt.is_file() and ckpt.suffix == ""
    task = "CocoVqa"
    compute_predictions.main(_overrides(
        fake_data, tmp_path, f"eval.task={task}", "eval.subset=val",
        f"eval.ckpt={ckpt}", "eval.loader=threads"))
    cfg = load_config("configs", "exp/gpv", _overrides(fake_data, tmp_path))
    trainer.engine.load_weights(trainer.model)
    ds = DATASET_CLASSES[task](cfg.task_configs.coco_vqa, "val")
    mem = tmp_path / "memory"
    make_predictions(trainer.engine, ds, task, 4, mem, "val")
    cli = Path(cfg.exp_dir) / "eval"
    name = f"{task}_gpv_split_val_predictions.json"
    got, want = (json.loads((d / name).read_text()) for d in (cli, mem))
    assert got == want and len(got) == len(ds)
    with h5py.File(cli / f"{task}_val_boxes.h5py") as a, \
            h5py.File(mem / f"{task}_val_boxes.h5py") as b:
        assert sorted(a) == sorted(b)
        for key in a:
            for field in ("boxes", "relevance"):
                np.testing.assert_array_equal(a[key][field][()],
                                              b[key][field][()])


def test_trainer_async_checkpoints_land_before_train_returns(
        fake_data, tmp_path, monkeypatch):
    """training.async_checkpoint=true: the best and rolling saves go to the
    writer thread, every save is joined before a loader forks its workers,
    and all have landed when train() returns, holding the final state."""
    from gpv_tpu_torch.train import trainer as trainer_mod
    from gpv_tpu_torch.utils.config import load_config
    joins, asyncs = [], []
    wait, save = trainer_mod.wait_for_saves, trainer_mod.save_checkpoint
    monkeypatch.setattr(trainer_mod, "wait_for_saves",
                        lambda *a: joins.append(a) or wait(*a))
    monkeypatch.setattr(trainer_mod, "save_checkpoint", lambda *a, **k: (
        asyncs.append(k.get("async_write")), save(*a, **k))[1])
    tr = trainer_mod.Trainer(load_config("configs", "exp/gpv", _overrides(
        fake_data, tmp_path, "training.batch_size=8", "training.ckpt_step=1",
        "training.run_vis_at_launch=false",
        "training.async_checkpoint=true")))
    tr.train()
    with PCK._INFLIGHT_LOCK:
        assert not PCK._INFLIGHT
    assert asyncs and all(asyncs) and len(joins) >= 4
    for name in ("model", "last"):
        payload, meta = PCK.restore_checkpoint(tr.cfg.ckpt_dir, name)
        if name == "last":
            assert payload["step"] == tr.step == meta["step"]
            for k, v in tr.model.state_dict().items():
                assert torch.equal(payload["model"][k], v), k


def test_build_engine_refuses_a_directory_naming_the_converter(tmp_path):
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.utils.config import load_config
    (tmp_path / "model").mkdir()
    cfg = load_config("configs", "exp/gpv_inference", TINY_OVERRIDES + [
        f"ckpt={tmp_path / 'model'}", "device=cpu"])
    with pytest.raises(NotImplementedError,
                       match="convert_orbax_checkpoint.py exp_dir="):
        build_engine(cfg)


# ------------------------------------------------------------- converter

SPE = 10  # steps per epoch of both schedules
NOISE = 1e-5  # the train-step test's gradient floor


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, fake_data):
    """A tiny JAX run: config.yaml, 2 AdamW steps on one batch, its orbax
    checkpoint `ckpts/model`; and the state after those 2 steps."""
    import jax

    from gpv_tpu.losses import LossConfig as JaxLossConfig
    from gpv_tpu.models.gpv import build_gpv
    from gpv_tpu.parallel import create_train_state, make_train_step
    from gpv_tpu.text.vocab import AnswerVocab
    from gpv_tpu.train import build_optimizer
    from gpv_tpu.train.checkpoint import save_checkpoint
    from gpv_tpu.utils.config import load_config, save_config
    from _torch_train_common import jax_variables, make_batch

    out = tmp_path_factory.mktemp("jax_run")
    overrides = _overrides(fake_data, out, "model.detr.dropout=0.0",
                           "training.lr=1e-3", "training.num_epochs=2")
    cfg = load_config("configs", "exp/gpv", overrides)
    exp_dir = Path(cfg.exp_dir)
    exp_dir.mkdir(parents=True)
    save_config(cfg, exp_dir / "config.yaml")
    jm = build_gpv(cfg.model, vocab_size=len(AnswerVocab.debug()))
    v = jax_variables(jm)
    tx = build_optimizer(cfg.training, SPE, v["params"])
    step = make_train_step(jm, tx, JaxLossConfig.from_config(cfg.losses),
                           float(cfg.training.clip_max_norm), donate=False)
    batch = make_batch(8)
    state = create_train_state(v, tx)
    for _ in range(2):
        state, _ = step(state, jax.tree.map(np.asarray, batch),
                        jax.random.PRNGKey(0))
    meta = {"epoch": 0, "step": 2, "model_selection_metric": 0.25}
    save_checkpoint(cfg.ckpt_dir, state, meta)
    return SimpleNamespace(cfg=cfg, overrides=overrides, exp_dir=exp_dir,
                           state=state, step=step, batch=batch, meta=meta,
                           out=out / "converted")


@pytest.fixture(scope="module")
def converted(jax_run):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_checkpoint", ROOT / "convert_orbax_checkpoint.py")
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    path = conv.main([f"exp_dir={jax_run.exp_dir}", "name=model",
                      f"out={jax_run.out}"])
    assert path == (jax_run.out / "model").resolve()
    payload, meta = PCK.restore_checkpoint(jax_run.out, "model")
    return conv, payload, meta


def _to_jax(sd):
    from gpv_tpu.train.checkpoint import convert_gpv_torch
    return convert_gpv_torch(
        {k: np.asarray(v) for k, v in sd.items()}, num_co_att=1,
        text_dec_layers=1, hidden=32, detr_layers=(1, 1, 1, 1), detr_dim=32,
        detr_enc=1, detr_dec=1, bert_layers=1)["params"]


def test_converted_model_and_meta(jax_run, converted):
    from gpv_tpu_torch.weights import state_dict_from_jax
    _, payload, meta = converted
    want = state_dict_from_jax({"params": jax_run.state.params,
                                "batch_stats": jax_run.state.batch_stats})
    assert set(payload["model"]) == set(want)
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k
    assert payload["step"] == 2 and payload["scheduler"] is None
    assert meta == jax_run.meta


def test_converted_moments_equal_optax(jax_run, converted):
    """Each group's exp_avg / exp_avg_sq, mapped back to the flax layout
    by the JAX package's own converter, equal optax's mu / nu on the
    group's leaves; every step count is optax's count."""
    import jax
    import optax
    conv, payload, _ = converted
    opt = payload["optimizer"]
    groups = {g["name"]: g for g in opt["param_groups"]}
    jax_states = jax_run.state.opt_state.inner_states
    moving = [g for g, s in jax_states.items()
              if conv._adam_state(s.inner_state) is not None]
    assert sorted(groups) == sorted(moving)
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    for name, g in groups.items():
        adam = conv._adam_state(jax_states[name].inner_state)
        names = payload["param_names"][name]
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            sd = {k: torch.zeros_like(v) for k, v in payload["model"].items()}
            for i, n in zip(g["params"], names):
                sd[n] = opt["state"][i][key]
                assert float(opt["state"][i]["step"]) == 2.0
            back = dict(jax.tree_util.tree_leaves_with_path(_to_jax(sd)))
            leaves = jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=masked)
            n_in = 0  # elements: the group covers what optax's does
            for path, x in leaves:
                if not masked(x):
                    np.testing.assert_array_equal(back[path], np.asarray(x),
                                                  err_msg=f"{name} {path}")
                    n_in += np.size(x)
            assert n_in == sum(payload["model"][n].numel() for n in names)


def _port_state(jax_run):
    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.text.vocab import AnswerVocab
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.utils.config import load_config
    cfg = load_config("configs", "exp/gpv", jax_run.overrides)
    model = build_gpv(cfg.model, len(AnswerVocab.debug()))
    opt, sched = build_optimizer(cfg.training, SPE, model)
    return cfg, TrainState(model, opt, sched)


def test_next_step_from_converted_state_matches_jax(jax_run, converted):
    import jax
    from gpv_tpu.train.checkpoint import restore_checkpoint

    from gpv_tpu_torch.losses.criterion import LossConfig
    from gpv_tpu_torch.parallel.train_step import make_train_step
    _, payload, _ = converted
    restored, _ = restore_checkpoint(jax_run.cfg.ckpt_dir, jax_run.state)
    jstate = jax_run.state.replace(
        params=restored["params"], batch_stats=restored["batch_stats"],
        opt_state=restored["opt_state"], step=restored["step"])
    jnew, jlosses = jax_run.step(jstate, jax.tree.map(np.asarray,
                                                      jax_run.batch),
                                 jax.random.PRNGKey(0))
    cfg, state = _port_state(jax_run)
    PCK.load_into(state, payload)
    assert state.step == 2
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    step = make_train_step(state.model, LossConfig.from_config(cfg.losses),
                           float(cfg.training.clip_max_norm))
    plosses = step(state, jax_run.batch)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(plosses[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the AdamW update is compared where this step's gradient is above
    # both 1e-3 x max|g| of the leaf and NOISE, as in the train-step test:
    # elsewhere (leaves whose true gradient is zero) Adam turns rounding
    # noise into updates of order lr
    sd = state.model.state_dict()
    params = dict(state.model.named_parameters())
    grads = _to_jax({n: params[n].grad if n in params
                     and params[n].grad is not None else torch.zeros_like(t)
                     for n, t in sd.items()})
    got = dict(jax.tree_util.tree_leaves_with_path(_to_jax(sd)))
    g_by = dict(jax.tree_util.tree_leaves_with_path(grads))
    compared = 0
    for path, w in jax.tree_util.tree_leaves_with_path(jnew.params):
        g = np.abs(g_by[path])
        sure = g > max(1e-3 * g.max(), NOISE)
        np.testing.assert_allclose(got[path][sure], np.asarray(w)[sure],
                                   atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        compared += int(sure.sum())
    # about 8% of the trainable elements: the wide, shallow backbone's
    # gradients sit mostly below 1e-3 x their leaf's max
    assert compared > 0.05 * sum(p.numel() for p in params.values()
                                 if p.requires_grad)
    assert lrs["others"] > 0


def test_converted_checkpoint_resumes_trainer_and_loads_engine(
        jax_run, converted):
    from gpv_tpu_torch.infer.build import build_engine
    from gpv_tpu_torch.train.trainer import Trainer
    from gpv_tpu_torch.utils.config import load_config
    _, payload, _ = converted
    ckpt = jax_run.out / "model"
    tr = Trainer(load_config("configs", "exp/gpv", jax_run.overrides + [
        f"training.ckpt={ckpt}"]))
    assert (tr.step, tr.last_epoch, tr.best_metric) == (2, 0, 0.25)
    for k, v in payload["model"].items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    assert {id(p) for p in tr.state.optimizer.state} == {
        id(p) for g in tr.state.optimizer.param_groups for p in g["params"]}
    eng = build_engine(load_config("configs", "exp/gpv_inference",
                                   TINY_OVERRIDES + [f"ckpt={ckpt}",
                                                     "device=cpu"]))
    images = np.random.RandomState(0).randint(
        0, 256, (2, IMG_H, IMG_W, 3)).astype(np.uint8)
    tr.engine.load_weights(tr.model)
    for a, b in zip(eng.predict(images, ["what is this?", "dog"]),
                    tr.engine.predict(images, ["what is this?", "dog"])):
        assert a["answer"] == b["answer"]
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
