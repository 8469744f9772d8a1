"""Phase 2 of the two-phase training recipe (`scripts/train.sh`) resuming
phase 1, on the CPU at tiny widths: phase 1 trains with `training.freeze`
(a selective freeze from a seeded `model.pretr_detr`, or the whole DETR),
phase 2 resumes its `ckpts/model` with the freeze off. The JAX package
cannot run this step (its orbax restore refuses the changed optimizer
tree), so the port is held to the semantics of `train.checkpoint.load_into`
rather than to a JAX result.
"""
import sys
from pathlib import Path

import pytest
import torch

from gpv_tpu_torch.train import trainer as trainer_mod
from gpv_tpu_torch.train.optimizer import make_schedule
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import init_random

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data  # noqa

STEPS = 2  # phase-1 updates before the save


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("fake"))


def _cfg(data, out, *extra):
    return load_config("configs", "exp/gpv", [
        f"data_dir={data}", f"output_dir={out}", "exp_name=two_phase",
        "learning_datasets=all",
        "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W),
    ] + TINY_OVERRIDES + [
        "device=cpu", "tb_dir=null", "training.num_workers=1",
        "training.frozen_batch_size=8", "training.query_dedup=true"]
        + list(extra))


def _steps(tr, n):
    batches = iter(tr.loaders["train"])
    for _ in range(n):
        tr.train_step(tr.state, next(batches))
        tr.step += 1
    batches.close()


def _group_names(tr):
    names = {id(p): n for n, p in tr.model.named_parameters()}
    return {names[id(p)]: g["name"] for g in tr.state.optimizer.param_groups
            for p in g["params"]}


def _adam_state(tr):
    """{parameter name: its AdamW state} of a trainer."""
    names = {id(p): n for n, p in tr.model.named_parameters()}
    return {names[id(p)]: s for p, s in tr.state.optimizer.state.items()}


def _phase1(fake_data, out, mode):
    extra = ["training.freeze=true"]
    if mode == "selective":
        # a DETR checkpoint without class_embed: that leaf keeps training
        src = init_random(trainer_mod.build_gpv(
            _cfg(fake_data, out).model, 128), seed=5).detr
        sd = {k: v for k, v in src.state_dict().items()
              if not k.startswith("class_embed")}
        torch.save({"model": sd}, out / "detr.pth")
        extra.append(f"model.pretr_detr={out / 'detr.pth'}")
    with pytest.warns(RuntimeWarning):
        tr = trainer_mod.Trainer(_cfg(fake_data, out, *extra))
    _steps(tr, STEPS)
    tr.save(0, {"model_selection_metric": 0.5})
    return tr


@pytest.fixture(scope="module", params=["selective", "whole"])
def phases(request, fake_data, tmp_path_factory):
    """(phase-1 trainer, phase-2 trainer as resumed, phase-2 config)."""
    out = tmp_path_factory.mktemp(f"phase1_{request.param}")
    one = _phase1(fake_data, out, request.param)
    cfg2 = _cfg(fake_data, tmp_path_factory.mktemp("phase2"),
                f"training.ckpt={Path(one.cfg.ckpt_dir) / 'model'}",
                "training.freeze=false", "training.num_epochs=4")
    return request.param, one, trainer_mod.Trainer(cfg2), cfg2


def test_phase2_restores_model_step_and_epoch(phases):
    _, one, two, _ = phases
    for name, t in one.model.state_dict().items():
        assert torch.equal(two.model.state_dict()[name], t), name
    assert two.step == two.state.step == STEPS
    assert two.last_epoch == 0


def test_phase2_carries_moments_by_name(phases):
    mode, one, two, _ = phases
    g1, g2 = _group_names(one), _group_names(two)
    assert set(g1) < set(g2)
    unfrozen = set(g2) - set(g1)
    assert "detr.transformer.decoder.norm.weight" in unfrozen
    # a selective freeze leaves the leaf the checkpoint lacked training
    assert ("detr.class_embed.weight" in g1) == (mode == "selective")
    s1, s2 = _adam_state(one), _adam_state(two)
    assert set(s1) == set(g1) and set(s2) == set(g1)
    for name, want in s1.items():
        assert sorted(s2[name]) == ["exp_avg", "exp_avg_sq", "step"]
        for key, t in want.items():
            assert torch.equal(s2[name][key], t), (name, key)


def test_phase2_lr_follows_the_schedule_at_the_restored_step(phases):
    _, _, two, cfg2 = phases
    lam = make_schedule(cfg2.training, len(two.loaders["train"]))
    base = {"detr_backbone": float(cfg2.training.lr_backbone)}
    for g in two.state.optimizer.param_groups:
        want = base.get(g["name"], float(cfg2.training.lr)) * lam(STEPS)
        assert g["lr"] == pytest.approx(want, rel=1e-12), g["name"]
    assert two.state.scheduler.last_epoch == STEPS


def test_phase2_step_moves_the_unfrozen_leaves(phases):
    _, one, two, cfg2 = phases
    unfrozen = set(_group_names(two)) - set(_group_names(one))
    before = {n: p.detach().clone() for n, p in two.model.named_parameters()
              if n in unfrozen}
    lam = make_schedule(cfg2.training, len(two.loaders["train"]))
    _steps(two, 1)
    state = _adam_state(two)
    moved = 0
    for name, t in before.items():
        p = two.model.get_parameter(name)
        assert int(state[name]["step"]) == 1, name
        # a leaf with a zero gradient (DETR's first decoder self-attention
        # on its all-zero target) only decays, below fp32's resolution
        if torch.count_nonzero(p.grad):
            assert not torch.equal(p.detach(), t), name
            moved += 1
    assert moved > len(before) // 2
    carried = next(iter(_group_names(one)))
    assert int(state[carried]["step"]) == STEPS + 1
    lr = float(cfg2.training.lr)
    head = next(g for g in two.state.optimizer.param_groups
                if g["name"] == "detr_head")
    assert head["lr"] == pytest.approx(lr * lam(STEPS + 1), rel=1e-12)


def test_checkpoint_without_names_raises(fake_data, tmp_path):
    """A checkpoint written without its groups' parameter names, whose
    groups differ from the resuming run's, is refused by name."""
    one = _phase1(fake_data, tmp_path, "whole")
    path = Path(one.cfg.ckpt_dir) / "model"
    payload = torch.load(path, weights_only=True)
    del payload["param_names"]
    torch.save(payload, path)
    with pytest.raises(ValueError, match="F1"):
        trainer_mod.Trainer(_cfg(fake_data, tmp_path / "p2",
                                 f"training.ckpt={path}",
                                 "training.freeze=false"))
    # the same checkpoint resumes into a run with the same groups
    again = trainer_mod.Trainer(_cfg(fake_data, tmp_path / "p1b",
                                     f"training.ckpt={path}",
                                     "training.freeze=true"))
    assert again.step == STEPS
