"""The port's training building blocks against `gpv_tpu` on the CPU, fp32:
box ops, the DETR matching cost and assignment, the multitask criterion,
the collator and the loader, the optimizer's parameter groups and the lr
schedules.

Tolerances: box ops and costs 1e-6 absolute (the same fp32 arithmetic);
criterion terms 1e-5 relative; assignments, collated arrays and loader
order exactly equal. The matcher tests use continuous random costs, so
scipy and the JAX solver meet the same unique optimum.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.datasets.loader import Collator as JaxCollator
from gpv_tpu.datasets.loader import DataLoader as JaxDataLoader
from gpv_tpu.losses import criterion as JC
from gpv_tpu.ops import boxes as JB
from gpv_tpu.ops import matcher as JM
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.train import optimizer as JO

from gpv_tpu_torch.datasets.loader import Collator, DataLoader
from gpv_tpu_torch.losses import criterion as PC
from gpv_tpu_torch.ops import boxes as PB
from gpv_tpu_torch.ops import matcher as PM
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.train import optimizer as PO
from gpv_tpu_torch.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from _torch_train_common import (TASKS, jax_model, jax_variables,  # noqa
                                 make_batch, port_model, training_cfg)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(rng, n):
    cxcy = rng.uniform(0.2, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.5, (n, 2))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


# ---------------------------------------------------------------- boxes

@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                "box_area"])
def test_box_unary_ops(fn):
    b = _boxes(np.random.RandomState(0), 12).reshape(3, 4, 4)
    np.testing.assert_allclose(getattr(PB, fn)(_t(b)).numpy(),
                               np.asarray(getattr(JB, fn)(b)), atol=1e-6)


@pytest.mark.parametrize("fn", ["box_iou", "generalized_box_iou",
                                "elementwise_generalized_box_iou"])
def test_box_pair_ops(fn):
    rng = np.random.RandomState(1)
    n = 7
    a = np.array(JB.box_cxcywh_to_xyxy(_boxes(rng, n)))
    b = np.asarray(JB.box_cxcywh_to_xyxy(_boxes(rng, n if "element" in fn
                                                 else 5)))
    a[0, 2:] = a[0, :2]  # one degenerate box
    got, want = getattr(PB, fn)(_t(a), _t(b)), getattr(JB, fn)(a, b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_masks_to_boxes():
    m = np.zeros((3, 9, 11), bool)
    m[0, 2:5, 3:8] = True
    m[1, 7, 0] = True  # m[2] empty
    np.testing.assert_array_equal(PB.masks_to_boxes(_t(m)).numpy(),
                                  np.asarray(JB.masks_to_boxes(m)))


# ---------------------------------------------------------------- matcher

def _match_inputs(seed, B=3, Q=10, M=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Q, 2).astype(np.float32)
    pred = _boxes(rng, B * Q).reshape(B, Q, 4)
    tgt = _boxes(rng, B * M).reshape(B, M, 4)
    labels = np.zeros((B, M), np.int32)
    valid = np.arange(M)[None] < np.array([[4], [2], [1]])[:B]
    return logits, pred, labels, tgt, valid


def test_detr_cost_matrix_matches_jax():
    logits, pred, labels, tgt, _ = _match_inputs(0)
    got = PM.detr_cost_matrix(_t(logits), _t(pred), _t(labels), _t(tgt))
    for b in range(len(logits)):
        want = JM.detr_cost_matrix(logits[b], pred[b], labels[b], tgt[b])
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hungarian_match_matches_jax(seed):
    logits, pred, labels, tgt, valid = _match_inputs(seed)
    got = PM.hungarian_match(_t(logits), _t(pred), _t(labels), _t(tgt),
                             _t(valid)).numpy()
    want = np.asarray(JM.hungarian_match(logits, pred, labels, tgt, valid))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(np.where(valid, got, -1),
                                  np.where(valid, want, -1))


def test_padded_rows_leave_the_assignment_unchanged():
    logits, pred, labels, tgt, valid = _match_inputs(3)
    base = PM.hungarian_match(_t(logits), _t(pred), _t(labels), _t(tgt),
                              _t(valid)).numpy()
    # more padding rows, holding other boxes: the real rows keep theirs
    pad_tgt = np.concatenate([tgt, _boxes(np.random.RandomState(9), 3 * 3)
                              .reshape(3, 3, 4)], 1)
    pad_valid = np.concatenate([valid, np.zeros((3, 3), bool)], 1)
    got = PM.hungarian_match(_t(logits), _t(pred),
                             _t(np.zeros((3, 7), np.int32)), _t(pad_tgt),
                             _t(pad_valid)).numpy()[:, :4]
    np.testing.assert_array_equal(np.where(valid, got, -1),
                                  np.where(valid, base, -1))


def test_more_targets_than_queries_is_refused():
    with pytest.raises(ValueError, match="target rows"):
        PM.solve_costs(np.zeros((1, 5, 3), np.float32))


# ---------------------------------------------------------------- criterion

def _outputs(rng, B, Q=10, L=0, V=40, S=8):
    out = {"pred_relevance_logits": rng.randn(B, Q, 2).astype(np.float32),
           "pred_boxes": _boxes(rng, B * Q).reshape(B, Q, 4),
           "answer_logits": rng.randn(B, S - 1, V).astype(np.float32)}
    if L:
        out["aux_pred_relevance_logits"] = rng.randn(L, B, Q, 2).astype(
            np.float32)
        out["aux_pred_boxes"] = _boxes(rng, L * B * Q).reshape(L, B, Q, 4)
    return out


@pytest.mark.parametrize("tasks,aux", [
    (TASKS, 0), (TASKS, 2), (("CocoCaptioning", "CocoVqa"), 0),
    (("CocoDetection", "RefCocop"), 1), (("CocoClassification",), 0)])
def test_gpv_criterion_matches_jax(tasks, aux):
    rng = np.random.RandomState(len(tasks) + aux)
    batch = make_batch(8, seed=aux, tasks=tasks)
    outputs = _outputs(rng, 8, L=aux)
    jtotal, jlosses = JC.gpv_criterion(
        jax.tree.map(jnp.asarray, outputs),
        jax.tree.map(jnp.asarray, batch), JC.LossConfig())
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v)
          for k, v in batch.items()}
    ptotal, plosses = PC.gpv_criterion(
        {k: _t(v) for k, v in outputs.items()}, tb, PC.LossConfig())
    assert set(plosses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(plosses[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(ptotal), float(jtotal), rtol=1e-5)


def test_loss_config_from_config():
    from gpv_tpu.utils.config import load_config as jax_load
    from gpv_tpu_torch.utils.config import load_config
    want = JC.LossConfig.from_config(jax_load("configs", "exp/gpv").losses)
    got = PC.LossConfig.from_config(load_config("configs", "exp/gpv").losses)
    assert tuple(got) == tuple(want)
    assert PC.TASK_IDS == JC.TASK_IDS


# ---------------------------------------------------------------- collator

def _items(n, rng, H=8, W=10):
    queries = ["what is this?", "locate the dog", "describe the image"]
    items = []
    for i in range(n):
        task = TASKS[i % len(TASKS)]
        it = {"query": queries[i % 3], "task": task,
              "image": rng.randint(0, 256, (H, W, 3)).astype(np.uint8)}
        if task in ("CocoDetection", "RefCocop"):
            it["boxes"] = _boxes(rng, 1 + i % 3)
        else:
            it["answer"] = ["a man riding a horse", "two", "dog"][i % 3]
        items.append(it)
    return items


@pytest.mark.parametrize("dedup", [False, True])
def test_collator_matches_jax(dedup):
    items = _items(11, np.random.RandomState(0))
    want = JaxCollator(JaxVocab.debug(), JaxTok.debug(), max_text_len=8,
                       max_target_boxes=4, dedup_queries=dedup,
                       dedup_bucket=4)(items)
    got = Collator(AnswerVocab.debug(), WordPieceTokenizer.debug(),
                   max_text_len=8, max_target_boxes=4, dedup_queries=dedup,
                   dedup_bucket=4)(items)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ("query_uniq_ids" in got) == dedup


@pytest.mark.parametrize("B,bucket", [(8, 4), (30, 16), (5, 16)])
def test_dedup_emission_matches_jax(B, bucket):
    rng = np.random.RandomState(B)
    ids = rng.randint(0, 5, (B, 6)).astype(np.int32)[rng.randint(0, 7, B)]
    valid = ids > 0
    want = JaxCollator.dedup_emission(ids, valid, bucket)
    got = Collator.dedup_emission(ids, valid, bucket)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["query_uniq_ids"][got["query_gather"]],
                                  ids)


# ---------------------------------------------------------------- loader

class _Items:
    """A dataset whose items carry their index and the first draw of the
    rng they were given, so order and seeding both show."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng):
        return {"query": f"q{i % 4}", "task": TASKS[i % 4],
                "answer": "two",
                "image": np.full((4, 4, 3), i % 256, np.uint8)
                + rng.randint(0, 8, (4, 4, 3)).astype(np.uint8)}


def _loader_batches(cls, collator, workers, epoch, **kw):
    dl = cls(_Items(23), collator, num_workers=workers, seed=5, **kw)
    dl.set_epoch(epoch)
    return list(dl)


@pytest.mark.parametrize("epoch,workers,shard", [
    (0, 1, (1, 0)), (1, 3, (1, 0)), (2, 2, (2, 1)), (0, 2, (2, 0))])
def test_loader_order_matches_jax(epoch, workers, shard):
    kw = dict(batch_size=6, num_shards=shard[0], shard_id=shard[1])
    want = _loader_batches(JaxDataLoader, JaxCollator(
        JaxVocab.debug(), JaxTok.debug(), max_text_len=8), 2, epoch, **kw)
    got = _loader_batches(DataLoader, Collator(
        AnswerVocab.debug(), WordPieceTokenizer.debug(), max_text_len=8),
        workers, epoch, **kw)
    assert len(got) == len(want) == 23 // 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_partial_last_batch_and_shard_checks():
    dl = DataLoader(_Items(23), lambda items: {"n": np.array(len(items))},
                    batch_size=6, drop_last=False, num_workers=1)
    assert [int(b["n"]) for b in dl] == [6, 6, 6, 5]
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(_Items(4), None, batch_size=5, num_shards=2)
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(_Items(4), None, batch_size=4, num_shards=2,
                   drop_last=False)


# ---------------------------------------------------------------- optimizer

def _labels_through_bridge(jax_label_of, variables):
    """Port name -> the JAX label of the leaves it comes from: each JAX
    leaf is filled with its label's index, then taken across the bridge
    (packed q/k/v of one module share a label)."""
    names = ("detr_backbone", "detr_head", "detr_joiner", "others", "frozen")
    filled = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(np.shape(x), names.index(jax_label_of(
            tuple(k.key for k in p))), np.float32), variables["params"])
    stats = jax.tree.map(np.zeros_like, variables["batch_stats"])
    sd = state_dict_from_jax({"params": filled, "batch_stats": stats})
    out = {}
    for name, t in sd.items():
        vals = torch.unique(t)
        assert len(vals) == 1, name
        out[name] = names[int(vals[0])]
    return out


@pytest.fixture(scope="module")
def pair():
    jm = jax_model(position_embedding="learned")
    v = jax_variables(jm)
    return jm, v, port_model(position_embedding="learned")


def test_param_group_labels_match_jax_for_every_leaf(pair):
    _, v, pm = pair
    want = _labels_through_bridge(JO.param_group, v)
    params = dict(pm.named_parameters())
    assert set(params) <= set(want)
    got = PO.group_labels(pm)
    assert got == {n: want[n] for n in params}
    assert {"detr_backbone", "detr_head", "detr_joiner", "others",
            "frozen"} == set(got.values())


@pytest.mark.parametrize("freeze,paths", [(False, None), (True, None),
                                          (True, "no_class_embed")])
def test_frozen_set_matches_jax_labels(pair, freeze, paths):
    _, v, pm = pair
    jax_paths = port_paths = None
    if paths:
        flat = jax.tree_util.tree_leaves_with_path(v["params"]["detr"])
        jax_paths = {"/".join(k.key for k in p) for p, _ in flat
                     if p[0].key != "class_embed"}
        port_paths = {n for n, _ in pm.named_parameters()
                      if n.startswith("detr.")
                      and not n.startswith("detr.class_embed")}
    cfg = training_cfg(freeze=freeze)
    tx = JO.build_optimizer(cfg, 10, v["params"], jax_paths)
    # the JAX optimizer's own verdict: a leaf is frozen iff its update is 0
    grads = jax.tree.map(lambda x: np.ones_like(x), v["params"])
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    zero = jax.tree.map(lambda u: bool(np.all(np.asarray(u) == 0)), upd)
    frozen_of = {tuple(k.key for k in p): z
                 for p, z in jax.tree_util.tree_leaves_with_path(zero)}
    want = _labels_through_bridge(
        lambda path: "frozen" if frozen_of[path] else "others", v)
    got = PO.frozen_names(pm, freeze, port_paths)
    assert got == {n for n, _ in pm.named_parameters()
                   if want[n] == "frozen"}
    opt, _ = PO.build_optimizer(cfg, 10, pm, port_paths)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert in_opt == {id(p) for n, p in pm.named_parameters()
                      if n not in got}


@pytest.mark.parametrize("warmup", [True, False])
def test_schedules_match_jax(warmup):
    cfg = training_cfg(lr_warmup=warmup, lr_milestones=[1, 2], num_epochs=3)
    spe = 10
    if warmup:
        jsched = JO.warmup_linear_schedule(1.0, 30, 0.1)
    else:
        jsched = JO.multistep_schedule(1.0, [1, 2], 0.5, spe)
    psched = PO.make_schedule(cfg, spe)
    for step in (0, 1, 2, 4, 9, 10, 11, 19, 20, 25, 29, 30, 40):
        np.testing.assert_allclose(psched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_optimizer_lr_follows_the_schedule(pair):
    pm = pair[2]
    cfg = training_cfg()
    opt, sched = PO.build_optimizer(cfg, 5, pm)
    want = JO.warmup_linear_schedule(1.0, 10, 0.1)
    for step in range(4):
        for g in opt.param_groups:
            base = 1e-4 if g["name"] == "detr_backbone" else 1e-3
            np.testing.assert_allclose(g["lr"], base * float(want(step)),
                                       rtol=1e-6)
        opt.step()
        sched.step()


def test_clip_detr_grads_clips_only_detr():
    pm = port_model()
    for n, p in pm.named_parameters():
        p.grad = torch.ones_like(p)
    detr = [p for n, p in pm.named_parameters()
            if PO.param_group(n) in PO.DETR_GROUPS]
    norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in detr)))
    got = PO.clip_detr_grads(pm, 0.1)
    np.testing.assert_allclose(float(got), norm, rtol=1e-5)
    for n, p in pm.named_parameters():
        want = 0.1 / (norm + 1e-6) if PO.param_group(n) in PO.DETR_GROUPS \
            else 1.0
        np.testing.assert_allclose(p.grad.flatten()[0].item(), want,
                                   rtol=1e-5, err_msg=n)
