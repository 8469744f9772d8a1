"""The port's train step against `gpv_tpu.parallel.make_train_step` at
dropout 0, on the CPU in fp32, plus the training-mode rules of the model.

The JAX step runs twice per variant: with its own AdamW (the updated
leaves) and with SGD at lr 1 (so `old - new` is its clipped gradient).
Both sides start from the same variables through the weight bridge and
take the same numpy batch. Tolerances:
- losses: 1e-4 relative;
- clipped gradients per leaf: 1e-3 x max|g| of the leaf, plus NOISE =
  1e-5 absolute. The floor admits the leaves whose true gradient is zero
  (key biases, the classifier transform's bias: softmax is blind to
  them), which hold only rounding noise (up to 1.5e-6 seen: the bias's
  gradient is a sum of cancelling terms over the vocabulary);
- AdamW's first update: 1e-6 absolute on the elements whose gradient is
  above both 1e-3 x max|g| of the leaf and NOISE. Elsewhere the first
  Adam step turns rounding noise into +-lr and is not compared.
"""
import sys
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.datasets.loader import Collator as JaxCollator
from gpv_tpu.losses import LossConfig as JaxLossConfig
from gpv_tpu.parallel import create_train_state
from gpv_tpu.parallel import make_train_step as jax_train_step
from gpv_tpu.train import build_optimizer as jax_optimizer

from gpv_tpu_torch.losses.criterion import LossConfig
from gpv_tpu_torch.nn import coattention, layers
from gpv_tpu_torch.ops import attention as A
from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
from gpv_tpu_torch.train.optimizer import build_optimizer

sys.path.insert(0, str(Path(__file__).parent))
from _torch_train_common import (ARGS, DETR_CFG, jax_model,  # noqa: E402
                                 jax_variables, load_port, make_batch,
                                 port_model, to_jax_tree, training_cfg)

LR = 1e-3
NOISE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pair():
    jm = jax_model()
    return jm, jax_variables(jm)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(jm, v, batch, tx, **kw):
    step = jax_train_step(jm, tx, JaxLossConfig(), 0.1, donate=False, **kw)
    state, losses = step(create_train_state(v, tx),
                         jax.tree.map(jnp.asarray, batch),
                         jax.random.PRNGKey(0))
    return state.params, {k: float(x) for k, x in losses.items()}


def _port_step(v, batch, cfg=None, **kw):
    pm = load_port(port_model(), v)
    cfg = cfg or training_cfg()
    paths = kw.get("frozen_detr_paths")
    opt, sched = build_optimizer(cfg, 10, pm, paths)
    step = make_train_step(pm, LossConfig(), 0.1, **kw)
    losses = step(TrainState(pm, opt, sched), batch)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pm.named_parameters()}
    buffers = dict(pm.named_buffers())
    sd = {n: t for n, t in pm.state_dict().items()}
    return (pm, {k: float(x) for k, x in losses.items()},
            _flat(to_jax_tree({**sd, **grads})["params"]),
            _flat(to_jax_tree(sd)["params"]), buffers)


def _close_losses(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _close_grads(got, want):
    for k, w in want.items():
        tol = 1e-3 * np.abs(w).max() + NOISE
        err = np.abs(got[k] - w).max()
        assert err <= tol, f"{k}: grad err {err} > {tol}"


VARIANTS = {
    "base": (dict(), dict(), dict()),
    "grad_accum2": (dict(), dict(grad_accum=2), dict(grad_accum=2)),
    "dedup": (dict(repeat_queries=True), dict(), dict()),
    "freeze_detr": (dict(), dict(freeze_detr=True), dict(freeze_detr=True)),
}


def _batch(name):
    batch = make_batch(8, **VARIANTS[name][0])
    if name == "dedup":
        batch.update(JaxCollator.dedup_emission(batch["query_ids"],
                                                batch["query_valid"], 4))
        assert len(batch["query_uniq_ids"]) < 8
    return batch


def _freeze_paths(name, v, pm):
    """freeze_detr: every detr leaf but class_embed (a checkpoint that
    left it out), for JAX as '/'-paths and for the port as names."""
    if name != "freeze_detr":
        return {}, {}
    jax_paths = {"/".join(k.key for k in p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(v["params"]["detr"])
                 if p[0].key != "class_embed"}
    port_paths = {n for n, _ in pm.named_parameters()
                  if n.startswith("detr.")
                  and not n.startswith("detr.class_embed")}
    return ({"frozen_detr_paths": jax_paths},
            {"frozen_detr_paths": port_paths})


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_step_losses_and_grads_match_jax(jax_pair, name):
    jm, v = jax_pair
    batch = _batch(name)
    jkw, pkw = (dict(VARIANTS[name][1]), dict(VARIANTS[name][2]))
    jp, pp = _freeze_paths(name, v, port_model())
    jkw.update(jp)
    pkw.update(pp)
    new, jlosses = _jax_step(jm, v, batch, optax.sgd(1.0), **jkw)
    old = _flat(v["params"])
    jgrads = {k: old[k] - x for k, x in _flat(new).items()}
    pm, plosses, pgrads, _, _ = _port_step(v, batch, **pkw)
    _close_losses(plosses, jlosses)
    _close_grads(pgrads, jgrads)
    if name == "freeze_detr":
        frozen = {n for n, p in pm.named_parameters() if not p.requires_grad}
        assert "detr.class_embed.weight" not in frozen
        assert "detr.transformer.decoder.norm.weight" in frozen
        assert "detr_joiner.weight" not in frozen


def test_train_step_adamw_update_matches_jax(jax_pair):
    jm, v = jax_pair
    batch = _batch("base")
    cfg = training_cfg(lr=LR)
    new, jlosses = _jax_step(jm, v, batch,
                             jax_optimizer(cfg, 10, v["params"]))
    sgd_new, _ = _jax_step(jm, v, batch, optax.sgd(1.0))
    old = _flat(v["params"])
    jgrads = {k: old[k] - x for k, x in _flat(sgd_new).items()}
    pm, plosses, _, pnew, buffers = _port_step(v, batch, cfg)
    _close_losses(plosses, jlosses)
    moved = 0
    for k, w in _flat(new).items():
        g = jgrads[k]
        sure = np.abs(g) > max(1e-3 * np.abs(g).max(), NOISE)
        np.testing.assert_allclose(pnew[k][sure], w[sure], atol=1e-6,
                                   rtol=0, err_msg=k)
        moved += bool(np.any(w != old[k]))
        if not np.any(w != old[k]):  # frozen in JAX: bit-unchanged here
            np.testing.assert_array_equal(pnew[k], old[k], err_msg=k)
    assert moved > 0
    for n, b in buffers.items():  # the frozen-BN statistics never move
        assert torch.equal(b, load_port(port_model(), v).get_buffer(n)), n


def test_same_seed_and_step_give_the_same_loss():
    """With dropout on, a step is a function of (weights, batch, seed,
    step): two fresh states agree, another step count differs."""
    v_model = port_model()
    torch.manual_seed(0)
    for p in v_model.parameters():
        p.data.normal_(0, 0.05)
    sd = v_model.state_dict()
    batch = make_batch(4)

    def run(step_count):
        pm = GPVWithDropout()
        pm.load_state_dict(sd)
        opt, sched = build_optimizer(training_cfg(), 10, pm)
        step = make_train_step(pm, LossConfig(), 0.1)
        return float(step(TrainState(pm, opt, sched, step=step_count),
                          batch)["total_loss"])

    assert run(0) == run(0)
    assert run(0) != run(1)


def GPVWithDropout():
    from gpv_tpu_torch.models.gpv import GPV
    return GPV(dropout=0.3, detr_cfg=dict(DETR_CFG, dropout=0.3), **ARGS)


def test_dropout_acts_only_in_training():
    pm = GPVWithDropout()
    b = make_batch(2)
    img = torch.from_numpy(b["image"]).float() / 255.0
    ids = torch.from_numpy(b["query_ids"]).long()
    aids = torch.from_numpy(b["answer_ids"]).long()
    valid = torch.from_numpy(b["query_valid"])

    def run(train, seed):
        with torch.no_grad(), layers.dropout_generator(
                torch.Generator().manual_seed(seed)):
            return pm(img, ids, aids, query_valid=valid,
                      train=train)["answer_logits"]

    torch.testing.assert_close(run(False, 0), run(False, 1), rtol=0, atol=0)
    torch.testing.assert_close(run(True, 0), run(True, 0), rtol=0, atol=0)
    assert not torch.allclose(run(True, 0), run(True, 1))
    assert not torch.allclose(run(True, 0), run(False, 0))
    x = torch.ones(1000)
    assert torch.equal(layers.dropout(x, 0.5, deterministic=True), x)
    kept = layers.dropout(x, 0.5, deterministic=False)
    assert set(kept.unique().tolist()) == {0.0, 2.0}


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("train,query_enc", [(False, False), (True, False),
                                             (True, True)])
def test_route(monkeypatch, train, query_enc):
    """Training never reaches a kernel wrapper outside BERT; eval sends
    every attention through one."""
    k1 = _Counting(A.fused_attention)
    k2 = _Counting(A.fused_biattention)
    monkeypatch.setattr(layers, "fused_attention", k1)
    monkeypatch.setattr(coattention, "fused_biattention", k2)
    pm = port_model()
    b = make_batch(2)
    img = torch.from_numpy(b["image"]).float() / 255.0
    ids = torch.from_numpy(b["query_ids"]).long()
    valid = torch.from_numpy(b["query_valid"])
    enc = pm.encode_queries(ids, valid) if query_enc else None
    k1.calls = 0
    with torch.no_grad():
        pm(img, ids, torch.from_numpy(b["answer_ids"]).long(),
           query_valid=valid, train=train, query_enc=enc)
    bert = 0 if query_enc else ARGS["bert_layers"]
    if train:
        assert (k1.calls, k2.calls) == (bert, 0)
    else:
        assert k1.calls == (DETR_CFG["num_encoder_layers"]
                            + 2 * DETR_CFG["num_decoder_layers"] + bert
                            + 2 * ARGS["text_decoder_layers"])
        assert k2.calls == ARGS["co_att_num_layers"]


def test_forward_only_guard_unchanged():
    """A CUDA call with an input that needs a gradient is refused before
    any launch (checked without a card: the guard runs first)."""
    t = torch.zeros(1, 2, 1, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        A._check("fused_attention", torch.device("cuda"), torch.float32,
                 {"q": t}, {"q": (1, 2, 1, 8)}, {})


def test_aux_outputs_only_when_configured():
    from gpv_tpu_torch.models.detr import DETR
    detr = DETR(roi_head=False, aux_loss=True, last_layer_only=False,
                **dict(DETR_CFG, dropout=0.0))
    img = torch.from_numpy(make_batch(2)["image"]).float() / 255.0
    with torch.no_grad():
        out = detr(img, train=True)
        assert out["aux_pred_boxes"].shape == (
            DETR_CFG["num_decoder_layers"] - 1, 2, 10, 4)
        assert out["aux_pred_relevance_logits"].shape == (
            DETR_CFG["num_decoder_layers"] - 1, 2, 10, 2)
        assert "aux_pred_boxes" not in detr(img, train=False)
