"""`tpu.remat` in the port: `nn.layers.remat` around the backbone's
stages, DETR's encoder and decoder layers and each co-attention layer
(`torch.utils.checkpoint`, non-reentrant), against the model without it
and against the JAX package's `nn.remat` step.

Dropout under recomputation is the trouble spot: the port's dropout draws
from an explicit generator that `checkpoint` neither saves nor restores,
and the backward's recompute runs where no generator is installed. So
remat's gradients are held against no-remat's with dropout ON, and a
plain `checkpoint` is shown to fail that check.
"""
import sys
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils.checkpoint import checkpoint

from gpv_tpu.losses import LossConfig as JaxLossConfig
from gpv_tpu.parallel import create_train_state
from gpv_tpu.parallel import make_train_step as jax_train_step

from gpv_tpu_torch.losses.criterion import LossConfig, gpv_criterion
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.nn import layers
from gpv_tpu_torch.ops.image import normalize_image
from gpv_tpu_torch.parallel.train_step import (TrainState, batch_to_device,
                                               make_train_step)
from gpv_tpu_torch.train.optimizer import build_optimizer, frozen_names
from gpv_tpu_torch.weights import init_random

sys.path.insert(0, str(Path(__file__).parent))
from _torch_train_common import (ARGS, DETR_CFG, jax_model,  # noqa: E402
                                 jax_variables, load_port, make_batch,
                                 to_jax_tree, training_cfg)

NOISE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(remat, rate=0.1):
    pm = init_random(GPV(dropout=rate, detr_cfg=dict(DETR_CFG, dropout=rate),
                         remat=remat, **ARGS), 0)
    frozen = frozen_names(pm)
    for n, p in pm.named_parameters():
        p.requires_grad_(n not in frozen)
    return pm


def _loss_and_grads(pm, batch, seed=5, pack=None):
    b = batch_to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(seed)
    hooks = (torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)
             if pack else torch.autograd.graph.saved_tensors_hooks(
                 lambda t: t, lambda t: t))
    with layers.dropout_generator(gen), hooks:
        out = pm(normalize_image(b["image"].float() / 255.0), b["query_ids"],
                 b["answer_ids"], query_valid=b["query_valid"], train=True)
        total, _ = gpv_criterion(out, b, LossConfig())
    total.backward()
    grads = {n: p.grad.clone() for n, p in pm.named_parameters()
             if p.grad is not None}
    return float(total.detach()), grads


def _assert_grads_equal(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = rtol * w.abs().max().item() + 1e-7
        assert (got[k] - w).abs().max().item() <= tol, k


def test_remat_equals_no_remat_with_dropout_on():
    batch = make_batch(8, seed=2)
    loss0, grads0 = _loss_and_grads(_model(False), batch)
    loss1, grads1 = _loss_and_grads(_model(True), batch)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    _assert_grads_equal(grads1, grads0)
    # every checkpointed module took a gradient
    assert any(k.startswith("co_att_transformer.") for k in grads1)
    assert any(k.startswith("detr.transformer.encoder.") for k in grads1)
    assert any(k.startswith("detr.backbone.0.body.layer4.") for k in grads1)


def test_plain_checkpoint_would_redraw_the_masks(monkeypatch):
    """Without restoring the dropout generator the recompute draws other
    masks, and the gradients are silently wrong: the check above has
    teeth."""
    batch = make_batch(8, seed=2)
    _, grads0 = _loss_and_grads(_model(False), batch)
    monkeypatch.setattr(layers, "remat", lambda fn, *a, **k: checkpoint(
        fn, *a, use_reentrant=False, **k))
    from gpv_tpu_torch.models import gpv as gpv_mod
    from gpv_tpu_torch.nn import detr_transformer, resnet
    for mod, name in ((gpv_mod, "remat_region"), (detr_transformer, "remat"),
                      (resnet, "remat")):
        monkeypatch.setattr(mod, name, layers.remat)
    _, grads1 = _loss_and_grads(_model(True), batch)
    with pytest.raises(AssertionError):
        _assert_grads_equal(grads1, grads0)


def test_remat_saves_fewer_tensor_bytes():
    """Bytes the forward saves for the backward outside checkpointed
    regions (the regions keep only their inputs), counted with
    saved_tensors_hooks."""
    batch = make_batch(8, seed=2)
    counts = {}
    for remat in (False, True):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        _loss_and_grads(_model(remat, rate=0.0), batch, pack=pack)
        counts[remat] = total[0]
    assert counts[True] < 0.6 * counts[False], counts


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_remat_step_matches_the_jax_remat_step():
    """The port's step with remat against `gpv_tpu`'s step over
    `build_gpv(..., remat=True)` at dropout 0: losses 1e-4 relative,
    clipped gradients 1e-3 x the leaf's max (tests/
    test_torch_port_train_step.py's tolerances)."""
    jm = jax_model().clone(remat=True)
    v = jax_variables(jm)
    batch = make_batch(8, seed=4)
    step = jax_train_step(jm, optax.sgd(1.0), JaxLossConfig(), 0.1,
                          donate=False)
    state, jl = step(create_train_state(v, optax.sgd(1.0)),
                     jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    old = _flat(v["params"])
    jgrads = {k: old[k] - x for k, x in _flat(state.params).items()}

    pm = load_port(GPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0),
                       remat=True, **ARGS), v)
    opt, sched = build_optimizer(training_cfg(), 10, pm)
    losses = make_train_step(pm, LossConfig(), 0.1)(
        TrainState(pm, opt, sched), batch)
    for k, want in jl.items():
        np.testing.assert_allclose(float(losses[k]), float(want), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in pm.named_parameters()}
    pgrads = _flat(to_jax_tree({**pm.state_dict(), **grads})["params"])
    for k, w in jgrads.items():
        tol = 1e-3 * np.abs(w).max() + NOISE
        assert np.abs(pgrads[k] - w).max() <= tol, k
