"""Shared fixtures of the port's training tests (tests/test_torch_port_
train_*.py): one tiny JAX GPV with its variables, the port's GPV loaded
from them through the weight bridge, seeded numpy batches and a training
config node. Dropout 0 everywhere, so both sides compute the same
function."""
import numpy as np

import jax
import jax.numpy as jnp

from gpv_tpu.losses import TASK_IDS
from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.train.checkpoint import convert_gpv_torch
from gpv_tpu.utils.config import ConfigNode

from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.weights import state_dict_from_jax

VOCAB, D, H, W, S, M = 40, 32, 48, 64, 8, 4
BLOCKS = (1, 1, 1, 1)
DETR_CFG = dict(num_queries=10, num_classes=1, hidden_dim=D, nheads=4,
                num_encoder_layers=1, num_decoder_layers=2,
                dim_feedforward=64, backbone_layers=BLOCKS)
ARGS = dict(vocab_size=VOCAB, hidden_dim=D, max_text_len=S,
            co_att_num_layers=1, co_att_heads=4, co_att_intermediate=64,
            text_decoder_layers=1, text_decoder_heads=4, bert_layers=1,
            bert_hidden=D, bert_heads=4, bert_vocab_size=100,
            bert_max_len=16)
TASKS = ("CocoCaptioning", "CocoVqa", "CocoClassification", "CocoDetection",
         "RefCocop")


def jax_model(**detr_kw):
    return JaxGPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0,
                                             **detr_kw), **ARGS)


def port_model(**detr_kw):
    return GPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0, **detr_kw),
               **ARGS)


def jax_variables(jm, seed=0):
    """Initialised variables as numpy, frozen-BN statistics randomised."""
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                  jnp.zeros((1, 5), jnp.int32),
                                  jnp.zeros((1, S), jnp.int32)))(
        jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def stat(path, x):
        x = np.asarray(x)
        if path[-1].key in ("weight", "running_var"):
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)
    return {"params": jax.tree.map(np.asarray, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stat, v["batch_stats"])}


def load_port(pm, variables):
    pm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return pm


def to_jax_tree(sd):
    """A port state dict (or a dict of per-name arrays) -> the JAX
    {params, batch_stats} layout."""
    return convert_gpv_torch(
        {k: np.asarray(v) for k, v in sd.items()}, num_co_att=1,
        text_dec_layers=1, hidden=D, detr_layers=BLOCKS, detr_dim=D,
        detr_enc=1, detr_dec=2, bert_layers=1)


def make_batch(B=8, seed=0, tasks=TASKS, repeat_queries=False):
    """A collated-style batch: uint8 images, one task per row in turn,
    answers for the text tasks, 1-3 valid boxes for the box tasks."""
    rng = np.random.RandomState(seed)
    rows = [tasks[i % len(tasks)] for i in range(B)]
    boxed = np.asarray([t in ("CocoDetection", "RefCocop") for t in rows])
    n_boxes = rng.randint(1, M, B)
    qids = rng.randint(5, 100, (B, 5)).astype(np.int32)
    if repeat_queries:
        qids = qids[rng.randint(0, 3, B)]
    qvalid = np.ones((B, 5), bool)
    qvalid[1::3, 3:] = False
    cxcy = rng.uniform(0.25, 0.75, (B, M, 2))
    wh = rng.uniform(0.1, 0.4, (B, M, 2))
    return {
        "image": rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        "query_ids": qids,
        "query_valid": qvalid,
        "answer_ids": rng.randint(0, VOCAB, (B, S)).astype(np.int32),
        "answer_lens": rng.randint(3, S + 1, B).astype(np.int32),
        "task_id": np.asarray([TASK_IDS[t] for t in rows], np.int32),
        "has_answer": ~boxed,
        "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
        "box_labels": np.zeros((B, M), np.int32),
        "box_valid": np.arange(M)[None] < n_boxes[:, None],
        "has_boxes": boxed,
    }


def training_cfg(**kw):
    cfg = ConfigNode({
        "num_epochs": 2, "lr": 1e-3, "lr_backbone": 1e-4,
        "weight_decay": 1e-4, "lr_milestones": [1], "lr_drop": 0.5,
        "lr_warmup": True, "lr_linear_decay": True,
        "lr_warmup_fraction": 0.1, "clip_max_norm": 0.1, "freeze": False,
    })
    cfg.update(kw)
    return cfg
