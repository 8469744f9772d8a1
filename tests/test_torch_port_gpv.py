"""Slice parity of the PyTorch port against `gpv_tpu`: the whole GPV, the
greedy decode and the engine, at tiny widths on the CPU in fp32.

One tiny JAX GPV is initialised (frozen-BN statistics randomised so the
serving fold does real work), its variables go through
`gpv_tpu_torch.weights.state_dict_from_jax` into the port's GPV, and both
run on the same numpy inputs. Tolerances are those of
tests/test_full_gpv_parity.py: boxes 2e-4, relevance 5e-4, answer logits
2e-3; greedy tokens and answer strings must match exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.decode import greedy_decode as jax_greedy
from gpv_tpu.engine import GPVEngine as JaxEngine
from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.text.vocab import AnswerVocab as JaxVocab
from gpv_tpu.text.wordpiece import WordPieceTokenizer as JaxTok
from gpv_tpu.train.checkpoint import convert_gpv_torch

from gpv_tpu_torch.decode.greedy import greedy_decode
from gpv_tpu_torch.engine import GPVEngine
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once: keep torch to one thread
    here, and give the next test file its setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

VOCAB, D, B, H, W = 40, 32, 2, 48, 64
BLOCKS = (1, 1, 1, 1)
DETR_CFG = dict(num_queries=10, num_classes=1, hidden_dim=D, nheads=4,
                num_encoder_layers=2, num_decoder_layers=2,
                dim_feedforward=64, backbone_layers=BLOCKS)
ARGS = dict(vocab_size=VOCAB, hidden_dim=D, max_text_len=8,
            co_att_num_layers=2, co_att_heads=4, co_att_intermediate=64,
            text_decoder_layers=2, text_decoder_heads=4, bert_layers=2,
            bert_hidden=D, bert_heads=4, bert_vocab_size=100,
            bert_max_len=16)
QUERIES = ["what is the man riding?", "dog"]


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0), **ARGS)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, H, W, 3)),
                                  jnp.zeros((1, 5), jnp.int32),
                                  jnp.zeros((1, 8), jnp.int32)))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def stat(path, x):
        x = np.asarray(x)
        if path[-1].key in ("weight", "running_var"):
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(
             stat, v["batch_stats"])}
    pm = GPV(detr_cfg=DETR_CFG, **ARGS)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    images = rng.randint(0, 255, (B, H, W, 3)).astype(np.uint8)
    ids, valid = WordPieceTokenizer.debug().batch_encode(QUERIES, 8)
    norm = (images / 255.0 - np.array([0.485, 0.456, 0.406])) \
        / np.array([0.229, 0.224, 0.225])
    return images, norm.astype(np.float32), ids, valid


def _jax_encode(jm, v, norm, ids, valid):
    fn = jax.jit(lambda v, *a: jm.apply(v, *a[:2], query_valid=a[2],
                                        method=JaxGPV.encode))
    return fn(v, norm, ids, valid)


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def test_bridge_round_trip(pair):
    jm, v, pm = pair
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    back = convert_gpv_torch(sd, num_co_att=2, text_dec_layers=2, hidden=D,
                             detr_layers=BLOCKS, detr_dim=D, detr_enc=2,
                             detr_dec=2, bert_layers=2)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    GPV(detr_cfg=DETR_CFG, **ARGS).load_state_dict(
        {k: torch.from_numpy(a) for k, a in sd.items()}, strict=True)


@pytest.mark.parametrize("mask_query_pads", [True, False])
def test_encode(pair, inputs, mask_query_pads):
    jm, v, pm = pair
    _, norm, ids, valid = inputs
    jm = jm.clone(mask_query_pads=mask_query_pads)
    pm.mask_query_pads = mask_query_pads
    memory, mem_valid, out = _jax_encode(jm, v, norm, ids, valid)
    with torch.no_grad():
        g_mem, g_valid, g_out = pm.encode(
            torch.from_numpy(norm), torch.from_numpy(ids).long(),
            query_valid=torch.from_numpy(valid))
    pm.mask_query_pads = True
    close(g_out["pred_boxes"], out["pred_boxes"], 2e-4)
    close(g_out["pred_relevance_logits"], out["pred_relevance_logits"], 5e-4)
    close(g_mem, memory, 5e-4)
    if mask_query_pads:
        np.testing.assert_array_equal(g_valid.numpy(), np.asarray(mem_valid))
    else:
        assert g_valid is None and mem_valid is None


@pytest.mark.parametrize("text_pos_enc", [False, True])
def test_teacher_forced_answer_logits(pair, inputs, text_pos_enc):
    jm, v, pm = pair
    _, norm, ids, valid = inputs
    jm = jm.clone(text_pos_enc=text_pos_enc)
    aids = np.random.RandomState(2).randint(0, VOCAB, (B, 8)).astype(np.int32)
    out = jax.jit(lambda n, i, a, q: jm.apply(v, n, i, a, query_valid=q))(
        norm, ids, aids, valid)
    pm.text_pos_enc = text_pos_enc
    with torch.no_grad():
        got = pm(torch.from_numpy(norm), torch.from_numpy(ids).long(),
                 torch.from_numpy(aids).long(),
                 query_valid=torch.from_numpy(valid))
    pm.text_pos_enc = False
    close(got["answer_logits"], out["answer_logits"], 2e-3)


@pytest.mark.parametrize("stop", [False, True])
def test_greedy_decode(pair, inputs, stop):
    jm, v, pm = pair
    _, norm, ids, valid = inputs
    vocab = AnswerVocab.debug(size=VOCAB)
    stop_id = vocab.stop_id if stop else None
    memory, mem_valid, _ = _jax_encode(jm, v, norm, ids, valid)
    r_tok, r_logits = jax_greedy(jm, v, memory, mem_valid, vocab.cls_id,
                                 stop_id=stop_id)
    got_tok, got_logits, steps = greedy_decode(
        pm, torch.from_numpy(np.array(memory)),
        torch.from_numpy(np.array(mem_valid)), vocab.cls_id,
        stop_id=stop_id)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(r_tok))
    close(got_logits, r_logits, 2e-3)
    assert 1 <= steps <= ARGS["max_text_len"] - 1


@pytest.fixture(scope="module")
def engines(pair):
    jm, v, pm = pair
    jax_eng = JaxEngine(jm, v, JaxVocab.debug(size=VOCAB), JaxTok.debug(),
                        max_query_len=8)
    port_eng = GPVEngine(pm, AnswerVocab.debug(size=VOCAB),
                         WordPieceTokenizer.debug(), max_query_len=8,
                         device="cpu", dtype=torch.float32)
    return jax_eng, port_eng


def _same_predictions(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["answer"] == r["answer"]
        close(g["boxes"], r["boxes"], 2e-4)
        close(g["relevance"], r["relevance"], 5e-4)
        assert np.all(np.diff(g["relevance"]) <= 0)


def test_engine_predict(engines, inputs):
    images = inputs[0]
    _same_predictions(engines[1].predict(images, QUERIES),
                      engines[0].predict(images, QUERIES))


def test_engine_predict_native(engines, inputs):
    images = [inputs[0][0], inputs[0][1][:40, :50]]
    _same_predictions(engines[1].predict_native(images, QUERIES),
                      engines[0].predict_native(images, QUERIES))
