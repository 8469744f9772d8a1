"""Beam search of the PyTorch port against `gpv_tpu`: the beam-grouped
decode step, `beam_decode` and `GPVEngine.predict_beam`, at tiny widths on
the CPU in fp32 (the kernels' plain versions).

The tiny JAX GPV and its bridged port copy are the fixtures of
tests/test_torch_port_gpv.py. Sequences and answer strings must match
exactly; log-probs and probabilities 2e-3, boxes 2e-4, relevance 5e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.decode import beam_decode as jax_beam
from gpv_tpu.models.gpv import GPV as JaxGPV

from gpv_tpu_torch.decode.beam import beam_decode, top_k_stable
from gpv_tpu_torch.text.vocab import AnswerVocab

from test_torch_port_gpv import (  # noqa: F401 (module-scoped fixtures)
    ARGS, QUERIES, VOCAB, _jax_encode, close, engines, inputs, one_torch_thread,
    pair)


@pytest.fixture(scope="module")
def encoded(pair, inputs):
    jm, v, _ = pair
    _, norm, ids, valid = inputs
    memory, mem_valid, _ = _jax_encode(jm, v, norm, ids, valid)
    return np.array(memory), np.array(mem_valid)


def _mask(allowed):
    m = np.full((VOCAB,), -10000.0, np.float32)
    m[list(allowed)] = 0.0
    return m


def test_top_k_stable_matches_lax_top_k_on_ties():
    x = np.array([[0.5, 1.0, 1.0, -2.0, 1.0, 0.5],
                  [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = top_k_stable(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("K", [2, 3])
def test_beam_group_step(pair, encoded, K):
    """`text_step(beam_group=K)` over B·K beam rows with the memory
    untiled equals the same step with the memory repeated K-fold (the
    port's own plain path), and equals the JAX step."""
    jm, v, pm = pair
    memory, mem_valid = encoded
    B = memory.shape[0]
    rng = np.random.RandomState(4)
    toks = rng.randint(0, VOCAB, (3, B * K))
    mem_t, valid_t = torch.from_numpy(memory), torch.from_numpy(mem_valid)
    with torch.no_grad():
        state = pm.precompute_text_memory(mem_t)
        state_rep = pm.precompute_text_memory(
            mem_t.repeat_interleave(K, 0))
        grouped = pm.init_text_cache(B * K, "cpu")
        tiled = pm.init_text_cache(B * K, "cpu")
        got, rep = [], []
        for t in range(3):
            tok = torch.from_numpy(toks[t])
            got.append(pm.text_step(tok, state, valid_t, grouped, t,
                                    beam_group=K))
            rep.append(pm.text_step(tok, state_rep,
                                    valid_t.repeat_interleave(K, 0), tiled,
                                    t))
    j_state = jm.apply(v, jnp.asarray(memory),
                       method=JaxGPV.precompute_text_memory)
    j_caches = jm.apply(v, B * K, method=JaxGPV.init_text_cache)
    for t in range(3):
        logits, j_caches = jm.apply(
            v, jnp.asarray(toks[t], jnp.int32), j_state,
            jnp.asarray(mem_valid), j_caches, t, beam_group=K,
            method=JaxGPV.text_step)
        close(got[t], rep[t], 1e-5)
        close(got[t], logits, 2e-3)


@pytest.mark.parametrize("masked", [False, True], ids=["open", "masked"])
@pytest.mark.parametrize("K", [1, 3])
def test_beam_decode(pair, encoded, K, masked):
    jm, v, pm = pair
    memory, mem_valid = encoded
    vocab = AnswerVocab.debug(size=VOCAB)
    mask = _mask(range(0, VOCAB, 3)) if masked else None
    fn = jax.jit(lambda m, mv, vm: jax_beam(jm, v, m, mv, vocab.cls_id, K,
                                            vm))
    r_seqs, r_logp = fn(memory, mem_valid, mask)
    seqs, logp = beam_decode(pm, torch.from_numpy(memory),
                             torch.from_numpy(mem_valid), vocab.cls_id, K,
                             None if mask is None else torch.from_numpy(mask))
    assert seqs.shape == (memory.shape[0], K, ARGS["max_text_len"] - 1)
    assert seqs.dtype == torch.int32 and logp.dtype == torch.float32
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(r_seqs))
    close(logp, r_logp, 2e-3)
    assert (np.diff(logp.numpy(), axis=1) <= 0).all()
    if masked:
        assert np.isin(seqs.numpy(), np.flatnonzero(mask == 0)).all()


@pytest.mark.parametrize("reference_quirks", [False, True])
def test_engine_predict_beam(engines, inputs, reference_quirks):
    images = inputs[0]
    ref = engines[0].predict_beam(images, QUERIES, beam_size=3,
                                  reference_quirks=reference_quirks)
    got = engines[1].predict_beam(images, QUERIES, beam_size=3,
                                  reference_quirks=reference_quirks)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["answers"] == r["answers"]
        assert len(g["answers"]) == 3
        close(g["answer_probs"], r["answer_probs"], 2e-3)
        close(g["boxes"], r["boxes"], 2e-4)
        close(g["relevance"], r["relevance"], 5e-4)
        assert all(0 < p <= 1 for p in g["answer_probs"])
        # exp taken in fp32, as gpv_tpu takes it: each value is an fp32
        assert all(float(np.float32(p)) == p for p in g["answer_probs"])
