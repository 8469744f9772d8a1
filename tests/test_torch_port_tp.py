"""The port's tensor parallelism on the CPU against the JAX package's.

`gpv_tpu/parallel/sharding_rules.py` shards the wide projections over the
mesh's `model` axis and GSPMD keeps the unsharded step's mathematics. The
port runs a model group as processes (gloo ranks, each a fresh process of
tests/_torch_tp_worker.py on a free local port with a timeout of its own),
each holding its shard (`gpv_tpu_torch.models.gpv.shard_params`). So:
  - the port's rules on the bridged torch names are the JAX rules
    transposed, divisibility fallback included; the head rule is the one
    recorded difference;
  - sharding then gathering a state dict is the identity, bit for bit, and
    a rank's packed q/k/v holds the JAX q/k/v kernels' column shards;
  - a (1, 2) deterministic forward matches JAX `shard_params` +
    `model.apply` on a (4, 2) mesh (boxes 2e-4, relevance 5e-4, logits
    2e-3, greedy tokens exact);
  - (1, 2) and (2, 2) train steps match the JAX step on the matching mesh
    (tolerances of tests/test_torch_port_train_step.py), replicated
    leaves bit-equal across each model group and shards across data
    peers; at dropout 0.1 the TP step is the model-1 step;
  - the mesh refuses multi-host TP, a mesh that is not the world, and the
    query dedup over more than one data rank.
"""
import json
import sys
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.decode import greedy_decode as jax_greedy
from gpv_tpu.losses import LossConfig as JaxLossConfig
from gpv_tpu.models.gpv import GPV as JaxGPV
from gpv_tpu.parallel import create_train_state
from gpv_tpu.parallel import make_mesh as jax_mesh
from gpv_tpu.parallel import make_train_step as jax_train_step
from gpv_tpu.parallel import shard_batch
from gpv_tpu.parallel import shard_params as jax_shard_params
from gpv_tpu.parallel.sharding_rules import \
    make_param_shardings as jax_shardings
from gpv_tpu.train import build_optimizer as jax_optimizer

from gpv_tpu_torch.losses.criterion import LossConfig
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.parallel import mesh
from gpv_tpu_torch.parallel.sharding_rules import (attention_blocks,
                                                   gather_state_dict,
                                                   make_param_shardings,
                                                   param_partition_spec,
                                                   shard_state_dict)
from gpv_tpu_torch.parallel.train_step import TrainState, make_train_step
from gpv_tpu_torch.text.vocab import AnswerVocab
from gpv_tpu_torch.text.wordpiece import WordPieceTokenizer
from gpv_tpu_torch.train import trainer as trainer_mod
from gpv_tpu_torch.train.optimizer import build_optimizer
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import init_random, state_dict_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data  # noqa
from _torch_tp_worker import ROOT, run_ranks  # noqa: E402
from _torch_train_common import (ARGS, DETR_CFG, H, S, VOCAB,  # noqa: E402
                                 W, jax_model, jax_variables, load_port,
                                 make_batch, port_model, to_jax_tree,
                                 training_cfg)

NOISE = 1e-5
LR = 1e-3
CODES = {(): None, (None, "model"): 0, ("model", None): 1}


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


# ------------------------------------------------------------------ rules

def _shapes(jm):
    return jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, H, W, 3)), jnp.zeros((1, 5), jnp.int32),
        jnp.zeros((1, S), jnp.int32)), jax.random.PRNGKey(0))


@pytest.mark.parametrize("data,model,ffn", [
    (4, 2, 64), (2, 4, 64), (2, 3, 48), (1, 8, 64)],
    ids=["model2", "model4", "model3_fallback", "model8_head_rule"])
def test_port_rules_are_the_jax_rules_transposed(data, model, ffn):
    """Every leaf's JAX spec on a (data, model) mesh, carried through the
    weight bridge as a constant code, is the port's sharded torch dim on
    the bridged name. At model 3 the 32-wide projections fall back to
    replicated and the 48-wide FFN shards; at model 8 every attention
    block (4 heads) stays replicated by the head rule, recorded, while
    GSPMD shards it."""
    jm = jax_model(dim_feedforward=ffn)
    shapes = _shapes(jm)
    jmesh = jax_mesh(data, model, jax.devices()[:data * model])
    specs = jax_shardings(jmesh, shapes["params"])
    code = {v: i for i, v in enumerate(CODES)}
    coded = jax.tree.map(
        lambda s, sh: np.full(s.shape, code[tuple(sh.spec)], np.float32),
        shapes["params"], specs)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    bridged = state_dict_from_jax({"params": coded, "batch_stats": zeros})
    pm = port_model(dim_feedforward=ffn)
    rules = make_param_shardings(pm, model)
    assert set(rules.dims) == {n for n, _ in pm.named_parameters()}
    kept = {n for block, _, names in attention_blocks(pm)
            if block in rules.replicated_heads for n in names}
    differ, sharded = set(), 0
    for name, dim in rules.dims.items():
        vals = torch.unique(bridged[name])
        assert len(vals) == 1, name
        want = list(CODES.values())[int(vals[0])]
        sharded += dim is not None
        if dim != want:
            differ.add(name)
            assert dim is None and want is not None, name
    assert sharded > 0
    assert differ == kept  # the head rule's blocks, and nothing else
    if model == 8:  # 4 heads: every attention block of the model
        assert len(rules.replicated_heads) == len(list(
            attention_blocks(pm))) == 9
    else:
        assert not rules.replicated_heads


def test_param_partition_spec_on_reference_names():
    cases = {
        "detr.transformer.encoder.layers.0.self_attn.in_proj_weight": 0,
        "detr.transformer.encoder.layers.0.self_attn.in_proj_bias": None,
        "detr.transformer.encoder.layers.0.self_attn.out_proj.weight": 1,
        "detr.transformer.decoder.layers.0.linear1.weight": 0,
        "detr.transformer.decoder.layers.0.linear2.weight": 1,
        "bert.model.encoder.layer.0.attention.self.key.weight": 0,
        "bert.model.encoder.layer.0.attention.output.dense.weight": 1,
        "bert.model.encoder.layer.0.intermediate.dense.weight": 0,
        "bert.model.encoder.layer.0.output.dense.weight": 1,
        "bert.model.encoder.layer.0.output.LayerNorm.weight": None,
        "co_att_transformer.0.biattention.value2.weight": 0,
        "co_att_transformer.0.biOutput.dense1.weight": None,
        "co_att_transformer.0.v_intermediate.dense.weight": 0,
        "co_att_transformer.0.t_output.dense.weight": 1,
        "text_decoder.layers.0.multihead_attn.in_proj_weight": 0,
        "detr_joiner.weight": None, "answer_head.vocab_embed": None,
        "bert.model.embeddings.word_embeddings.weight": None,
    }
    for name, want in cases.items():
        shape = (4,) if name.endswith("bias") or "LayerNorm" in name \
            else (8, 8)
        assert param_partition_spec(name, shape) == want, name


@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_the_identity(jax_pair, model):
    """Bit for bit; rank m's packed in_proj_weight is [q_m; k_m; v_m],
    the m-th column shards of the JAX q/k/v kernels (transposed)."""
    jm, v = jax_pair
    pm = load_port(port_model(), v)
    sd = pm.state_dict()
    rules = make_param_shardings(pm, model)
    parts = [shard_state_dict(sd, rules.specs, r, model)
             for r in range(model)]
    back = gather_state_dict(parts, rules.specs)
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    for torch_name, jax_attn in (
            ("detr.transformer.encoder.layers.0.self_attn",
             v["params"]["detr"]["transformer"]["encoder_layer0"]
             ["self_attn"]),
            ("detr.transformer.decoder.layers.1.multihead_attn",
             v["params"]["detr"]["transformer"]["decoder_layer1"]
             ["cross_attn"]),
            ("text_decoder.layers.0.self_attn",
             v["params"]["text_decoder"]["layer0"]["self_attn"])):
        for r, part in enumerate(parts):
            want = []
            for proj in ("q_proj", "k_proj", "v_proj"):
                kern = np.asarray(jax_attn[proj]["kernel"])
                n = kern.shape[1] // model
                want.append(kern[:, r * n:(r + 1) * n].T)
            np.testing.assert_array_equal(
                part[f"{torch_name}.in_proj_weight"].numpy(),
                np.concatenate(want), err_msg=f"{torch_name} rank {r}")


# ------------------------------------------------------------- processes

def _ranks(tmp_path, model, batch, spec):
    torch.save(model, tmp_path / "model.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    world = spec["data"] * spec["model"]
    run_ranks(tmp_path, world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _check_layout(ranks, model=2):
    """Replicated leaves bit-equal across each model group, shards across
    data peers, and the gathered whole the same on every rank."""
    sharded = set(ranks[0]["sharded"])
    for r, rec in enumerate(ranks):
        peer = ranks[r - r % model]  # the model group's first rank
        data_peer = ranks[r % model]  # the same model index, data 0
        for k, t in rec["params"].items():
            other = data_peer if k in sharded else peer
            assert torch.equal(t, other["params"][k]), (r, k)
        for k, t in rec["full_params"].items():
            assert torch.equal(t, ranks[0]["full_params"][k]), (r, k)


def _one_process(model, batch, cfg, steps=1):
    opt, sched = build_optimizer(cfg, 10, model)
    step = make_train_step(model, LossConfig(), 0.1)
    state = TrainState(model, opt, sched)
    losses = [{k: float(x) for k, x in step(state, batch).items()}
              for _ in range(steps)]
    return losses, {n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None}


def _step_spec(data, cfg, steps=1):
    return {"task": "step", "data": data, "model": 2, "grad_accum": 1,
            "training": dict(cfg), "steps": steps}


@pytest.fixture(scope="module")
def jax_grads(jax_pair):
    """The JAX TP step's clipped gradients on a (1, 2) mesh (SGD at lr 1
    moves each leaf by its gradient)."""
    jm, v = jax_pair
    new, _ = _jax_tp_step(jm, v, make_batch(8, seed=3), optax.sgd(1.0), 1)
    old = _flat(v["params"])
    return {k: old[k] - x for k, x in _flat(new).items()}


def _jax_tp_step(jm, v, batch, tx, data):
    m = jax_mesh(data, 2, jax.devices()[:2 * data])
    state = create_train_state(v, tx)
    step = jax_train_step(jm, tx, JaxLossConfig(), 0.1, mesh=m, donate=False,
                          state_template=state)
    state, losses = step(state, shard_batch(jax.tree.map(jnp.asarray, batch),
                                            m), jax.random.PRNGKey(0))
    return state.params, {k: float(x) for k, x in losses.items()}


@pytest.mark.parametrize("data", [1, 2], ids=["mesh1x2", "mesh2x2"])
def test_tp_step_matches_the_jax_tp_step(jax_pair, jax_grads, tmp_path,
                                         data):
    """Global B=8 on a (data, 2) mesh: the losses, the gathered clipped
    gradients and the AdamW update equal the JAX step's on the same mesh
    with `state_template` (TP shardings)."""
    jm, v = jax_pair
    batch = make_batch(8, seed=3)
    cfg = training_cfg(lr=LR)
    ranks = _ranks(tmp_path, load_port(port_model(), v), batch,
                   _step_spec(data, cfg))
    _check_layout(ranks)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    new, jlosses = _jax_tp_step(jm, v, batch,
                                jax_optimizer(cfg, 10, v["params"]), data)
    assert set(ranks[0]["losses"]) == set(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(ranks[0]["losses"][k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    full = ranks[0]["full_params"]
    zeros = {n: torch.zeros_like(t) for n, t in
             load_port(port_model(), v).named_parameters()}
    pgrads = _flat(to_jax_tree({**full, **zeros,
                                **ranks[0]["full_grads"]})["params"])
    pnew = _flat(to_jax_tree(full)["params"])
    old = _flat(v["params"])
    moved = 0
    for k, w in _flat(new).items():
        g = jax_grads[k]
        assert np.abs(pgrads[k] - g).max() <= 1e-3 * np.abs(g).max() \
            + NOISE, k
        sure = np.abs(g) > max(1e-3 * np.abs(g).max(), NOISE)
        np.testing.assert_allclose(pnew[k][sure], w[sure], atol=1e-6,
                                   rtol=0, err_msg=k)
        moved += bool(np.any(w != old[k]))
    assert moved > 0


def test_tp_dropout_masks_are_the_model1_masks(tmp_path):
    """At dropout 0.1 a rank draws its slice of the whole tensor's mask
    where a tensor is sharded and the whole mask where it is replicated,
    from a seed folding the data index: two (1, 2) steps give the model-1
    steps' losses and gradients, and the ranks stay bit-equal."""
    torch.manual_seed(0)
    pm = init_random(GPV(dropout=0.1, detr_cfg=dict(DETR_CFG, dropout=0.1),
                         **ARGS), 0)
    batch = make_batch(8, seed=1)
    cfg = training_cfg(lr=LR)
    ranks = _ranks(tmp_path, pm, batch, _step_spec(1, cfg, steps=2))
    _check_layout(ranks)
    losses, grads = _one_process(pm, batch, cfg, steps=2)
    assert losses[0] != losses[1]
    for got, want in zip(ranks[0]["step_losses"], losses):
        for k, x in want.items():
            np.testing.assert_allclose(got[k], x, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for n, g in grads.items():
        tol = 1e-3 * g.abs().max().item() + NOISE
        assert (ranks[0]["full_grads"][n] - g).abs().max().item() <= tol, n
    # dropout acted: the deterministic model gives other losses
    pm0 = init_random(GPV(dropout=0.0, detr_cfg=dict(DETR_CFG, dropout=0.0),
                          **ARGS), 0)
    assert _one_process(pm0, batch, cfg)[0][0] != losses[0]


def test_tp_forward_matches_jax_sharded_apply(jax_pair, tmp_path):
    """A (1, 2) deterministic forward (the kernels' plain versions at 2 of
    4 heads) against JAX `shard_params` + `model.apply` on a (4, 2)
    mesh."""
    jm, v = jax_pair
    rng = np.random.RandomState(1)
    images = rng.randint(0, 255, (2, H, W, 3)).astype(np.uint8)
    ids, valid = WordPieceTokenizer.debug().batch_encode(
        ["what is the man riding?", "dog"], 8)
    norm = ((images / 255.0 - np.array([0.485, 0.456, 0.406]))
            / np.array([0.229, 0.224, 0.225])).astype(np.float32)
    aids = rng.randint(0, VOCAB, (2, S)).astype(np.int32)
    cls_id = AnswerVocab.debug(size=VOCAB).cls_id
    ranks = _ranks(tmp_path, load_port(port_model(), v),
                   {"images": norm, "ids": ids, "valid": valid,
                    "answer_ids": aids},
                   {"task": "forward", "data": 1, "model": 2,
                    "cls_id": cls_id})
    jmesh = jax_mesh(4, 2)
    vs = {"params": jax_shard_params(v["params"], jmesh),
          "batch_stats": v["batch_stats"]}
    memory, mem_valid, out = jm.apply(vs, norm, ids, query_valid=valid,
                                      method=JaxGPV.encode)
    logits = jm.apply(vs, norm, ids, aids, query_valid=valid)[
        "answer_logits"]
    tok, step_logits = jax_greedy(jm, vs, memory, mem_valid, cls_id)
    for r in ranks:
        for key, ref, atol in (
                ("pred_boxes", out["pred_boxes"], 2e-4),
                ("pred_relevance_logits", out["pred_relevance_logits"],
                 5e-4),
                ("answer_logits", logits, 2e-3),
                ("step_logits", step_logits, 2e-3)):
            np.testing.assert_allclose(r[key].numpy(), np.asarray(ref),
                                       atol=atol, rtol=0, err_msg=key)
        np.testing.assert_array_equal(r["tokens"].numpy(), np.asarray(tok))
        for k in ("pred_boxes", "memory", "tokens"):
            assert torch.equal(r[k], ranks[0][k]), k


# ------------------------------------------------------------- refusals

def test_multihost_tensor_parallelism_is_refused():
    """Two hosts of two processes (LOCAL_WORLD_SIZE 2 of WORLD_SIZE 4):
    refused before joining, with the JAX package's reason; data
    parallelism over them stays allowed."""
    env = {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    with pytest.raises(ValueError, match="multi-host tensor parallelism "
                                         "is not supported"):
        mesh.initialize_distributed({"mesh": {"data": -1, "model": 2}},
                                    "cpu", env)
    cluster = mesh.cluster_from_config({}, env)
    mesh.validate_multihost_mesh(mesh.Mesh(4, 1), cluster)
    mesh.validate_multihost_mesh(mesh.Mesh(2, 2), mesh.Cluster(
        "h:1", 4, 0, 0, 4))


def test_mesh_must_be_the_world():
    assert mesh.make_mesh(2, 2, world=4) == mesh.Mesh(2, 2)
    with pytest.raises(ValueError, match="data=3 x model=2"):
        mesh.make_mesh(3, 2, world=4)
    with pytest.raises(ValueError, match="multiple of 4 processes"):
        mesh.make_mesh(-1, 4, world=6)
    with pytest.raises(ValueError, match="< 1"):
        mesh.make_mesh(-1, 0, world=2)


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("tp_data"))


def test_dedup_refused_with_two_data_ranks(fake_data, tmp_path,
                                           monkeypatch):
    """(data 2, model 2) over four processes: the data ranks hold other
    rows, so the dedup is refused as in the JAX trainer; (data 1, model 2)
    holds one set of rows and is not."""
    args = [f"data_dir={fake_data}", f"output_dir={tmp_path}",
            "exp_name=tp", "learning_datasets=cap_vqa",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)
            ] + TINY_OVERRIDES + ["device=cpu", "tb_dir=null",
                                  "training.query_dedup=true",
                                  "tpu.mesh={data: -1, model: 2}"]
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    cfg = load_config(ROOT / "configs", "exp/gpv", args)
    with pytest.raises(ValueError, match="tpu.mesh.data=2"):
        trainer_mod.Trainer(cfg)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    assert mesh.mesh_from_config(cfg.tpu) == mesh.Mesh(1, 2)
