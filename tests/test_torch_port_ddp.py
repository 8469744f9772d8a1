"""The port's data parallelism on the CPU: two gloo processes against the
one-process port step and the JAX package's single-process step.

`gpv_tpu/parallel/train_step.py` computes one loss over the global batch
(sharded over devices); the port runs one process per card under DDP, each
on its rows of the global batch (`parallel.mesh.shard_rows`), with the
criterion's normalisers reduced over the group. So a 2-process step on
the global batch must give the JAX step's losses and AdamW update, at the
tolerances of tests/test_torch_port_train_step.py, and the two ranks must
hold bit-equal parameters after it. Each rank is a fresh process
(tests/_torch_ddp_worker.py, or the training CLI) on a free local port,
with a timeout of its own.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gpv_tpu.losses import LossConfig as JaxLossConfig
from gpv_tpu.parallel import create_train_state
from gpv_tpu.parallel import make_train_step as jax_train_step
from gpv_tpu.train import build_optimizer as jax_optimizer

from gpv_tpu_torch.datasets.loader import DataLoader
from gpv_tpu_torch.losses.criterion import LossConfig, gpv_criterion
from gpv_tpu_torch.models.gpv import GPV
from gpv_tpu_torch.ops.image import normalize_image
from gpv_tpu_torch.parallel import mesh
from gpv_tpu_torch.parallel.train_step import (TrainState, batch_to_device,
                                               make_train_step)
from gpv_tpu_torch.train import trainer as trainer_mod
from gpv_tpu_torch.train.optimizer import build_optimizer, frozen_names
from gpv_tpu_torch.utils.config import load_config
from gpv_tpu_torch.weights import init_random

sys.path.insert(0, str(Path(__file__).parent))
from _fake_data import IMG_H, IMG_W, TINY_OVERRIDES, make_fake_data  # noqa
from _torch_train_common import (ARGS, DETR_CFG, jax_model,  # noqa: E402
                                 jax_variables, load_port, make_batch,
                                 port_model, to_jax_tree, training_cfg)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "_torch_ddp_worker.py"
RANK_TIMEOUT_S = 120
NOISE = 1e-5
LR = 1e-3


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


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]))
    return env


def run_ranks(argv, world=2, timeout=RANK_TIMEOUT_S, cwd=ROOT):
    """Start `world` processes of `argv` as ranks of one group; each must
    exit 0 within `timeout` s. Returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen(argv, cwd=cwd, env=rank_env(r, world, port),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_step(jm, v, batch, tx, **kw):
    step = jax_train_step(jm, tx, JaxLossConfig(), 0.1, donate=False, **kw)
    state, losses = step(create_train_state(v, tx),
                         jax.tree.map(jnp.asarray, batch),
                         jax.random.PRNGKey(0))
    return state.params, {k: float(x) for k, x in losses.items()}


def _two_ranks(tmp_path, model, batch, grad_accum, cfg):
    torch.save(model, tmp_path / "model.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    (tmp_path / "spec.json").write_text(json.dumps(
        {"grad_accum": grad_accum, "training": dict(cfg)}))
    run_ranks([sys.executable, str(WORKER), str(tmp_path)])
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _one_process(v, batch, grad_accum, cfg):
    pm = load_port(port_model(), v)
    opt, sched = build_optimizer(cfg, 10, pm)
    step = make_train_step(pm, LossConfig(), 0.1, grad_accum=grad_accum)
    losses = step(TrainState(pm, opt, sched), batch)
    return ({k: float(x) for k, x in losses.items()},
            {n: p.detach().clone() for n, p in pm.state_dict().items()},
            {n: p.grad for n, p in pm.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_process_step_matches_one_process_and_jax(jax_pair, tmp_path,
                                                      grad_accum):
    """Global B=8 as 2 ranks x 4 rows (x 2 microbatches of 2 with
    grad_accum 2): losses and the AdamW update equal the JAX step's on
    the global batch, and the one-process port step's; the ranks' clipped
    gradients and parameters are bit-equal to each other."""
    jm, v = jax_pair
    batch = make_batch(8, seed=3)
    cfg = training_cfg(lr=LR)
    ranks = _two_ranks(tmp_path, load_port(port_model(), v), batch,
                       grad_accum, cfg)
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    for k in ranks[0]["grads"]:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert sorted(np.concatenate([r["rows"] for r in ranks])) == list(
        range(8))

    # the one-process port step on the global batch
    losses1, params1, grads1 = _one_process(v, batch, grad_accum, cfg)
    for k, want in losses1.items():
        np.testing.assert_allclose(ranks[0]["losses"][k], want, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, g in grads1.items():
        tol = 1e-4 * g.abs().max().item() + NOISE
        assert (ranks[0]["grads"][k] - g).abs().max().item() <= tol, k

    # the JAX step on the global batch: losses, clipped gradients (SGD at
    # lr 1) and the AdamW update
    kw = {"grad_accum": grad_accum} if grad_accum > 1 else {}
    new, jlosses = _jax_step(jm, v, batch,
                             jax_optimizer(cfg, 10, v["params"]), **kw)
    sgd_new, _ = _jax_step(jm, v, batch, optax.sgd(1.0), **kw)
    assert set(ranks[0]["losses"]) == set(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(ranks[0]["losses"][k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    old = _flat(v["params"])
    jgrads = {k: old[k] - x for k, x in _flat(sgd_new).items()}
    pgrads = _flat(to_jax_tree({**{n: t for n, t in ranks[0]["params"]
                                   .items()},
                                **{n: torch.zeros_like(t) for n, t in
                                   load_port(port_model(), v)
                                   .named_parameters()},
                                **ranks[0]["grads"]})["params"])
    pnew = _flat(to_jax_tree(ranks[0]["params"])["params"])
    moved = 0
    for k, w in _flat(new).items():
        g = jgrads[k]
        tol = 1e-3 * np.abs(g).max() + NOISE
        assert np.abs(pgrads[k] - g).max() <= tol, k
        sure = np.abs(g) > max(1e-3 * np.abs(g).max(), NOISE)
        np.testing.assert_allclose(pnew[k][sure], w[sure], atol=1e-6,
                                   rtol=0, err_msg=k)
        moved += bool(np.any(w != old[k]))
    assert moved > 0


def test_ranks_draw_different_dropout_masks(tmp_path):
    """Each rank folds its index into the dropout seed: with dropout on,
    rank 0 and rank 1 draw different masks for their rows (the JAX global
    mask has no correlation between shards)."""
    torch.manual_seed(0)
    pm = init_random(GPV(dropout=0.1, detr_cfg=dict(DETR_CFG, dropout=0.1),
                         **ARGS), 0)
    ranks = _two_ranks(tmp_path, pm, make_batch(4, seed=1), 1,
                       training_cfg())
    m0, m1 = ranks[0]["masks"][0], ranks[1]["masks"][0]
    assert m0.shape == m1.shape
    assert not torch.equal(m0, m1)
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k


class _Rows:
    """A dataset whose item is (index, its first RNG draw)."""

    def __len__(self):
        return 40

    def get(self, i, rng):
        return (i, int(rng.randint(1 << 30)))


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
def test_loader_rows_per_rank_form_the_global_batch(grad_accum):
    """Rank r holds, of each microbatch of the global batch, its m/W
    contiguous rows, each drawing from the RNG of its global row: the
    ranks' batches interleaved microbatch by microbatch are the
    one-process batch, item for item."""
    B, W = 8, 2
    whole = DataLoader(_Rows(), list, B, num_workers=0, seed=3)
    parts = [DataLoader(_Rows(), list, B, num_workers=0, seed=3,
                        num_shards=W, shard_id=r, grad_accum=grad_accum)
             for r in range(W)]
    for epoch in (0, 1):
        for loader in [whole] + parts:
            loader.set_epoch(epoch)
        for want, *got in zip(whole, *parts):
            m, lm = B // grad_accum, B // grad_accum // W
            merged = [row for i in range(grad_accum) for part in got
                      for row in part[i * lm:(i + 1) * lm]]
            assert merged == want
            assert len(want) == B and m % W == 0


def test_shard_rows_refuses_an_indivisible_microbatch():
    assert list(mesh.shard_rows(8, 2, 1, 2)) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="not divisible by 4 processes"):
        mesh.shard_rows(8, 4, 0, 4)


def _variant(**kw):
    detr = kw.pop("detr", {})
    return init_random(GPV(dropout=0.0, detr_cfg=dict(
        DETR_CFG, dropout=0.0, **detr), **{**ARGS, **kw}), 0)


@pytest.mark.parametrize("kw,unreached", [
    ({}, []),
    ({"answer_head": "linear"}, []),
    ({"relevance_conditioning": False}, ["relevance_tokens"]),
    ({"detr": {"aux_loss": True, "last_layer_only": False},
      "roi_head": False}, []),
    ({"detr": {"pre_norm": True, "position_embedding": "learned"},
      "text_pos_enc": True}, []),
], ids=["base", "linear_head", "no_relevance_conditioning", "aux_loss",
        "pre_norm_learned_pos"])
def test_forward_reaches_every_trainable_leaf_but(kw, unreached):
    """The leaves a train forward leaves without a gradient: why DDP
    searches for unused parameters only without relevance conditioning
    (parallel/train_step.py)."""
    pm = _variant(**kw)
    frozen = frozen_names(pm)
    for n, p in pm.named_parameters():
        p.requires_grad_(n not in frozen)
    b = batch_to_device(make_batch(8), "cpu")
    out = pm(normalize_image(b["image"].float() / 255.0), b["query_ids"],
             b["answer_ids"], query_valid=b["query_valid"], train=True)
    gpv_criterion(out, b, LossConfig())[0].backward()
    assert [n for n, p in pm.named_parameters()
            if p.requires_grad and p.grad is None] == unreached


# ------------------------------------------------- processes and config

def test_torchrun_variables_fill_the_cluster_and_disagreement_raises():
    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "2950"}
    c = mesh.cluster_from_config({}, env)
    assert (c.address, c.world, c.rank, c.local_rank, c.local_world) == (
        "127.0.0.1:2950", 2, 1, 1, 2)
    keys = {"distributed": {"coordinator_address": "127.0.0.1:2950",
                            "num_processes": 2, "process_id": 1}}
    assert mesh.cluster_from_config(keys, {}) == mesh.Cluster(
        "127.0.0.1:2950", 2, 1, 1, 2)
    assert mesh.cluster_from_config(keys, env) == c
    bad = {"distributed": dict(keys["distributed"], process_id=0)}
    with pytest.raises(ValueError, match="disagrees with the torchrun"):
        mesh.cluster_from_config(bad, env)
    with pytest.raises(ValueError, match="missing"):
        mesh.cluster_from_config(
            {"distributed": {"coordinator_address": "h:1",
                             "num_processes": None}}, {})
    with pytest.raises(ValueError, match="incomplete"):
        mesh.cluster_from_config({}, {"RANK": "0"})
    # the config's own defaults (address null) join nothing
    assert mesh.cluster_from_config(
        {"distributed": {"coordinator_address": None, "num_processes": 1,
                         "process_id": 0}}, {}) is None


def test_backend_is_chosen_by_rule():
    one_card_each = mesh.Cluster("h:1", 4, 0, 0, 4)
    assert mesh.choose_backend(one_card_each, torch.device("cuda", 0),
                               4)[0] == "nccl"
    shared = mesh.Cluster("h:1", 2, 1, 1, 2)
    assert mesh.choose_backend(shared, torch.device("cuda", 0),
                               1)[0] == "gloo"
    assert mesh.choose_backend(shared, torch.device("cpu"), 0)[0] == "gloo"
    assert mesh.rank_device(shared, "cpu") == torch.device("cpu")
    assert mesh.rank_device(None, "cpu") == torch.device("cpu")


def test_mesh_checks():
    assert mesh.make_mesh(-1, 1, world=2).shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="process"):
        mesh.make_mesh(2, 1, world=1)
    # tensor parallelism (item 30): data -1 is world // model
    assert mesh.make_mesh(-1, 2, world=2).shape == {"data": 1, "model": 2}
    assert mesh.make_mesh(-1, 2, world=4).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="multiple of 2 processes"):
        mesh.make_mesh(-1, 2, world=1)


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    return make_fake_data(tmp_path_factory.mktemp("ddp_data"))


def _train_args(fake_data, out, *extra):
    return [f"data_dir={fake_data}", f"output_dir={out}", "exp_name=ddp",
            "learning_datasets=cap_vqa",
            "task_configs.image_size={H: %d, W: %d}" % (IMG_H, IMG_W)
            ] + TINY_OVERRIDES + [
        "training.num_val_samples={coco_vqa: 4, coco_cap: 4}",
        "device=cpu", "tb_dir=null", "training.num_workers=1",
        "eval.num_workers=0", "training.run_vis_at_launch=false",
        "training.ckpt_step=1"] + list(extra)


def test_dedup_refused_with_two_processes(fake_data, tmp_path, monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    cfg = load_config(ROOT / "configs", "exp/gpv", _train_args(
        fake_data, tmp_path, "training.query_dedup=true"))
    with pytest.raises(ValueError, match="single host process"):
        trainer_mod.Trainer(cfg)


def test_cli_train_two_processes_saves_on_rank0_and_both_resume(fake_data,
                                                                tmp_path):
    """`cli.train` as two gloo ranks: one epoch (one step of the global
    batch 8, 4 rows a rank) with rank 0's in-train eval and checkpoints;
    then a second launch for epoch 2 that both ranks resume from
    `ckpts/last` (auto_resume)."""
    cli = [sys.executable, "-m", "gpv_tpu_torch.cli.train"]
    outs = run_ranks(cli + _train_args(fake_data, tmp_path))
    ckpts = tmp_path / "ddp" / "ckpts"
    assert (ckpts / "model").exists() and (ckpts / "last").exists()
    assert json.loads((ckpts / "last.meta.json").read_text()) == {
        "epoch": 0, "step": 1}
    assert all("over gloo on cpu" in o for o in outs)
    assert sum("epoch 0 it 0 step 1 loss" in o for o in outs) == 1

    outs = run_ranks(cli + _train_args(fake_data, tmp_path,
                                       "training.num_epochs=2",
                                       "training.auto_resume=true"))
    assert all("auto_resume: restoring" in o for o in outs)
    assert json.loads((ckpts / "last.meta.json").read_text()) == {
        "epoch": 1, "step": 2}
    payload = torch.load(ckpts / "last", weights_only=True)
    assert payload["step"] == 2
