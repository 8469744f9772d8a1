#!/usr/bin/env python3
"""Carry a JAX run's orbax checkpoint over to the PyTorch port.

    python convert_orbax_checkpoint.py exp_dir=<JAX run> [name=model] \
        out=<dir> [<dotted config overrides>...]

It reads `<exp_dir>/config.yaml` (what `gpv_tpu.cli.train` wrote), builds
the JAX train state as the template of the restore (`build_gpv`, then
`create_train_state` over `build_optimizer` with the run's own
`training.freeze` and groups: a restore without a template returns untyped
trees), restores `<exp_dir>/ckpts/<name>` with
`gpv_tpu.train.checkpoint.restore_checkpoint`, and writes `<out>/<name>`
and `<out>/<name>.meta.json` in the port trainer's format
(`gpv_tpu_torch.train.checkpoint.save_checkpoint`):
  - the model through `gpv_tpu_torch.weights.state_dict_from_jax`;
  - the step, and the run's meta (epoch, selection metric) as it is;
  - each AdamW group's parameter names, as `param_names` gives them;
  - AdamW's `exp_avg` / `exp_avg_sq` / `step` per parameter, from optax's
    per-group `mu` / `nu` / `count`. `optax.multi_transform` keeps one
    state per group, its leaves outside the group masked; the moments go
    through the same map as the weights (conv kernels transposed, q/k/v
    packed into `in_proj_weight`: the maps are elementwise). `set_to_zero`
    groups hold no moments: their parameters are frozen in the port too,
    in no group.
No schedule state is written: resuming it (`training.ckpt=<out>/<name>`,
`train.checkpoint.load_into`) keeps the resuming run's schedule at the
restored step, as the JAX package resumes. `ckpt=<out>/<name>` loads in
`infer.build.build_engine` (every inference entry point).

Overrides after the named arguments apply to the saved config (for
example `model.vocab=<path>` when the run's vocabulary has moved).

It imports JAX, flax, optax and orbax as well as the port, so it runs
where the JAX package is installed (its CPU tests run it); the machine
with the card has no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path


def _adam_state(node):
    """The first optax ScaleByAdamState (count, mu, nu) inside `node`."""
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node
    if isinstance(node, tuple):
        for x in node:
            found = _adam_state(x)
            if found is not None:
                return found
    return None


def _fill(tree, like, leaf):
    """`like`'s nested dicts with `leaf(tree's value, like's value)` at
    each leaf (optax's moment trees mirror the parameters)."""
    if isinstance(like, dict):
        return {k: _fill(tree[k], v, leaf) for k, v in like.items()}
    return leaf(tree, like)


def jax_group_moments(payload) -> dict:
    """{group: (count, {"mask"|"mu"|"nu": a params-shaped tree})} of the
    restored optax state: the leaves of a group hold its moments (the
    mask ones), the others zeros."""
    import numpy as np
    import optax

    params = payload["params"]
    out = {}
    for group, state in payload["opt_state"].inner_states.items():
        adam = _adam_state(state.inner_state)
        if adam is None:  # set_to_zero: frozen, no moments
            continue

        def moment(x, p):
            if isinstance(x, optax.MaskedNode):
                return np.zeros(np.shape(p), np.float32)
            return np.asarray(x, np.float32)

        out[group] = (int(np.asarray(adam.count)), {
            "mask": _fill(adam.mu, params, lambda x, p: np.full(
                np.shape(p), not isinstance(x, optax.MaskedNode),
                np.float32)),
            "mu": _fill(adam.mu, params, moment),
            "nu": _fill(adam.nu, params, moment)})
    return out


def restore_jax(exp_dir: Path, name: str, overrides: list):
    """(restored payload, meta) of the JAX run in `exp_dir`."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpv_tpu.models.gpv import build_gpv
    from gpv_tpu.parallel import create_train_state
    from gpv_tpu.text.vocab import AnswerVocab
    from gpv_tpu.train import build_optimizer
    from gpv_tpu.train.checkpoint import load_pretr_detr, restore_checkpoint
    from gpv_tpu.utils.config import load_config

    cfg = load_config(exp_dir, "config", overrides)
    vocab = (AnswerVocab.load(cfg.model.vocab) if cfg.model.vocab
             else AnswerVocab.debug())
    model = build_gpv(cfg.model, vocab_size=len(vocab))
    H = int(cfg.task_configs.image_size.H)
    W = int(cfg.task_configs.image_size.W)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, H, W, 3)),
                             jnp.zeros((1, 4), jnp.int32),
                             jnp.zeros((1, 4), jnp.int32), train=False),
        jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                             {"params": shapes["params"],
                              "batch_stats": shapes.get("batch_stats", {})})
    matched = None
    if cfg.training.get("freeze") and cfg.model.pretr_detr:
        # the run froze exactly the leaves its DETR checkpoint loaded
        variables, matched = load_pretr_detr(variables, cfg.model.pretr_detr)
    tx = build_optimizer(cfg.training, 1, variables["params"],
                         frozen_detr_paths=matched)
    payload, meta = restore_checkpoint(exp_dir / "ckpts",
                                       create_train_state(variables, tx),
                                       name=name)
    return payload, meta


def _vocab_len(cfg) -> int:
    from gpv_tpu_torch.text.vocab import AnswerVocab
    return len(AnswerVocab.load(cfg.model.vocab) if cfg.model.vocab
               else AnswerVocab.debug())


def convert(exp_dir, name: str, out, overrides=()) -> Path:
    """Convert `<exp_dir>/ckpts/<name>` into `<out>/<name>` (module
    docstring). Returns the written path."""
    import torch

    from gpv_tpu_torch.models.gpv import build_gpv
    from gpv_tpu_torch.parallel.train_step import TrainState
    from gpv_tpu_torch.train.checkpoint import param_names, save_checkpoint
    from gpv_tpu_torch.train.optimizer import build_optimizer
    from gpv_tpu_torch.utils.config import load_config
    from gpv_tpu_torch.weights import state_dict_from_jax

    exp_dir = Path(exp_dir)
    payload, meta = restore_jax(exp_dir, name, list(overrides))
    stats = payload["batch_stats"]
    pcfg = load_config(exp_dir, "config", list(overrides))
    model = build_gpv(pcfg.model, _vocab_len(pcfg))
    model.load_state_dict(state_dict_from_jax(
        {"params": payload["params"], "batch_stats": stats}), strict=True)
    params = dict(model.named_parameters())

    groups = {}  # group -> (count, {name: (exp_avg, exp_avg_sq)})
    for group, (count, trees) in jax_group_moments(payload).items():
        sds = {k: state_dict_from_jax({"params": t, "batch_stats": stats})
               for k, t in trees.items()}
        names = {}
        for n in params:
            mask = sds["mask"][n]
            if bool(mask.any()) != bool(mask.all()):
                raise ValueError(f"{n} straddles optax groups")
            if mask.all():
                names[n] = (sds["mu"][n], sds["nu"][n])
        groups[group] = (count, names)
    trained = {n for _, names in groups.values() for n in names}
    frozen_detr = {n for n in params
                   if n.startswith("detr.") and n not in trained}
    optimizer, _ = build_optimizer(
        pcfg.training, 1, model,
        frozen_detr_paths=frozen_detr if pcfg.training.get("freeze")
        else None)
    state = TrainState(model, optimizer, None, int(payload["step"]))
    port_groups = {g: set(n) for g, n in param_names(state).items()}
    jax_groups = {g: set(names) for g, (_, names) in groups.items() if names}
    if port_groups != jax_groups:
        raise ValueError(
            "the port's AdamW groups differ from the run's optax groups: "
            f"{sorted(port_groups)} against {sorted(jax_groups)}")
    by_id = {id(p): n for n, p in params.items()}
    for g in optimizer.param_groups:
        count, names = groups[g["name"]]
        for p in g["params"]:
            exp_avg, exp_avg_sq = names[by_id[id(p)]]
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": exp_avg.reshape(p.shape),
                "exp_avg_sq": exp_avg_sq.reshape(p.shape)}
    return save_checkpoint(out, state, dict(meta), name=name)


def main(argv=None) -> Path:
    args, overrides = {}, []
    for a in (argv if argv is not None else sys.argv[1:]):
        k, v = a.split("=", 1)
        if k in ("exp_dir", "name", "out"):
            args[k] = v
        else:
            overrides.append(a)
    if "exp_dir" not in args or "out" not in args:
        raise SystemExit("usage: python convert_orbax_checkpoint.py "
                         "exp_dir=<JAX run> [name=model] out=<dir> "
                         "[overrides...]")
    path = convert(args["exp_dir"], args.get("name", "model"), args["out"],
                   overrides)
    print(f"wrote {path} and {path.name}.meta.json")
    return path


if __name__ == "__main__":
    main()
