"""A configuration's family: the modules that know its architecture.

Every configuration file names its family (`"family": "gpv"`); a missing
key is an error. Family F is three modules of this package, found by
name:

- `reference/F.py`: the plain forward pass and its weights (`REFERENCE`);
- `reference/F_train.py`: the training reference, needed only by a cell
  whose driver trains (`TRAIN_REFERENCE`);
- `counts/F.py`: the work counted from shapes (`COUNTS`).

The harness takes these through this lookup and never by a fixed name,
so a configuration of another architecture comes as new files.
"""
from __future__ import annotations

import importlib

REFERENCE = ("param_spec", "make_weights", "Precision", "tokenize", "encode",
             "answer_logits")
TRAIN_REFERENCE = ("batch_tensors", "trainable", "train")
COUNTS = ("predict_flops", "train_flops", "predict_work")


def name(config: dict) -> str:
    """The family a configuration names."""
    family = config.get("family")
    if family is None:
        raise ValueError(f"configuration {config.get('name')!r} names no "
                         "family")
    if not family.isidentifier():
        raise ValueError(f"family {family!r} is not a module name")
    return family


def _module(path: str, names):
    mod = importlib.import_module(f"gpvbench.{path}")
    missing = [n for n in names if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"gpvbench/{path.replace('.', '/')}.py has no "
                             + ", ".join(missing))
    return mod


def reference(config: dict):
    return _module(f"reference.{name(config)}", REFERENCE)


def train_reference(config: dict):
    return _module(f"reference.{name(config)}_train", TRAIN_REFERENCE)


def counts(config: dict):
    return _module(f"counts.{name(config)}", COUNTS)
