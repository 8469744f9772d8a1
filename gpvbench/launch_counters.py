"""Launch counters of the program that a kernel group names
(`kernels/<kind>-*.json`, `counters`) where a checkout of the program may
lack the module that holds them.

The predict driver reads every named counter's `variant_launches` in
every run (`drivers/predict.py`), traced or not, so a counter named
straight from a module the program does not have yet would stop the
cells that never launch its kernel. A group names such a counter here:
it is the program's own function where the program has its module, and
otherwise a stand-in that counts nothing, as the trace of such a program
holds none of the kernel's launches. A module that is there but fails to
import raises as it would.
"""
from __future__ import annotations

import importlib


def program_counter(module: str, name: str):
    """`module`'s function `name`, or a stand-in with no launches where
    the program has no `module`."""
    try:
        return getattr(importlib.import_module(module), name)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise

    def absent():
        """A kernel this checkout of the program does not have."""
    absent.variant_launches = {}
    return absent


ms_deform_attn = program_counter("gpv_tpu_torch.ops.ms_deform_attn",
                                 "ms_deform_attn")
