"""gpv_tpu_torch — GPV-1 inference, evaluation and training in PyTorch on
an NVIDIA H100.

The port of `gpv_tpu` (JAX on a TPU) to PyTorch and CUDA. It mirrors
`gpv_tpu`'s module layout and names, imports nothing of it, and runs its
inference attention through hand-written CUDA kernels for Hopper
(`csrc/`). Entry points: `gpv_tpu_torch.engine.GPVEngine`,
`gpv_tpu_torch.export.ExportedEngine` and
`gpv_tpu_torch.train.trainer.Trainer`.
"""
import importlib

__version__ = "0.1.0"

# imported on first use: `import gpv_tpu_torch` loads no model code
_LAZY = {"ExportedEngine": "gpv_tpu_torch.export",
         "export_engine": "gpv_tpu_torch.export"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'gpv_tpu_torch' has no attribute {name!r}")
