"""gpv_tpu_torch — GPV-1 inference, evaluation and training in PyTorch on
an NVIDIA H100.

The port of `gpv_tpu` (JAX on a TPU) to PyTorch and CUDA. It mirrors
`gpv_tpu`'s module layout and names, imports nothing of it, and runs its
inference attention through hand-written CUDA kernels for Hopper
(`csrc/`). Entry points: `gpv_tpu_torch.engine.GPVEngine` and
`gpv_tpu_torch.train.trainer.Trainer`.
"""

__version__ = "0.1.0"
