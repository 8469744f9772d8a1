"""gpv_tpu_torch — GPV-1 inference in PyTorch on an NVIDIA H100.

The port of `gpv_tpu` (JAX on a TPU) to PyTorch and CUDA. It mirrors
`gpv_tpu`'s module layout and names, imports nothing of it, and runs the
attention of its main path through hand-written CUDA kernels for Hopper
(`csrc/attention.cu`). Entry point: `gpv_tpu_torch.engine.GPVEngine`.
"""

__version__ = "0.1.0"
