"""Hand-written CUDA kernels for Hopper, one package each.

Each package holds ``ref.py`` (the plain PyTorch version, which CPU tensors
take) and ``ops.py`` (the wrapper, which launches the kernel built from
``repro_torch/csrc/<name>.cu`` for CUDA tensors and counts its launches).
"""
from repro_torch.kernels.embedding_bag.ops import embedding_bag_kernel

__all__ = ["embedding_bag_kernel"]
