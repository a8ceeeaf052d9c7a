"""Hand-written CUDA kernels for Hopper, one package each.

Each package holds ``ref.py`` (the plain PyTorch version, which CPU tensors
take) and ``ops.py`` (the wrapper, which launches the kernel built from
``repro_torch/csrc/<name>.cu`` for CUDA tensors and counts its launches).
"""
