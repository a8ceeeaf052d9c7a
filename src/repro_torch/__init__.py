"""PyTorch/CUDA port of the mixed-precision embedding system.

Mirrors the JAX package's tree (``core/``, ``nn/``, ``models/``,
``kernels/``, ``serve/``, ``launch/``, ``configs/``, ``data/``) module for
module, so each counterpart sits at the same path. It imports neither JAX
nor the JAX package: parity with the reference is held by the tests, which
feed both the same numpy arrays.

Entry points run on the CUDA card unless the caller names another device
(``device="cpu"``); with no device given and no card present they raise.
"""
