"""Model configurations, registered by architecture id.

Each module defines ``ARCH`` (an ``ArchSpec``); importing this package
registers them all, as the reference's does. ``get_arch(arch_id)`` resolves
one; ``ALL_ARCHS()`` lists every id.
"""
from repro_torch.configs.base import (ALL_ARCHS, ArchSpec, _register_all,
                                      get_arch, register_arch)

_register_all()     # imports every arch module: each registers its ARCH

__all__ = ["ArchSpec", "get_arch", "ALL_ARCHS", "register_arch"]
