"""Production mesh construction.

A FUNCTION, not a module-level constant: importing this module starts no
process group. The reference's TPU constants (peak rates of a v5e chip)
have no counterpart here: no module reads them, and they describe
another device.
"""
from __future__ import annotations

from repro_torch.dist.mesh import make_device_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod. Needs a
    process group of that many ranks (``init_distributed``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes)


def production_dry_mesh(*, multi_pod: bool = False, rank: int = 0):
    """The production mesh as rank ``rank`` sees it in a dry run
    (``repro_torch.dist.shard.DryMesh``): the same axes and sizes, this
    rank's coordinates, no process group and so no peer."""
    from repro_torch.dist.shard import DryMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DryMesh(shape, axes, rank)
