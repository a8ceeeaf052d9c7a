"""The weight carrier: the reference's DLRM pytrees, as numpy, into the port.

``dlrm_from_numpy`` takes the reference's (params, state, buffers) for a
packed-table DLRM, already turned into nested dicts/lists of numpy arrays by
the caller, and returns the port's (params, state, buffers) on ``device``.
The packed table is ``params["embedding"]``; its uint32 words pass through
``.view(np.int32)``, so the port holds the same bits. Both packages then
compute the same function of the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(tree, device):
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors on
    ``device``; uint32 arrays become int32 tensors with the same bits."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.tensor(arr, device=device)


def dlrm_from_numpy(params, state, buffers, cfg, device=None):
    """The port's (params, state, buffers) for a packed DLRM of config
    ``cfg`` (``compressor="packed"``, ``comp_cfg`` with bits, d and n)."""
    if cfg.compressor != "packed":
        raise ValueError(f"the carrier takes packed-table DLRMs, not "
                         f"{cfg.compressor!r}")
    device = resolve_device(device)
    meta = {"bits": tuple(cfg.comp_cfg["bits"]), "d": int(cfg.comp_cfg["d"]),
            "n": int(cfg.comp_cfg["n"])}
    t_buffers = to_torch({k: v for k, v in buffers.items() if k != "embedding"},
                         device)
    t_buffers["embedding"] = {"meta": meta}
    return to_torch(params, device), to_torch(state, device), t_buffers
