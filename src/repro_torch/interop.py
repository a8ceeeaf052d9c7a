"""The weight carrier: the reference's pytrees, as numpy, into the port.

``model_from_numpy`` takes the reference's (params, state, buffers) for a
model (a DLRM, Wide & Deep, SASRec, BST, two-tower, GIN), already turned
into nested dicts/lists of numpy arrays by the caller, and returns the
port's (params, state, buffers) on ``device``. It carries the tables of
the ``packed``, ``mpe_search``, ``mpe_retrain`` compressors and of the
Table-3 baselines (``plain``, ``lsq``, ``alpt``, ``qr``, ``pep``,
``optfs``) with their buffers (``group_of_feature``, ``freq_sum``,
``bits_idx``), the model's other parameters (Wide & Deep's ``wide``
vector and ``wide_bias``; GIN's 0-d learnable ε) and buffers (the field
``offsets`` of DLRM and Wide & Deep; BST's scalar ``item_offset`` and its
``ctx_offsets`` vector; the two-tower's ``user_offsets`` and
``item_offsets``) and its state (the BatchNorm statistics of the MLPs, the
two towers' each under its own key; SASRec has none, and GIN, which has
none, passes ``{}``). An LM (no state either) carries its stacked layers
leaf for leaf: bf16 weights keep their bits, and int8 expert weights come
as their {"q", "scale"} pairs. A GIN on dense features has no table, and its
buffers no ``embedding``. ``to_torch`` carries any other tree, such as an
Adam state ({"step", "mu", "nu"}). A packed table's uint32 words pass
through ``.view(np.int32)``, so the port holds the same bits. Both
packages then compute the same function of the same weights: ``jax.random``
and ``torch.Generator`` never agree, so parity tests start both from one
carried set of parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(tree, device):
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors on
    ``device``; uint32 arrays become int32 tensors with the same bits, and
    bfloat16 arrays (numpy holds them as ``ml_dtypes.bfloat16``)
    ``torch.bfloat16`` ones with the same bits."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: its 16 bits
        return torch.tensor(arr.view(np.int16),
                            device=device).view(torch.bfloat16)
    return torch.tensor(arr, device=device)


CARRIED = ("packed", "mpe_search", "mpe_retrain", "plain", "lsq", "alpt",
           "qr", "pep", "optfs")


def model_from_numpy(params, state, buffers, cfg, device=None):
    """The port's (params, state, buffers) for a model of config ``cfg``
    whose compressor is one of ``CARRIED``; a packed table's ``comp_cfg``
    carries its bits, d and n."""
    if cfg.compressor not in CARRIED:
        raise ValueError(f"the carrier takes models with the compressors "
                         f"{CARRIED}, not {cfg.compressor!r}")
    device = resolve_device(device)
    t_buffers = to_torch({k: v for k, v in buffers.items() if k != "embedding"},
                         device)
    if cfg.compressor == "packed":
        t_buffers["embedding"] = {"meta": {
            "bits": tuple(cfg.comp_cfg["bits"]), "d": int(cfg.comp_cfg["d"]),
            "n": int(cfg.comp_cfg["n"])}}
    elif "embedding" in buffers:    # a GIN on dense features has no table
        t_buffers["embedding"] = to_torch(buffers["embedding"], device)
    return to_torch(params, device), to_torch(state, device), t_buffers
