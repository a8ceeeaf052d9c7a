"""Field bookkeeping for multi-field categorical inputs.

One global embedding table spans all feature fields; a sample's per-field
local ids are globalized by adding the field's vocabulary offset.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class FieldSpec(NamedTuple):
    name: str
    vocab: int


def field_offsets(fields: Sequence[FieldSpec]) -> np.ndarray:
    sizes = np.asarray([f.vocab for f in fields], np.int64)
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


def total_vocab(fields: Sequence[FieldSpec]) -> int:
    return int(sum(f.vocab for f in fields))


def globalize_ids(local_ids, offsets) -> torch.Tensor:
    """local_ids: (B, F) per-field ids -> (B, F) global table rows, int32 on
    ``local_ids``' device. The reference returns int32 with x64 off, as it
    runs; the port does the same whatever the integer type it is given (the
    packed table's index vectors are int32 too)."""
    local_ids = torch.as_tensor(local_ids)
    offsets = torch.as_tensor(offsets, dtype=torch.int32,
                              device=local_ids.device)
    return local_ids.to(torch.int32) + offsets[None, :]
