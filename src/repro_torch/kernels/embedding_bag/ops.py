"""Public wrapper of the embedding bag: the CUDA kernel of
``csrc/embedding_bag.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

``embedding_bag_kernel`` is differentiable in the table through one
``torch.autograd.Function``, as the reference's ``custom_vjp``: its backward
scales the bag cotangent by the mask and sums the (B·L, d) contributions
into a dense (N, d) gradient. On the card that sum is
``aten.embedding_dense_backward``, ``F.embedding``'s backward: it sorts the
ids and sums each row's contributions over its sorted segment, so repeat
runs give the same bits (``index_add_``'s float atomics would not). It sums
in float64 and rounds once, as the forward kernel and the plain versions do
(``ref.py`` says why), over the distinct rows only: the float64 sums go to
a (U, d) buffer, whose rows are copied once each into the float32 (N, d)
gradient. The reference forms it with ``segment_sum``, outside any Pallas
kernel.

On CUDA tensors the forward launches the kernel or raises; there is no
fallback. ``embedding_bag_fwd.launches`` counts kernel launches, and only
those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.embedding_bag.ref import (contributions,
                                                   embedding_bag_bwd_ref,
                                                   embedding_bag_ref)

IDS_64 = {torch.int32: 0, torch.int64: 1}        # the kernel's id types
MASK_FLOAT = {torch.bool: 0, torch.float32: 1}   # and mask types


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("embedding_bag").embedding_bag_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, i, p, i, p, i, ll, i, p, p]
    fn.restype = i
    return fn


def _check(table, ids, mask):
    """Raise on what the kernel does not take: a float32 (N, d) table with
    N, d >= 1, int32 or int64 ids and a bool or float32 mask of one (B, L)
    shape, all contiguous on one card."""
    if table.ndim != 2 or table.shape[0] < 1 or table.shape[1] < 1:
        raise ValueError(f"table must be a non-empty (N, d), got "
                         f"{tuple(table.shape)}")
    if ids.ndim != 2 or tuple(mask.shape) != tuple(ids.shape):
        raise ValueError(f"ids and mask must be one (B, L) shape, got "
                         f"{tuple(ids.shape)} and {tuple(mask.shape)}")
    for what, x, types in (("table", table, (torch.float32,)),
                           ("ids", ids, tuple(IDS_64)),
                           ("mask", mask, tuple(MASK_FLOAT))):
        if x.device != table.device:
            raise ValueError(f"{what} lies on {x.device}, the table on "
                             f"{table.device}")
        if x.dtype not in types:
            raise TypeError(f"{what}: expected one of {types}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def embedding_bag_fwd(table, ids, mask) -> torch.Tensor:
    """table (N, d); ids, mask (B, L) -> (B, d) float32, the masked sum per
    bag: on the card through the kernel, on the CPU through the plain
    version."""
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mask)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA or the CPU, not on "
                         f"{table.device}")
    _check(table, ids, mask)
    (n, d), (b, l) = table.shape, ids.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    with torch.cuda.device(table.device):
        err = _kernel()(table.data_ptr(), n, d, ids.data_ptr(),
                        IDS_64[ids.dtype], mask.data_ptr(),
                        MASK_FLOAT[mask.dtype], b, l, out.data_ptr(),
                        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{err}")
    embedding_bag_fwd.launches += 1
    return out


def embedding_bag_bwd(g, ids, mask, n_rows: int) -> torch.Tensor:
    """The dense (n_rows, d) table gradient for the bag cotangent g (B, d):
    on the card the sorted segment sum of ``aten.embedding_dense_backward``
    in float64 over the distinct rows (deterministic), on the CPU the plain
    version."""
    if g.device.type == "cpu":
        return embedding_bag_bwd_ref(g, ids, mask, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA or the CPU, not on "
                         f"{g.device}")
    out = torch.zeros((n_rows, g.shape[-1]), dtype=g.dtype, device=g.device)
    rows, slot_row = torch.unique(ids.reshape(-1), return_inverse=True)
    sums = torch.ops.aten.embedding_dense_backward(
        contributions(g, mask), slot_row, rows.numel(), -1, False)
    return out.index_copy_(0, rows.long(), sums.to(g.dtype))  # rows distinct


embedding_bag_fwd.launches = 0


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mask):
        ctx.n_rows = table.shape[0]
        ctx.save_for_backward(ids, mask)
        return embedding_bag_fwd(table, ids, mask)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        return (embedding_bag_bwd(g.contiguous(), ids, mask, ctx.n_rows),
                None, None)


def embedding_bag_kernel(table, ids, mask) -> torch.Tensor:
    """table (N, d); ids, mask (B, L) -> (B, d), differentiable in the table.
    A mask of another type than bool or float32 is cast to float32, as the
    reference casts it to the table's type."""
    if mask.dtype not in MASK_FLOAT:
        mask = mask.to(torch.float32)
    return _EmbeddingBag.apply(table, ids.contiguous(), mask.contiguous())
