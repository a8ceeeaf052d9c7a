"""Public wrapper of the embedding bag: the CUDA kernel of
``csrc/embedding_bag.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU.

``embedding_bag_kernel`` is differentiable in the table through one
``torch.autograd.Function``, as the reference's ``custom_vjp``: its backward
scales the bag cotangent by the mask and sums the (B·L, d) contributions
into a dense (N, d) gradient at the slots' rows. On the card that sum is
the segment-sum kernel's bag form (``csrc/segment_sum.cu``,
``kernels.segment_sum.segment_sum(..., bag_weights=mask)``): the slots are
sorted by row, each contribution ``g[b] * mask[b, j]`` is formed in
float32 inside the kernel as ``ref.py::contributions`` forms it, and each
row's contributions are summed in float64 in a fixed order and rounded
once, with no float atomics, so repeat runs give the same bits and the
result is the function of ``embedding_bag_bwd_ref`` (``ref.py`` says why
float64). The reference forms the gradient with ``segment_sum``, outside
any Pallas kernel. The CPU route is ``embedding_bag_bwd_ref``;
``embedding_bag_bwd_segments`` is the card's route on any device (on the
CPU through ``segment_sum_ref``).

On CUDA tensors the forward launches the kernel or raises; there is no
fallback. ``embedding_bag_fwd.launches`` counts forward kernel launches and
``segment_sum.launches`` the backward's, and only those.

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns empties of the
kernel's output shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.segment_sum.ops import segment_sum

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
    if ids.ndim != 2 or mask.shape != ids.shape:
        raise ValueError(f"ids and mask must be one (B, L) shape, got "
                         f"{tuple(ids.shape)} and {tuple(mask.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table: expected torch.float32, got {table.dtype}")
    if ids.dtype not in IDS_64:
        raise TypeError(f"ids: expected int32 or int64, got {ids.dtype}")
    if mask.dtype not in MASK_FLOAT:
        raise TypeError(f"mask: expected bool or float32, got {mask.dtype}")
    dev = table.device
    for what, x in (("ids", ids), ("mask", mask)):
        if x.device != dev:
            raise ValueError(f"{what} lies on {x.device}, the table on {dev}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError("table, ids and mask must be contiguous")


def embedding_bag_fwd(table, ids, mask) -> torch.Tensor:
    """table (N, d); ids, mask (B, L) -> (B, d) float32, the masked sum per
    bag: on the card through the kernel, on the CPU through the plain
    version."""
    if _region.WALK is not None or table.is_meta:
        return _region.run("embedding_bag_fwd", embedding_bag_fwd,
                           (table, ids, mask), meta=table.is_meta,
                           shape=_fwd_shape, cost=fwd_cost)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mask)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA or the CPU, not on "
                         f"{table.device}")
    _check(table, ids, mask)
    (n, d), (b, l) = table.shape, ids.shape
    dev = table.device
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    with on_card(dev):
        err = _kernel()(table.data_ptr(), n, d, ids.data_ptr(),
                        IDS_64[ids.dtype], mask.data_ptr(),
                        MASK_FLOAT[mask.dtype], b, l, out.data_ptr(),
                        raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{err}")
    embedding_bag_fwd.launches += 1
    return out


def embedding_bag_bwd_segments(g, ids, mask, n_rows: int) -> torch.Tensor:
    """The dense (n_rows, d) table gradient for the bag cotangent g (B, d)
    by ``segment_sum``'s bag form: the kernel on the card, on the CPU the
    same products summed by its plain version."""
    return segment_sum(g, ids, n_rows, bag_weights=mask.to(g.dtype))


def embedding_bag_bwd(g, ids, mask, n_rows: int) -> torch.Tensor:
    """The dense (n_rows, d) table gradient for the bag cotangent g (B, d):
    on the card ``embedding_bag_bwd_segments`` (one segment-sum launch,
    deterministic), on the CPU the plain version. Under an op walk it is
    the region of the kernel it launches, ``segment_sum``."""
    if _region.WALK is not None or g.is_meta:
        return _region.run("segment_sum", embedding_bag_bwd,
                           (g, ids, mask, n_rows), meta=g.is_meta,
                           shape=_bwd_shape, cost=bwd_cost)
    if g.device.type == "cpu":
        return embedding_bag_bwd_ref(g, ids, mask, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA or the CPU, not on "
                         f"{g.device}")
    return embedding_bag_bwd_segments(g, ids, mask, n_rows)


embedding_bag_fwd.launches = 0


def _fwd_shape(table, ids, mask):
    return torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32,
                       device=table.device)


def _bwd_shape(g, ids, mask, n_rows):
    return torch.zeros((n_rows, g.shape[-1]), dtype=torch.float32,
                       device=g.device)


def fwd_cost(table, ids, mask) -> dict:
    """The bag's forward from shapes: every slot reads its id, mask and
    row; each bag's sum is written once."""
    (b, l), d = ids.shape, table.shape[1]
    return {"flops": 2 * b * l * d,
            "bytes": _region.nbytes(ids, mask) + 4 * b * l * d + 4 * b * d}


def bwd_cost(g, ids, mask, n_rows) -> dict:
    """The bag's backward (the segment sum's bag form) from shapes: every
    slot reads its id, weight and bag cotangent; the (n_rows, d) gradient
    is written once."""
    d = g.shape[-1]
    n = ids.numel()
    return {"flops": 2 * n * d,
            "bytes": _region.nbytes(ids, mask) + 4 * n * d + 4 * n_rows * d}


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


def embedding_bag_kernel_sharded(table, ids, mask, *, rows_axes=("model",),
                                 mesh=None) -> torch.Tensor:
    """The differentiable bag on a mesh: table rows over ``rows_axes``, bags
    over the other axes, partial bags merged by one ``all_reduce``; the
    backward is the segment sum's bag form into each rank's row block.
    Within ~1e-6 of the single-device kernel when the rows really split
    (the sum reassociates); the single-device kernel when no mesh of more
    than one rank is active (see ``repro_torch.dist.shard``)."""
    from repro_torch.dist.shard import sharded_embedding_bag
    return sharded_embedding_bag(table, ids, mask, rows_axes=rows_axes,
                                 mesh=mesh)
