"""Public wrapper of the gather's backward: the CUDA kernels of
``csrc/segment_sum.cu`` for tensors on the card, the plain version
(``ref.py``) for tensors on the CPU; and ``gather``, a row gather whose
backward it is.

``gather(table, ids)`` is ``F.embedding(ids, table)`` in its forward, in
the table's own type. Its backward sums the (T, w) cotangent, taken to
float32, into the dense (N, w) table gradient, rounded once to the table's
type:
on the card it sorts the ids stably (``torch.sort``; the kernel is the
sum), zeroes the gradient and launches the kernel, which sums every
segment in float64 in a fixed order, a long one cut over many workers,
with no float atomics; on the CPU it takes the plain version.

``segment_sum(g, ids, n, bag_weights=w)`` is the bag form, the embedding
bag's backward: g is the bag cotangent (B, w), ids and the weights
(B, L), and the row summed for slot (b, j) is ``g[b] * w[b, j]``, formed
in float32 inside the kernel (``segment_sum_bag``), so the (B·L, w)
products are never written to device memory; on the CPU the plain
version sums the same products.

``scatter_sum(x, seg, n)`` is the segment sum as a forward: GIN's message
passing and graph pooling (the reference's ``jax.ops.segment_sum``), whose
backward is the gather ``g[seg]``. Rows of any width: the kernel sums rows
wider than 256 columns in column tiles of one launch, which changes no
sum.

On CUDA tensors it launches the kernel or raises; there is no fallback.
``segment_sum.launches`` counts launches (one is the chunk kernel and its
combine), and only those. ``scratch_bytes(t, w)`` is the scratch a call
over ``t`` rows of ``w`` columns allocates beside its output.
``LIBRARY_SCATTER_ADDS`` names the library's kernels that these sums
replace, as a trace names them (``is_library_scatter_add``).

Under an op walk each call is one region (``repro_torch.kernels.region``)
charged its analytic cost; on meta tensors it returns empties of the
kernel's output shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

MAX_N = 2 ** 31 - 1  # the kernel's ids are int32
# the library's scatter-adds by their kernels' names in a trace: the dense
# embedding backward (aten::embedding_dense_backward, and its feature
# kernel), index_add_, index_put_ with accumulate; a scatter_add is a
# scatter_gather_elementwise kernel with ReduceAdd
LIBRARY_SCATTER_ADDS = ("sum_and_scatter", "compute_grad_weight",
                        "krn_partial", "compute_num_of_partial_segments",
                        "segment_offsets_kernel", "embedding_backward",
                        "embedding_dense", "indexFuncLargeIndex",
                        "indexFuncSmallIndex", "index_put_with_sort")


def is_library_scatter_add(kernel_name: str) -> bool:
    """Whether a traced kernel is one of the library's scatter-adds."""
    return (any(k in kernel_name for k in LIBRARY_SCATTER_ADDS)
            or ("scatter_gather_elementwise" in kernel_name
                and "ReduceAdd" in kernel_name))


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("segment_sum")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum.argtypes = [p, p, p, ll, i, p, p, p]
    lib.segment_sum.restype = i
    lib.segment_sum_bag.argtypes = [p, p, i, p, p, ll, i, p, p, p]
    lib.segment_sum_bag.restype = i
    lib.segment_sum_scratch.argtypes = [ll, i]
    lib.segment_sum_scratch.restype = ll
    return lib


def scratch_bytes(t: int, w: int) -> int:
    """Bytes of scratch the kernel takes for ``t`` sorted rows of ``w``
    columns: the long segments' float64 parts (one row of ``w`` a chunk of
    64 positions), the combine's work list and its tickets."""
    return _library().segment_sum_scratch(t, w)


def _check(grad, ids, n, t=None):
    """Raise on what the kernel does not take: a float32 contiguous
    (rows, w) gradient with w >= 1, int32 or int64 ids (t,) on its device
    (t = rows unless given), and n < 2^31."""
    t = grad.shape[0] if t is None else t
    if grad.ndim != 2 or grad.shape[1] < 1:
        raise ValueError(f"grad must be (T, w) with w >= 1, got "
                         f"{tuple(grad.shape)}")
    if grad.dtype != torch.float32:
        raise TypeError(f"grad: expected torch.float32, got {grad.dtype}")
    if not grad.is_contiguous():
        raise ValueError("grad must be contiguous")
    if ids.device != grad.device:
        raise ValueError(f"ids lie on {ids.device}, grad on {grad.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids: expected int32 or int64, got {ids.dtype}")
    if tuple(ids.shape) != (t,):
        raise ValueError(f"ids: expected shape ({t},), got "
                         f"{tuple(ids.shape)}")
    if not 0 <= n <= MAX_N:
        raise ValueError(f"n={n} outside the kernel's 0..{MAX_N}")


def _check_bag(g, ids, weights):
    """Raise on what the bag form does not take: weights (B, L) float32 on
    g's device, g (B, w), ids of B·L entries, B·L < 2^32."""
    if weights.ndim != 2 or weights.shape[0] != g.shape[0]:
        raise ValueError(f"bag_weights must be (B, L) with B = {g.shape[0]}, "
                         f"got {tuple(weights.shape)}")
    if weights.dtype != torch.float32:
        raise TypeError(f"bag_weights: expected torch.float32, got "
                        f"{weights.dtype}")
    if weights.device != g.device:
        raise ValueError(f"bag_weights lie on {weights.device}, grad on "
                         f"{g.device}")
    if weights.numel() >= 2 ** 32:
        raise ValueError(f"{weights.numel()} slots; the bag form takes "
                         f"fewer than 2^32")
    if ids.numel() != weights.numel():
        raise ValueError(f"ids: expected {weights.numel()} entries, got "
                         f"{ids.numel()}")


def segment_sum(grad: torch.Tensor, ids: torch.Tensor, n: int, *,
                bag_weights: torch.Tensor | None = None) -> torch.Tensor:
    """(n, w) float32: row i is the sum of the rows of ``grad`` (T, w) whose
    id is i, 0 where there is none; summed in float64, rounded once. With
    ``bag_weights`` (B, L), ``grad`` is (B, w), ``ids`` holds B·L entries
    and the rows summed are ``grad[b] * bag_weights[b, j]``."""
    if _region.WALK is not None or grad.is_meta:
        return _region.run("segment_sum", segment_sum, (grad, ids, n),
                           {"bag_weights": bag_weights}, meta=grad.is_meta,
                           shape=_shape, cost=cost)
    if bag_weights is not None:
        ids = ids.reshape(-1)
        _check_bag(grad, ids, bag_weights)
    if grad.device.type == "cpu":
        if bag_weights is not None:
            grad = (grad[:, None, :] * bag_weights[..., None]).reshape(
                -1, grad.shape[-1])
        return segment_sum_ref(grad, ids, n)
    if grad.device.type != "cuda":
        raise ValueError(f"segment_sum runs on CUDA or the CPU, not on "
                         f"{grad.device}")
    t = grad.shape[0] if bag_weights is None else bag_weights.numel()
    _check(grad, ids, n, t)
    w = grad.shape[1]
    out = torch.zeros((n, w), dtype=torch.float32, device=grad.device)
    if t == 0:
        return out
    sorted_ids, order = torch.sort(ids.to(torch.int32), stable=True)
    lib = _library()
    # float64 elements: the parts come first in it, 8-byte aligned
    scratch = torch.empty((-(-lib.segment_sum_scratch(t, w) // 8),),
                          dtype=torch.float64, device=grad.device)  # staticcheck: ignore[RL404]
    dev = grad.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bag_weights is None:
            err = lib.segment_sum(
                grad.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(), t,
                w, out.data_ptr(), scratch.data_ptr(), stream)
        else:
            weights = bag_weights.contiguous()
            err = lib.segment_sum_bag(
                grad.data_ptr(), weights.data_ptr(), weights.shape[1],
                sorted_ids.data_ptr(), order.data_ptr(), t, w, out.data_ptr(),
                scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def _shape(grad, ids, n, *, bag_weights=None):
    return torch.zeros((n, grad.shape[-1]), dtype=torch.float32,
                       device=grad.device)


def cost(grad, ids, n, *, bag_weights=None) -> dict:
    """The sum from shapes: every summed row read once with its id (and
    its bag weight), one add an element; the (n, w) result written once."""
    w = grad.shape[-1]
    t = ids.numel()
    return {"flops": (1 if bag_weights is None else 2) * t * w,
            "bytes": _region.nbytes(ids, bag_weights) + 4 * t * w
            + 4 * n * w}


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n, ctx.dtype = table.shape[0], table.dtype
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum(g.to(torch.float32).contiguous(), ids,
                           ctx.n).to(ctx.dtype), None


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for 1-D ids (T,) -> (T, w), differentiable in the
    table: its gradient is ``segment_sum`` of the cotangent in float32,
    rounded once to the table's type (bf16 rows gather as they are)."""
    return _Gather.apply(table, ids)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, n):
        ctx.save_for_backward(seg)
        return segment_sum(x.contiguous(), seg, n)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return g.index_select(0, seg), None, None


def scatter_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """(n, w): row i is the sum of the rows of ``x`` (T, w) whose segment id
    ``seg`` (T,) is i, 0 where there is none (``segment_sum``); its gradient
    in ``x`` is the gather ``g[seg]``."""
    return _ScatterSum.apply(x, seg, n)
