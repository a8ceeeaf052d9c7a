"""Public wrapper of the packed lookup: the CUDA kernel for tensors on the
card, the plain version (``ref.py``) for tensors on the CPU.

On a CUDA tensor the wrapper launches ``csrc/mpe_lookup.cu`` or raises; there
is no fallback. ``packed_lookup.launches`` counts kernel launches, and only
those.

The kernel's launch descriptor (``Plan``: each width bucket's subtable,
rows, bits and words per row, and the table's index, α and β tensors) is
built and checked once per table by ``lookup_plan`` and cached. The cache
key holds the ``data_ptr`` and ``_version`` of ``width_idx``, ``local_idx``,
every subtable, α and β, so a table whose tensors are replaced or written
in place gets a new descriptor. A descriptor holds weak references to its
tensors and leaves the cache when any of them is freed: it keeps no table
alive, and a new tensor at a freed one's address finds no descriptor. A
call then checks the ids and makes one ctypes call.

Under an op walk the call is one region (``repro_torch.kernels.region``)
with ``lookup_cost``; on meta ids it returns an empty (*ids.shape, d).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch

from repro_torch.core.packing import words_per_row
from repro_torch.device import on_card, raw_stream
from repro_torch.kernels import region as _region
from repro_torch.kernels.build import load_library
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref

MAX_BUCKETS = 16  # kMaxBuckets in csrc/mpe_lookup.cu
MAX_BITS = 31
MAX_PLANS = 64    # descriptors cached at once; the oldest goes first


class _Plan(ctypes.Structure):
    """Mirror of ``struct Plan`` in ``csrc/mpe_lookup.cu``."""
    _fields_ = [("words", ctypes.c_void_p * MAX_BUCKETS),
                ("width_idx", ctypes.c_void_p),
                ("local_idx", ctypes.c_void_p),
                ("alpha", ctypes.c_void_p),
                ("beta", ctypes.c_void_p),
                ("rows", ctypes.c_int * MAX_BUCKETS),
                ("bits", ctypes.c_int * MAX_BUCKETS),
                ("wpr", ctypes.c_int * MAX_BUCKETS),
                ("n_buckets", ctypes.c_int),
                ("n_table", ctypes.c_int),
                ("d", ctypes.c_int),
                ("max_words", ctypes.c_int),
                ("max_bits", ctypes.c_int)]


@dataclass
class LookupPlan:
    """A checked launch descriptor of one packed table: per width bucket
    its code width, padded rows and words per row (0, 0, 0 for a dropped
    width), and the C struct the kernel takes."""
    d: int
    n_table: int
    bits: tuple
    rows: tuple
    words_per_row: tuple
    c_plan: _Plan
    tensors: tuple = ()  # weak references to the tensors it was built from

    @property
    def c_address(self) -> int:
        return ctypes.addressof(self.c_plan)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library("mpe_lookup")
    if lib.mpe_lookup_plan_bytes() != ctypes.sizeof(_Plan):
        raise RuntimeError("csrc/mpe_lookup.cu's Plan and _Plan differ in size")
    fn = lib.mpe_lookup
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_longlong, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if not torch.is_tensor(t):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} lies on {t.device}, the ids on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _table_tensors(table) -> tuple:
    """The tensors a plan reads, in a fixed order."""
    return (table["width_idx"], table["local_idx"], table["alpha"],
            table["beta"], *table["subtables"].values())


def lookup_plan(table, meta, device) -> LookupPlan:
    """Check ``table`` for the kernel on ``device`` and build its launch
    descriptor. Raises on what the kernel does not take."""
    bits, d = tuple(int(b) for b in meta["bits"]), int(meta["d"])
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = int(table["width_idx"].shape[0])
    if not 1 <= len(bits) <= MAX_BUCKETS:
        raise ValueError(f"{len(bits)} width buckets; the kernel takes 1.."
                         f"{MAX_BUCKETS}")
    if not 1 <= n <= 2 ** 31 - 1:
        raise ValueError(f"{n} features; the kernel takes 1..2^31 - 1")
    _check(table["width_idx"], "width_idx", torch.int32, (n,), device)
    _check(table["local_idx"], "local_idx", torch.int32, (n,), device)
    _check(table["alpha"], "alpha", torch.float32, (len(bits),), device)
    _check(table["beta"], "beta", torch.float32, (d,), device)
    c = _Plan()
    rows, wprs = [], []
    for i, b in enumerate(bits):
        if b == 0:
            rows.append(0)
            wprs.append(0)
            continue
        if not 1 <= b <= MAX_BITS:
            raise ValueError(f"code width {b} outside the kernel's 1.."
                             f"{MAX_BITS}")
        sub = table["subtables"][f"b{b}"]
        if sub.ndim != 2 or sub.shape[0] < 1:
            raise ValueError(f"subtable b{b} must be a non-empty 2-D tensor")
        wpr = words_per_row(d, b)
        _check(sub, f"subtable b{b}", torch.int32, (sub.shape[0], wpr), device)
        if sub.shape[0] > 2 ** 31 - 1:
            raise ValueError(f"subtable b{b}: {sub.shape[0]} rows; the kernel "
                             f"takes at most 2^31 - 1")
        c.words[i] = sub.data_ptr()
        rows.append(int(sub.shape[0]))
        wprs.append(wpr)
    for i, (b, r, w) in enumerate(zip(bits, rows, wprs)):
        c.bits[i], c.rows[i], c.wpr[i] = b, r, w
    c.width_idx = table["width_idx"].data_ptr()
    c.local_idx = table["local_idx"].data_ptr()
    c.alpha = table["alpha"].data_ptr()
    c.beta = table["beta"].data_ptr()
    c.n_buckets, c.n_table, c.d = len(bits), n, d
    c.max_words, c.max_bits = max(wprs), max(bits)
    return LookupPlan(d=d, n_table=n, bits=bits,
                      rows=tuple(rows), words_per_row=tuple(wprs), c_plan=c)


_PLANS: dict = {}


def cached_plan(table, meta, device) -> LookupPlan:
    """``lookup_plan``, built once per table and state: served from the
    cache while the table holds tensors at the same ``data_ptr`` and
    ``_version``; dropped from it when one of them is freed."""
    tensors = _table_tensors(table)
    key = (meta["d"], tuple(meta["bits"]), device,
           *[t.data_ptr() for t in tensors], *[t._version for t in tensors])
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    plan = lookup_plan(table, meta, device)

    def drop(_, key=key):
        _PLANS.pop(key, None)
    plan.tensors = tuple(weakref.ref(t, drop) for t in tensors)
    if len(_PLANS) >= MAX_PLANS:
        del _PLANS[next(iter(_PLANS))]
    _PLANS[key] = plan
    return plan


def _launch(table, meta, ids: torch.Tensor) -> torch.Tensor:
    dev = ids.device
    if ids.dtype != torch.int32:
        raise TypeError(f"ids: expected torch.int32, got {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    plan = cached_plan(table, meta, dev)
    n = ids.numel()
    out = torch.empty((n, plan.d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with on_card(dev):  # a small request's time is this call's host time
        err = _kernel()(plan.c_address, ids.data_ptr(), n, out.data_ptr(),
                        raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"mpe_lookup kernel launch failed: CUDA error {err}")
    packed_lookup.launches += 1
    return out


def packed_lookup(table, meta, ids: torch.Tensor) -> torch.Tensor:
    """ids: global feature ids of any shape -> (*ids.shape, d) float32."""
    if _region.WALK is not None or ids.is_meta:
        return _region.run("mpe_lookup", packed_lookup, (table, meta, ids),
                           meta=ids.is_meta, shape=_lookup_shape,
                           cost=lookup_cost)
    flat = ids if ids.ndim == 1 else ids.reshape(-1)  # a reshape costs ~2 us
    if flat.is_cuda:
        out = _launch(table, meta, flat)
    elif flat.device.type == "cpu":
        out = packed_lookup_ref(table, meta, flat)
    else:
        raise ValueError(f"packed_lookup runs on CUDA or the CPU, not on "
                         f"{flat.device}")
    return out if ids.ndim == 1 else out.reshape(*ids.shape, meta["d"])


packed_lookup.launches = 0

# the reference's name; its ``interpret=`` (the Pallas interpreter) is not
# taken: a CUDA tensor takes the kernel, a CPU tensor its plain version
packed_lookup_kernel = packed_lookup


def _lookup_shape(table, meta, ids):
    return torch.empty((*ids.shape, int(meta["d"])), dtype=torch.float32,
                       device=ids.device)


def lookup_cost(table, meta, ids) -> dict:
    """The lookup's analytic cost from shapes: each id reads its width and
    row index and at most the widest bucket's words, writes d floats; the
    dequant is a multiply-add an element."""
    n, d = ids.numel(), int(meta["d"])
    bits = [int(b) for b in meta["bits"] if b]
    wmax = max((words_per_row(d, b) for b in bits), default=0)
    return {"flops": 2 * n * d,
            "bytes": n * (ids.element_size() + 8 + 4 * wmax + 4 * d)
            + 4 * (len(meta["bits"]) + d)}


def packed_lookup_kernel_sharded(table, meta, ids, *, rows_axes=("model",),
                                 mesh=None, lookup_comms: str = "psum",
                                 bucket_capacity: int | None = None):
    """The lookup on a mesh: subtables row-sharded over ``rows_axes``, this
    wrapper gathering each rank's owned rows, one ``all_reduce`` merging
    them — or, with ``lookup_comms="a2a"``, the capacity-bucketed
    all-to-all that ships packed words (bit-exact either way). Takes the
    single-device lookup when no mesh of more than one rank is active (see
    ``repro_torch.dist.shard``)."""
    from repro_torch.dist.shard import sharded_packed_lookup
    return sharded_packed_lookup(table, meta, ids, rows_axes=rows_axes,
                                 mesh=mesh, lookup_comms=lookup_comms,
                                 bucket_capacity=bucket_capacity)
