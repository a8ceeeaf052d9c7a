"""The sharded kernels and the sharded train step on ``torch.distributed``.

The port of the reference's ``repro.dist.shard``. The reference places a
kernel on the mesh with ``shard_map``: each device runs the body on its
block and every cross-device byte is an explicit collective. The port runs
one process per device (SPMD): every rank holds the same inputs, cuts its
own block, runs the same body — the hand-written kernel on a card — and
joins the blocks with the same collectives, on the process groups of the
``Mesh``:

  ``psum``        ``all_reduce(SUM)`` on the axes' group;
  ``all_to_all``  ``all_to_all_single`` with equal splits;
  ``all_gather``  ``all_gather_into_tensor`` (tiled);
  ``pmean``       ``all_reduce`` divided by the group's size;
  ``axis_index``  the rank's coordinate (``Mesh.axis_index``).

A wrapper returns on every rank the whole result the reference's caller
sees: the full (batch, d), all-gathered over the data axes. Each wrapper is
its collectives around a **local body**, a plain function of the rank's
local tensors, its shard index and the shard count
(``packed_lookup_local``, the a2a phases, ``bag_partial``, ...). The
lookups take their collectives from an exchange: the process groups of a
``Mesh``, or — on a ``LocalMesh`` — every rank's body run in turn in one
process, each collective replaced by what it computes (the sum of the
ranks' terms, the exchange of their slots, the concatenation of their
blocks). The card, which runs one rank, checks the lookups' whole
orchestration that way.

Placement per wrapper:

  ``sharded_packed_lookup``    subtables row-sharded over ``rows_axes``
                               ("model"), ids batch-sharded over the other
                               axes. ``lookup_comms="psum"`` gathers the
                               owned rows through the lookup kernel with an
                               ownership mask and merges with ONE
                               ``all_reduce`` over the row axes — each id
                               has one non-zero term, so the sum is exact.
                               ``"a2a"`` ships the packed words: the
                               capacity-bucketed ids go to their owners by
                               ``all_to_all``, the owner gathers the words,
                               a second ``all_to_all`` returns them, an
                               ``all_gather`` rebuilds the slice's words and
                               ids that overflowed a bucket merge through
                               one masked **integer** ``all_reduce`` (one
                               non-zero term: the bits are kept); the
                               requester dequantizes with the kernel.
                               Bit-exact at any capacity.
  ``sharded_tiered_hot_lookup``  the same two paths over a tiered store's
                               hot tier: the hot bit is part of the
                               ownership mask, cold positions stay zero.
  ``sharded_embedding_bag``    table rows over ``rows_axes``, bags over the
                               other axes; partial bags from the bag kernel
                               + ``all_reduce``. Its backward is the segment
                               sum's bag form into the local row block,
                               ``all_reduce``-d over the batch axes only
                               when the bags are split, then all-gathered
                               to the whole table's gradient. NOT bit-exact
                               for > 1 row shard (the sum reassociates).
  ``sharded_flash_attention``  batch over the data axes, heads over
                               "model"; no collective but the gathers of
                               the outputs; bit-exact.
  ``sharded_mixed_expectation`` rows over every axis; bit-exact forward.
  ``sharded_value_and_grad``   the train step's gradient: batch
                               data-parallel, embedding leaves held as
                               local row shards and all-gathered in the
                               forward, so their gradient comes back
                               reduce-scattered; replicated leaves are
                               averaged over the mesh.

Tables whose rows don't divide the row axes are padded (``local_row_block``
pads the last shard's block with zero rows, which no real id owns). A
lookup over a whole table cuts the rank's blocks on every call (a copy
where the rows don't divide); ``place_table_rows`` cuts them once, and a
lookup called with ``row_blocks=True`` reads them as they are — what the
serving engine binds on a mesh of more than one rank.

Every rank must make the same calls in the same order (SPMD), as the
collectives of one group are matched by their order.

Under an op walk (``repro_torch.analysis.op_walk``) each collective is
recorded where it is issued — ``psum``, ``all_gather``, ``all_to_all``,
the reduce-scatter of ``_GatherRows`` and the sums and exchanges of a
``LocalMesh`` — with its axes and the bytes it leaves on a device; each
sharded wrapper opens a scope naming the axes its operands are split over
(``repro_torch.kernels.region``), so the analysis can check that those
axes are merged by a collective inside it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import packing
from repro_torch.dist.mesh import current_mesh
from repro_torch.dist.sharding import recsys_table_pspecs
from repro_torch.kernels import region as _region
from repro_torch.kernels.mpe_lookup.ops import packed_lookup
from repro_torch.train.tree import leaves, unflatten

# the tiled gather and the reduce-scatter under their current names (the
# older ``*_into_tensor``/``*_tensor`` names warn from torch 2.13 on)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

__all__ = [
    "active_mesh", "pad_rows_to_shard", "rows_shard_index",
    "local_row_block", "place_table_rows", "LocalMesh", "DryMesh",
    "LOOKUP_COMMS",
    "BucketPlan", "plan_buckets", "spill_capacity", "lookup_route_stats",
    "packed_lookup_local",
    "sharded_packed_lookup", "sharded_tiered_hot_lookup",
    "sharded_embedding_bag", "sharded_flash_attention",
    "sharded_mixed_expectation", "sharded_value_and_grad",
    "sharded_clip_scale",
]


# ---------------------------------------------------------------------------
# mesh plumbing and collectives
# ---------------------------------------------------------------------------

def active_mesh(mesh=None):
    """``mesh`` or the registry's current mesh — None when sharding is a
    no-op (no mesh, or a one-rank mesh)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.size <= 1:
        return None
    return mesh


def _present_axes(mesh, axes) -> tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.shape)


def _dp_axes_of(mesh, rows_axes) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a not in rows_axes)


def _batch_entry(mesh, dim: int, axes) -> tuple[str, ...] | None:
    """The axes a batch dim splits over: ``axes`` when they divide it, else
    None (replicated)."""
    if axes and dim % mesh.axes_size(axes) == 0:
        return tuple(axes)
    return None


def _block(x, mesh, axes, dim: int = 0):
    """This rank's block of ``x`` along ``dim`` split over ``axes``."""
    if not axes:
        return x
    n = x.shape[dim] // mesh.axes_size(axes)
    return x.narrow(dim, mesh.axis_index(axes) * n, n)


def _issue(kind: str, axes, group, out, op):
    """Issue one collective of ``kind`` over ``axes``, ``op`` filling
    ``out`` through ``group``, and record the bytes it leaves on the rank.
    A ``DryGroup`` has no peer: ``op`` is not called and ``out`` (the
    result's shape, unfilled) is returned as it is."""
    if not isinstance(group, DryGroup):
        op()
    _region.collective(kind, axes, _region.nbytes(out))
    return out


def psum(x, mesh, axes):
    """``all_reduce(SUM)`` of ``x`` over ``axes`` (a new tensor)."""
    group = mesh.group(axes) if axes else None
    if group is None:
        return x
    x = x.contiguous().clone()
    return _issue("all-reduce", axes, group, x,
                  lambda: dist.all_reduce(x, group=group))


def all_gather(x, mesh, axes, dim: int = 0):
    """The tiled ``all_gather``: the blocks of every rank along ``axes``,
    concatenated along ``dim`` in the axes' row-major order."""
    group = mesh.group(axes) if axes else None
    if group is None:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((mesh.axes_size(axes) * xs.shape[0], *xs.shape[1:]))
    return _issue("all-gather", axes, group, out,
                  lambda: _ALL_GATHER(out, xs, group=group)).movedim(0, dim)


def all_to_all(x, mesh, axes):
    """``all_to_all`` of (n_shards, ...) ``x`` over ``axes``: slot s goes to
    shard s, and slot r of the result came from shard r."""
    group = mesh.group(axes) if axes else None
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    return _issue("all-to-all", axes, group, out,
                  lambda: dist.all_to_all_single(out, x, group=group))


class LocalMesh:
    """A (data, model) mesh whose every rank runs in this process, one
    after another. The sharded lookups on it run each rank's body in turn
    and replace each collective by what it computes, so they return what a
    mesh of this shape returns, on one device, through every line of the
    wrappers but the collectives themselves."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int = 1, n_model: int = 1):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.size = self.shape["data"] * self.shape["model"]

    def axes_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape})"


class DryMesh:
    """The production mesh as one rank sees it in a dry run: the axes and
    their sizes (16×16, or 2×16×16 across pods) and this rank's
    coordinates, with no process group. Its groups are ``DryGroup``s, on
    which ``_issue`` skips the transfer: each collective of this module
    returns an empty result of the shape the real one returns (on the meta
    device for meta inputs) and records the bytes it leaves on the rank,
    so every sharded wrapper — the lookups,
    the bag, flash, ``mpe_qat``, ``sharded_value_and_grad`` — runs its
    local body on the rank's blocks without a peer."""

    def __init__(self, shape, axis_names, rank: int = 0):
        shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        self.rank = int(rank)
        self.device_type = "meta"
        self.coordinate = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, shape))))

    def axes_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def axis_index(self, axes) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes):
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        return DryGroup(axes) if self.axes_size(axes) > 1 else None

    def __repr__(self) -> str:
        return f"DryMesh({self.shape}, rank={self.rank})"


class DryGroup(NamedTuple):
    """The group of ``axes`` on a ``DryMesh``: no peer, no transfer."""
    axes: tuple


class _GroupExchange:
    """The collectives of ``axes`` on a ``Mesh``: this rank runs one
    shard, its index along the axes. Each method takes the list of the
    shards' terms this process holds (one here)."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, axes
        self.n = mesh.axes_size(axes)
        self.shards = (mesh.axis_index(axes),)

    def psum(self, xs):
        return psum(xs[0], self.mesh, self.axes)

    def all_to_all(self, xs):
        return [all_to_all(xs[0], self.mesh, self.axes)]

    def all_gather(self, xs):
        return all_gather(xs[0], self.mesh, self.axes)


class _LocalExchange:
    """The collectives of ``n`` shards along ``axes`` that all run in this
    process: the sum of their terms in shard order, the exchange of their
    slots, the concatenation of their blocks. An op walk records each as
    the collective it stands for, with the bytes it leaves on one
    device."""

    def __init__(self, n: int, axes=()):
        self.n = n
        self.axes = tuple(axes)
        self.shards = tuple(range(n))

    def _record(self, kind, out):
        if self.n > 1:
            _region.collective(kind, self.axes, _region.nbytes(out))

    def psum(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        self._record("all-reduce", out)
        return out

    def all_to_all(self, xs):
        out = list(torch.stack(xs).transpose(0, 1))
        self._record("all-to-all", out[0])
        return out

    def all_gather(self, xs):
        out = torch.cat(xs) if len(xs) > 1 else xs[0]
        self._record("all-gather", out)
        return out


def _exchange(mesh, axes):
    """The exchange of ``axes`` (None or () for none: one shard); on a
    ``DryMesh`` the group exchange, whose collectives are dry (the dry
    run's third exchange)."""
    if not axes:
        return _LocalExchange(1)
    if isinstance(mesh, LocalMesh):
        return _LocalExchange(mesh.axes_size(axes), axes)
    return _GroupExchange(mesh, axes)


def pad_rows_to_shard(x, n_shards: int):
    """Pad dim 0 up to a multiple of ``n_shards`` with zeros (the
    pad-to-shard path for tables whose rows don't divide the row axes).
    Zero packed words decode to the most-negative code, but pad rows are
    never owned by a real id, so no result can read them."""
    pad = (-x.shape[0]) % n_shards
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def local_row_block(x, shard: int, n_shards: int):
    """Shard ``shard``'s row block of ``x`` padded to a multiple of
    ``n_shards`` rows (``pad_rows_to_shard(x, n_shards)``'s block): a view
    of ``x`` where the block lies inside it, else a copy ending in zero
    rows."""
    rows = -(-x.shape[0] // n_shards)
    lo = shard * rows
    if lo + rows <= x.shape[0]:
        return x[lo:lo + rows]
    block = x.new_zeros((rows, *x.shape[1:]))
    if lo < x.shape[0]:
        block[:x.shape[0] - lo] = x[lo:]
    return block


def place_table_rows(table, mesh, rows_axes=("model",)):
    """The packed ``table`` as this rank serves it on ``mesh``: each
    subtable replaced by this rank's row block of the table padded to the
    row shards (``local_row_block``: a view, or a copy ending in zero
    rows); the width index, local index and scales whole. The sharded
    lookups read it with ``row_blocks=True``, so no call cuts or copies a
    block."""
    rows_ax = _present_axes(mesh, rows_axes)
    mp, me = mesh.axes_size(rows_ax), mesh.axis_index(rows_ax)
    return {**table, "subtables": {k: local_row_block(v, me, mp)
                                   for k, v in table["subtables"].items()}}


def rows_shard_index(mesh, rows_axes) -> int:
    """Linear shard index of this rank along ``rows_axes`` (row-major over
    the axes tuple, the layout of a ``P((a, b), ...)`` dim)."""
    return mesh.axis_index(rows_axes)


# ---------------------------------------------------------------------------
# capacity-bucketed all-to-all routing plan
# ---------------------------------------------------------------------------

#: Comms paths for the sharded lookups: "psum" merges dequantized partials
#: with one float all_reduce; "a2a" ships the packed words through two
#: all_to_alls (+ an integer spill all_reduce) and dequantizes on the
#: requesting shard.
LOOKUP_COMMS = ("psum", "a2a")


def _check_comms(lookup_comms: str):
    if lookup_comms not in LOOKUP_COMMS:
        raise ValueError(f"lookup_comms must be one of {LOOKUP_COMMS}, "
                         f"got {lookup_comms!r}")


class BucketPlan(NamedTuple):
    """Static-shape routing plan for the capacity-bucketed all-to-all.

    ``slot``/``in_bucket``/``spilled`` share ``owner``'s shape, the last
    axis enumerating the ids of one batch slice: ``slot`` is the flat
    position in the (n_shards × capacity) send buffer (``owner * capacity
    + rank`` within the (slice, owner) bucket); ``in_bucket`` marks ids
    that fit under the capacity; ``spilled`` marks valid ids that
    overflowed — they merge through the integer spill ``all_reduce``, none
    is dropped. ``counts`` replaces the id axis with an ``n_shards`` axis:
    the total per-bucket demand. The plan is a pure function of ``(owner,
    valid)``, so every rank derives the identical plan — which is what
    lets the spill write each overflow row from exactly one owner."""
    slot: torch.Tensor
    in_bucket: torch.Tensor
    spilled: torch.Tensor
    counts: torch.Tensor


def plan_buckets(owner, valid, *, n_shards: int, capacity: int) -> BucketPlan:
    """Plan per-destination-shard buckets under a static ``capacity``.

    ``owner[..., j]`` is the shard that holds id j's row; ``valid`` masks
    the ids that take part (batch padding and zero-width or cold ids
    don't). Rank within a bucket is the id's order of appearance in its
    slice, so the plan — and so which ids spill — is deterministic."""
    owner = torch.as_tensor(owner).to(torch.int32)
    valid = torch.as_tensor(valid).to(torch.bool)
    oc = owner.clamp(0, n_shards - 1)
    onehot = (oc[..., None] == torch.arange(n_shards, dtype=torch.int32,
                                            device=oc.device)) \
        & valid[..., None]
    cum = torch.cumsum(onehot.to(torch.int32), dim=-2, dtype=torch.int32)
    rank = torch.gather(cum, -1, oc[..., None].long())[..., 0] - 1
    in_bucket = valid & (rank < capacity)
    return BucketPlan(slot=(oc * capacity + rank).to(torch.int32),
                      in_bucket=in_bucket,
                      spilled=valid & ~in_bucket,
                      counts=onehot.sum(dim=-2, dtype=torch.int32))


def spill_capacity(slice_len: int, capacity: int, n_shards: int) -> int:
    """Static row count of the overflow spill buffer.

    One slice of ``slice_len`` ids spills at most ``slice_len - capacity``:
    summing ``max(0, count_o - capacity)`` over the owners with overflow
    gives ``sum(count_o) - |overflowing| * capacity <= slice_len -
    capacity``. ``n_shards`` slices therefore always fit."""
    return n_shards * max(0, slice_len - capacity)


def _cap_slice(batch: int, n_shards: int, capacity) -> tuple[int, int]:
    """(slice_len, clamped capacity): each of the ``n_shards`` batch slices
    holds ``ceil(batch / n_shards)`` ids; a capacity of None (or anything
    >= slice_len) makes the plan spill-free."""
    slice_len = -(-batch // n_shards)
    if capacity is None:
        return slice_len, slice_len
    return slice_len, max(1, min(int(capacity), slice_len))


class A2APlan(NamedTuple):
    """Everything the a2a phases share: the padded ids' width buckets and
    local rows, which ids are routed, the bucket plan and its sizes. Every
    rank of a row group derives the same one (``a2a_plan``)."""
    widx: torch.Tensor        # (bp,) width bucket of each padded id
    lidx: torch.Tensor        # (bp,) row within its bucket
    route: torch.Tensor       # (bp,) the ids that are routed
    ids: torch.Tensor         # (bp,) the padded ids
    buckets: BucketPlan       # over (n_shards, slice_len)
    batch: int
    slice_len: int
    capacity: int
    n_spill: int
    n_words: int


def _rows_loc(subs, bits, n_shards: int, padded: bool) -> list[int]:
    """Each width's rows a shard holds (1 for a zero width): the subtables
    are local blocks when ``padded``, else whole subtables."""
    out = []
    for b in bits:
        if b == 0:
            out.append(1)
            continue
        rows = subs[f"b{b}"].shape[0]
        out.append(rows if padded else -(-rows // n_shards))
    return out


def a2a_plan(ids, local_idx, width_idx, rows_loc, bits, d: int, *,
             n_shards: int, capacity, ok_vec=None) -> A2APlan:
    """The replicated routing plan of one slice of ``ids`` (the data
    block): ids padded to ``n_shards`` slices, each id's owner (its row //
    the shard's rows), and the bucket plan under ``capacity``. ``ok_vec``
    (per feature) further selects the ids that are routed (the tiered hot
    bit)."""
    batch = ids.shape[0]
    slice_len, cap = _cap_slice(batch, n_shards, capacity)
    bp = n_shards * slice_len
    dev = ids.device
    fl_p = torch.cat([ids, ids.new_zeros(bp - batch)]).long()
    widx = width_idx[fl_p]
    lidx = local_idx[fl_p]
    nz = torch.tensor([b != 0 for b in bits], device=dev)
    route = (torch.arange(bp, device=dev) < batch) & nz[widx.long()]
    if ok_vec is not None:
        route = route & ok_vec[fl_p]
    rows_vec = torch.tensor(rows_loc, dtype=torch.int32, device=dev)
    owner = torch.clamp(torch.div(lidx, rows_vec[widx.long()],
                                  rounding_mode="floor"), 0, n_shards - 1)
    plan = plan_buckets(owner.reshape(n_shards, slice_len),
                        route.reshape(n_shards, slice_len),
                        n_shards=n_shards, capacity=cap)
    n_words = max(packing.words_per_row(d, b) for b in bits if b)
    return A2APlan(widx=widx, lidx=lidx, route=route, ids=fl_p,
                   buckets=plan, batch=batch, slice_len=slice_len,
                   capacity=cap, n_spill=spill_capacity(slice_len, cap,
                                                         n_shards),
                   n_words=n_words)


def route_words(subs, bits, widx, lidx, shard: int, n_words: int,
                mask=None):
    """Packed words of the rows among ``(widx, lidx)`` that shard ``shard``
    owns in its local blocks ``subs``, zero-padded to ``n_words`` columns
    → (words, owned). Positions it doesn't own (or ``mask`` excludes)
    stay zero."""
    n = widx.shape[0]
    words = torch.zeros((n, n_words), dtype=torch.int32, device=widx.device)
    owned = torch.zeros((n,), dtype=torch.bool, device=widx.device)
    for i, b in enumerate(bits):
        if b == 0:
            continue
        sub = subs[f"b{b}"]
        rows_loc = sub.shape[0]
        loc = lidx.long() - shard * rows_loc
        own = (widx == i) & (loc >= 0) & (loc < rows_loc)
        if mask is not None:
            own = own & mask
        w = sub[loc.clamp(0, rows_loc - 1)]
        w = torch.nn.functional.pad(w, (0, n_words - w.shape[1]))
        words = torch.where(own[:, None], w, words)
        owned = owned | own
    return words, owned


def a2a_send(plan: A2APlan, shard: int) -> torch.Tensor:
    """Shard ``shard``'s send buffer (n_shards, capacity): the ids of its
    batch slice in their buckets; pad slots carry id 0 and are never
    read."""
    n_shards = plan.buckets.slot.shape[0]
    lo = shard * plan.slice_len
    ids_me = plan.ids[lo:lo + plan.slice_len]
    inb = plan.buckets.in_bucket[shard]
    send = torch.zeros(n_shards * plan.capacity, dtype=torch.int32,
                       device=ids_me.device)
    send[plan.buckets.slot[shard][inb].long()] = ids_me[inb].to(torch.int32)
    return send.reshape(n_shards, plan.capacity)


def a2a_owner_words(recv, subs, bits, local_idx, width_idx, shard: int,
                    n_words: int) -> torch.Tensor:
    """The owner's gather: the packed words of the ids it received
    (n_shards, capacity) from its local blocks → (n_shards, capacity,
    n_words)."""
    flat = recv.reshape(-1).long()
    words, _ = route_words(subs, bits, width_idx[flat], local_idx[flat],
                           shard, n_words)
    return words.reshape(*recv.shape, n_words)


def a2a_collect(ret, plan: A2APlan, shard: int) -> torch.Tensor:
    """The requester's slice of words (slice_len, n_words) from the words
    returned to it (n_shards, capacity, n_words)."""
    n_slots = ret.shape[0] * ret.shape[1]
    ret = ret.reshape(n_slots, -1)
    slot = plan.buckets.slot[shard].long().clamp(0, n_slots - 1)
    return torch.where(plan.buckets.in_bucket[shard][:, None], ret[slot],
                       torch.zeros((), dtype=ret.dtype, device=ret.device))


def a2a_spill(plan: A2APlan, subs, bits, shard: int) -> torch.Tensor:
    """Shard ``shard``'s term of the spill buffer (n_spill, n_words): the
    words of the overflowed ids it owns at their spill rank, zeros
    elsewhere. The sum over shards has one non-zero term a row."""
    sp = plan.buckets.spilled.reshape(-1)
    sp_rank = torch.cumsum(sp.to(torch.int32), 0, dtype=torch.int32) - 1
    contrib, owned = route_words(subs, bits, plan.widx, plan.lidx, shard,
                                 plan.n_words, mask=sp)
    buf = torch.zeros((plan.n_spill, plan.n_words), dtype=torch.int32,
                      device=sp.device)
    buf[sp_rank[owned].long()] = contrib[owned]
    return buf


def a2a_merge_spill(full, buf, plan: A2APlan) -> torch.Tensor:
    """The slices' words with the spilled ids' rows taken from the summed
    spill buffer."""
    sp = plan.buckets.spilled.reshape(-1)
    sp_rank = torch.cumsum(sp.to(torch.int32), 0, dtype=torch.int32) - 1
    return torch.where(sp[:, None],
                       buf[sp_rank.long().clamp(0, plan.n_spill - 1)], full)


def a2a_dequant(full, plan: A2APlan, alpha, beta, bits, d: int
                ) -> torch.Tensor:
    """The requester's dequant of the slices' packed words (bp, n_words) →
    (batch, d): one lookup over a table whose subtables are the words'
    leading columns, routed ids at their width, the rest at width -1
    (the zero row)."""
    bp = full.shape[0]
    dev = full.device
    subs = {f"b{b}": full[:, :packing.words_per_row(d, b)].contiguous()
            for b in bits if b}
    table = {"subtables": subs,
             "width_idx": torch.where(plan.route, plan.widx,
                                      torch.full_like(plan.widx, -1)),
             "local_idx": torch.arange(bp, dtype=torch.int32, device=dev),
             "alpha": alpha, "beta": beta}
    rows = torch.arange(bp, dtype=torch.int32, device=dev)
    out = packed_lookup(table, {"bits": tuple(bits), "d": d}, rows)
    return out[:plan.batch]


def lookup_route_stats(table, meta, ids, *, n_shards: int,
                       bucket_capacity: int | None = None) -> dict:
    """Deterministic routing counters for the a2a path of one lookup: the
    same batch padding, owner derivation (over padded subtables) and
    capacity clamp as the body, so the numbers are reproducible metrics,
    not samples."""
    bits, d = tuple(meta["bits"]), int(meta["d"])
    flat = torch.as_tensor(ids).reshape(-1)
    plan = a2a_plan(flat, table["local_idx"], table["width_idx"],
                    _rows_loc(table["subtables"], bits, n_shards, False),
                    bits, d, n_shards=n_shards, capacity=bucket_capacity)
    n_slots = n_shards * n_shards * plan.capacity
    bucketed = int(plan.buckets.in_bucket.sum())
    return {
        "slice_len": plan.slice_len,
        "capacity": plan.capacity,
        "spill_cap": plan.n_spill,
        "routed": int(plan.route.sum()),
        "bucketed": bucketed,
        "spilled": int(plan.buckets.spilled.sum()),
        "bucket_demand_max": int(plan.buckets.counts.max()),
        "occupancy_pct": round(100.0 * bucketed / n_slots, 4),
    }


# ---------------------------------------------------------------------------
# packed-table lookup (kernels.mpe_lookup / core.inference)
# ---------------------------------------------------------------------------

def packed_lookup_local(subs, local_idx, width_idx, alpha, beta, ids, *,
                        bits, d: int, shard: int, ok_vec=None
                        ) -> torch.Tensor:
    """The psum path's local body: (n,) ids → (n, d), the rows shard
    ``shard`` owns in its local blocks ``subs`` dequantized, zeros
    elsewhere — one lookup (the kernel on a card) over a table of the
    local blocks whose width index is -1 (the zero row) at every id the
    shard doesn't own (or ``ok_vec`` deselects)."""
    ids = ids.long()
    widx = width_idx[ids]
    lidx = local_idx[ids].long()
    own = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    loc = torch.zeros_like(lidx)
    for i, b in enumerate(bits):
        if b == 0:
            continue
        rows_loc = subs[f"b{b}"].shape[0]
        here = (widx == i)
        li = lidx - shard * rows_loc
        mine = here & (li >= 0) & (li < rows_loc)
        own = own | mine
        loc = torch.where(here, li.clamp(0, rows_loc - 1), loc)
    if ok_vec is not None:
        own = own & ok_vec[ids]
    table = {"subtables": subs,
             "width_idx": torch.where(own, widx, torch.full_like(widx, -1)),
             "local_idx": loc.to(torch.int32), "alpha": alpha, "beta": beta}
    rows = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    return packed_lookup(table, {"bits": tuple(bits), "d": d}, rows)


def _lookup_rows(blocks, local_idx, width_idx, alpha, beta, fl, ex, *, bits,
                 d, lookup_comms, capacity, ok_vec=None):
    """One batch slice's lookup over the row shards of the exchange ``ex``
    (``blocks[s]``: shard s's local subtable blocks, for each shard s this
    process runs) → (n, d), the same on every shard.

    psum: each shard's masked local body, summed — one non-zero owner per
    id, so the sum adds zeros: exact. a2a (the capacity-bucketed
    all-to-all): the ids are the same on every row shard (they are split
    over the batch axes only), so shard s takes ownership of batch slice s
    and every shard derives the identical plan. Steps: (1) all_to_all the
    bucketed ids; (2) the owner gathers the packed words of its rows; (3)
    all_to_all the words back, collect each slice and all_gather every
    slice; (4) the overflowed ids merge through one masked integer psum of
    a ``spill_capacity``-row buffer — exact, each row has one writer; (5)
    the requester dequantizes through the lookup kernel. Same words, same
    unpack, same dequant: bit-exact against the psum path at any
    capacity. a2a gives way to psum at one row shard."""
    if lookup_comms != "a2a" or ex.n == 1 or not any(bits):
        return ex.psum([packed_lookup_local(
            blocks[s], local_idx, width_idx, alpha, beta, fl, bits=bits,
            d=d, shard=s, ok_vec=ok_vec) for s in ex.shards])
    plan = a2a_plan(fl, local_idx, width_idx,
                    _rows_loc(blocks[ex.shards[0]], bits, ex.n, True), bits,
                    d, n_shards=ex.n, capacity=capacity, ok_vec=ok_vec)
    recv = ex.all_to_all([a2a_send(plan, s) for s in ex.shards])
    words = ex.all_to_all([
        a2a_owner_words(r, blocks[s], bits, local_idx, width_idx, s,
                        plan.n_words) for s, r in zip(ex.shards, recv)])
    # the merge: the slices gathered, the spilled rows summed
    _region.merged_by(("all-gather", ex.axes),
                      *((("all-reduce", ex.axes),) if plan.n_spill else ()))
    full = ex.all_gather([a2a_collect(r, plan, s)
                          for s, r in zip(ex.shards, words)])
    if plan.n_spill > 0:
        buf = ex.psum([a2a_spill(plan, blocks[s], bits, s)
                       for s in ex.shards])
        full = a2a_merge_spill(full, buf, plan)
    return a2a_dequant(full, plan, alpha, beta, bits, d)


def _sharded_lookup(table, lidx_key, bits, d, ids, *, mesh, rows_axes,
                    lookup_comms, bucket_capacity, row_blocks=False,
                    ok_key=None):
    """The lookups' orchestration on ``mesh`` (a ``Mesh`` or a
    ``LocalMesh``): the ids split over the batch axes that divide them,
    each slice looked up over the row shards (``_lookup_rows``), the
    slices all-gathered. ``row_blocks``: the table's subtables are this
    rank's blocks already (``place_table_rows``)."""
    rows_ax = _present_axes(mesh, rows_axes)
    rows = _exchange(mesh, rows_ax)
    flat = ids.reshape(-1)
    batch = _exchange(mesh, _batch_entry(mesh, flat.shape[0],
                                         _dp_axes_of(mesh, rows_ax)))
    if row_blocks:
        if isinstance(mesh, LocalMesh):
            raise ValueError("a LocalMesh runs every rank: it takes the "
                             "whole table, not one rank's row blocks")
        blocks = {rows.shards[0]: table["subtables"]}
    else:
        blocks = {s: {k: local_row_block(v, s, rows.n)
                      for k, v in table["subtables"].items()}
                  for s in rows.shards}
    ok_vec = table[ok_key] if ok_key is not None else None
    n = flat.shape[0] // batch.n
    outs = [_lookup_rows(blocks, table[lidx_key], table["width_idx"],
                         table["alpha"], table["beta"],
                         flat[i * n:(i + 1) * n], rows, bits=bits, d=d,
                         lookup_comms=lookup_comms, capacity=bucket_capacity,
                         ok_vec=ok_vec)
            for i in batch.shards]
    return batch.all_gather(outs).reshape(*ids.shape, d)


def sharded_packed_lookup(table, meta, ids, *, rows_axes=("model",),
                          mesh=None, lookup_comms: str = "psum",
                          bucket_capacity: int | None = None,
                          row_blocks: bool = False):
    """``core.inference.packed_lookup`` on the mesh: subtables row-sharded
    over ``rows_axes`` (layout: ``packed_table_pspecs``), ids batch-sharded
    over the other axes. ``lookup_comms`` picks the merge: ``"psum"`` (one
    float all_reduce over the row axes) or ``"a2a"`` (the capacity-bucketed
    all-to-all, ``bucket_capacity`` ids per (slice, shard) bucket, overflow
    spilling to an integer all_reduce). Both are bit-exact against the
    single-device lookup; a2a gives way to psum at one row shard. Every
    gather and dequant goes through the lookup wrapper: the ``mpe_lookup``
    kernel on a card, its plain version on the CPU.

    ``table`` is the whole table, whose blocks each call cuts, or with
    ``row_blocks`` this rank's blocks (``place_table_rows``). ``mesh`` may
    be a ``LocalMesh``, every rank in this process. Takes the single-device
    lookup when no mesh of more than one rank is active. Returns the whole
    (*ids.shape, d) on every rank."""
    _check_comms(lookup_comms)
    mesh = active_mesh(mesh)
    if mesh is None:
        return packed_lookup(table, meta, ids)
    with _region.sharded("sharded_packed_lookup",
                         _present_axes(mesh, rows_axes)):
        return _sharded_lookup(table, "local_idx", tuple(meta["bits"]),
                               int(meta["d"]), ids, mesh=mesh,
                               rows_axes=rows_axes, lookup_comms=lookup_comms,
                               bucket_capacity=bucket_capacity,
                               row_blocks=row_blocks)


def sharded_tiered_hot_lookup(hot, bits, d: int, ids, *,
                              rows_axes=("model",), mesh=None,
                              lookup_comms: str = "psum",
                              bucket_capacity: int | None = None):
    """``cache.tiers.tiered_hot_lookup`` on the mesh: hot subtables
    row-sharded per ``tiered_hot_pspecs``, zeros at cold positions (the
    caller merges the cold fill). Bit-exact like the packed lookup — the
    ownership mask also requires the hot bit. ``lookup_comms`` /
    ``bucket_capacity`` select the same two merge paths (under a2a only
    hot ids are routed). ``mesh`` may be a ``LocalMesh``. The hot tier is
    the store's own, which its moves write in place, so each call cuts
    the blocks: views of it where each hot subtable's rows divide the row
    shards (a ``row_pad_multiple`` that they divide), else copies."""
    from repro_torch.cache.tiers import tiered_hot_lookup

    _check_comms(lookup_comms)
    mesh = active_mesh(mesh)
    if mesh is None:
        return tiered_hot_lookup(hot, bits, d, ids)
    with _region.sharded("sharded_tiered_hot_lookup",
                         _present_axes(mesh, rows_axes)):
        return _sharded_lookup(hot, "tier_local", tuple(bits), int(d), ids,
                               mesh=mesh, rows_axes=rows_axes,
                               lookup_comms=lookup_comms,
                               bucket_capacity=bucket_capacity,
                               ok_key="is_hot")


# ---------------------------------------------------------------------------
# embedding bag (kernels.embedding_bag)
# ---------------------------------------------------------------------------

def bag_partial(tab_loc, ids, mask, shard: int):
    """The bag's local body: the masked sums (B, d) of each bag's slots
    whose rows shard ``shard`` holds in its block ``tab_loc`` (the bag
    kernel on a card)."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_fwd

    rows_loc = tab_loc.shape[0]
    base = shard * rows_loc
    own = (ids >= base) & (ids < base + rows_loc)
    loc = (ids - base).clamp(0, rows_loc - 1).contiguous()
    return embedding_bag_fwd(tab_loc.contiguous(), loc,
                             (mask & own).contiguous())


def bag_grad_local(g, ids, mask, shard: int, rows_loc: int):
    """The bag's backward body: the segment sum's bag form of the bag
    cotangent g (B, d) into shard ``shard``'s (rows_loc, d) block, over
    the slots it owns."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_bwd

    base = shard * rows_loc
    own = mask & (ids >= base) & (ids < base + rows_loc)
    loc = (ids - base).clamp(0, rows_loc - 1).contiguous()
    return embedding_bag_bwd(g.contiguous(), loc, own.contiguous(),
                             rows_loc)


class _ShardedBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mask, mesh, rows_ax, batch_ax):
        mp = mesh.axes_size(rows_ax)
        me = mesh.axis_index(rows_ax)
        ids_b, mask_b = _block(ids, mesh, batch_ax), _block(mask, mesh,
                                                             batch_ax)
        part = bag_partial(local_row_block(table, me, mp), ids_b, mask_b,
                           me)
        out = psum(part, mesh, rows_ax) if mp > 1 else part
        ctx.mesh, ctx.rows_ax, ctx.batch_ax = mesh, rows_ax, batch_ax
        ctx.n_rows = table.shape[0]
        ctx.save_for_backward(ids_b, mask_b)
        return all_gather(out, mesh, batch_ax) if batch_ax else out

    @staticmethod
    def backward(ctx, g):
        mesh, rows_ax, batch_ax = ctx.mesh, ctx.rows_ax, ctx.batch_ax
        ids_b, mask_b = ctx.saved_tensors
        mp = mesh.axes_size(rows_ax)
        rows_loc = -(-ctx.n_rows // mp)
        d_loc = bag_grad_local(_block(g, mesh, batch_ax), ids_b, mask_b,
                               mesh.axis_index(rows_ax), rows_loc)
        if batch_ax and mesh.axes_size(batch_ax) > 1:
            # replicated bags would be counted twice under a sum
            d_loc = psum(d_loc, mesh, batch_ax)
        d_table = all_gather(d_loc, mesh, rows_ax)[:ctx.n_rows]
        return d_table.to(g.dtype), None, None, None, None, None


def sharded_embedding_bag(table, ids, mask, *, rows_axes=("model",),
                          mesh=None):
    """Multi-hot embedding bag on the mesh: the (N, d) table row-sharded
    over ``rows_axes`` (layout: ``recsys_table_pspecs``), bags
    batch-sharded over the other axes; each rank sums its owned slots with
    the bag kernel, one ``all_reduce`` merges the partial bags.

    Differentiable in the table: the backward is the segment sum's bag
    form of the owned slots' cotangents into the local row block,
    ``all_reduce``-d over the batch axes when the bags are split, then
    all-gathered over the row axes — every rank gets the whole table's
    gradient, as it holds the whole table (the reference returns it
    row-sharded). NOT bit-exact for > 1 row shard: a bag whose slots land
    on several shards has its sum reassociated (~1e-6 relative)."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_kernel

    mesh = active_mesh(mesh)
    if mesh is None:
        return embedding_bag_kernel(table, ids, mask)
    rows_ax = _present_axes(mesh, rows_axes)
    batch_ax = _batch_entry(mesh, ids.shape[0], _dp_axes_of(mesh, rows_ax))
    with _region.sharded("sharded_embedding_bag", rows_ax + (batch_ax or ()),
                         merges=(("all-reduce", rows_ax),
                                 ("all-gather", batch_ax or ()))):
        return _ShardedBag.apply(table, ids.to(torch.int32),
                                 mask.to(torch.bool), mesh, rows_ax, batch_ax)


# ---------------------------------------------------------------------------
# flash attention (kernels.flash_attention)
# ---------------------------------------------------------------------------

def _heads_block(x, mesh, batch_ax, head_ax):
    return _block(_block(x, mesh, batch_ax, 0), mesh, head_ax, 2).contiguous()


def _heads_gather(x, mesh, batch_ax, head_ax, head_dim: int = 2):
    return all_gather(all_gather(x, mesh, head_ax, head_dim), mesh, batch_ax)


class _ShardedFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, mesh, batch_ax, head_ax):
        from repro_torch.kernels.flash_attention.ops import (
            flash_attention_fwd_stats)
        qb, kb, vb = (_heads_block(x, mesh, batch_ax, head_ax)
                      for x in (q, k, v))
        o, lse = flash_attention_fwd_stats(qb, kb, vb, causal)
        ctx.causal, ctx.mesh = causal, mesh
        ctx.batch_ax, ctx.head_ax = batch_ax, head_ax
        ctx.save_for_backward(qb, kb, vb, o, lse)
        return _heads_gather(o, mesh, batch_ax, head_ax)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention.ops import (
            flash_attention_bwd)
        qb, kb, vb, o, lse = ctx.saved_tensors
        mesh, batch_ax, head_ax = ctx.mesh, ctx.batch_ax, ctx.head_ax
        grads = flash_attention_bwd(qb, kb, vb, o, lse,
                                    _heads_block(do, mesh, batch_ax, head_ax),
                                    ctx.causal)
        return (*(_heads_gather(g, mesh, batch_ax, head_ax) for g in grads),
                None, None, None, None)


def sharded_flash_attention(q, k, v, *, n_kv_heads: int | None = None,
                            causal: bool = True, head_axes=("model",),
                            mesh=None):
    """Flash attention on the mesh: batch over the data axes, query heads
    over ``head_axes`` — every (batch, head) pair computes wholly on one
    rank, so the only collectives are the gathers of the outputs and the
    result is bit-exact against the single-device kernel. GQA's kv heads
    are expanded before the split, so the heads stay aligned.

    Differentiable: one ``torch.autograd.Function`` runs the forward with
    its logsumexp rows and the backward kernel per rank, and gathers the
    whole gradients. Under ``torch.no_grad()`` the plain forward runs.
    q (B, S, Hq, hd); k, v (B, S, Hkv, hd)."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_fwd)

    mesh = active_mesh(mesh)
    if mesh is None:
        return flash_attention(q, k, v, n_kv_heads=n_kv_heads, causal=causal)
    hq, hkv = q.shape[2], k.shape[2]
    if n_kv_heads is not None and n_kv_heads != hkv:
        raise ValueError(f"n_kv_heads={n_kv_heads}, but k has {hkv} heads")
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    head_ax = _present_axes(mesh, head_axes)
    batch_ax = _batch_entry(mesh, q.shape[0], _dp_axes_of(mesh, head_ax))
    head_ax = _batch_entry(mesh, hq, head_ax)
    with _region.sharded("sharded_flash_attention",
                         (batch_ax or ()) + (head_ax or ()),
                         merges=(("all-gather", head_ax or ()),
                                 ("all-gather", batch_ax or ()))):
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            return _ShardedFlash.apply(q, k, v, causal, mesh, batch_ax,
                                       head_ax)
        o = flash_attention_fwd(*(_heads_block(x, mesh, batch_ax, head_ax)
                                  for x in (q, k, v)), causal)
        return _heads_gather(o, mesh, batch_ax, head_ax)


# ---------------------------------------------------------------------------
# QAT mixed expectation (kernels.mpe_qat)
# ---------------------------------------------------------------------------

class _ShardedExpectation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, probs, alpha, beta, bits, mesh):
        from repro_torch.kernels.mpe_qat.ops import mixed_expectation_fwd
        axes = tuple(mesh.axis_names)
        me, n = mesh.axis_index(axes), mesh.size
        r = local_row_block(rows, me, n).contiguous()
        p = local_row_block(probs, me, n).contiguous()
        ctx.bits, ctx.mesh, ctx.n = bits, mesh, rows.shape[0]
        ctx.save_for_backward(r, p, alpha, beta)
        out = mixed_expectation_fwd(r, p, alpha, beta, bits)
        return all_gather(out, mesh, axes)[:rows.shape[0]]

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels.mpe_qat.ops import mixed_expectation_bwd
        r, p, alpha, beta = ctx.saved_tensors
        mesh = ctx.mesh
        axes = tuple(mesh.axis_names)
        g = local_row_block(g, mesh.axis_index(axes), mesh.size).contiguous()
        drows, dprobs, dalpha, dbeta = mixed_expectation_bwd(
            r, p, alpha, beta, g, ctx.bits)
        return (all_gather(drows, mesh, axes)[:ctx.n],
                all_gather(dprobs, mesh, axes)[:ctx.n],
                psum(dalpha, mesh, axes), psum(dbeta, mesh, axes),
                None, None)


def sharded_mixed_expectation(rows, probs, alpha, beta, bits, *, mesh=None):
    """Eq. (9) expectation-over-widths on the mesh: rows split over
    *every* axis (the op is row-parallel), α/β replicated. No collective
    but the gather of the output; bit-exact. Rows pad up to the rank count
    and unpad after. Differentiable: the backward kernel runs per rank on
    its rows, the row gradients are gathered and dα/dβ summed over the
    mesh (reassociated, so within float tolerance of one device's)."""
    from repro_torch.kernels.mpe_qat.ops import mixed_expectation_kernel

    bits = tuple(int(b) for b in bits)
    mesh = active_mesh(mesh)
    if mesh is None:
        return mixed_expectation_kernel(rows, probs, alpha, beta, bits)
    d, m = rows.shape[-1], probs.shape[-1]
    lead = rows.shape[:-1]
    with _region.sharded("sharded_mixed_expectation", mesh.axis_names,
                         merges=(("all-gather", mesh.axis_names),)):
        out = _ShardedExpectation.apply(rows.reshape(-1, d),
                                        probs.reshape(-1, m),
                                        alpha.contiguous(), beta.contiguous(),
                                        bits, mesh)
    return out.reshape(*lead, d)


# ---------------------------------------------------------------------------
# train step: DP batch + row-sharded tables
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """The tiled all_gather of row shards; its backward is the
    reduce-scatter of the whole gradient (the sum over the row axes of
    each rank's gradient, this rank's block kept)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_gather(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        group = ctx.mesh.group(ctx.axes)
        n = ctx.mesh.axes_size(ctx.axes)
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        return _issue("reduce-scatter", ctx.axes, group, out,
                      lambda: _REDUCE_SCATTER(out, g, group=group)), \
            None, None


def table_shard_flags(params, mesh, rows_axes) -> list[bool]:
    """Per leaf of ``params`` (in ``leaves`` order), whether the train step
    stores it as a local row shard over ``rows_axes``: the
    ``params["embedding"]`` leaves that ``recsys_table_pspecs`` row-shards
    and whose rows the row axes divide."""
    rows_ax = _present_axes(mesh, rows_axes)
    mp = mesh.axes_size(rows_ax)
    emb = params.get("embedding") if isinstance(params, dict) else None
    flags = {}
    if mp > 1 and isinstance(emb, dict):
        wanted = recsys_table_pspecs(rows_ax, emb)
        flags = {id(v): bool(len(wanted[k]) and wanted[k][0] is not None
                             and v.ndim >= 1 and v.shape[0] % mp == 0)
                 for k, v in emb.items() if torch.is_tensor(v)}
    return [flags.get(id(x), False) for x in leaves(params)]


def shard_table_leaves(params, mesh, rows_axes):
    """``params`` with every leaf ``table_shard_flags`` marks replaced by a
    copy of this rank's row block; the other leaves are ``params``' own."""
    rows_ax = _present_axes(mesh, rows_axes)
    mp, me = mesh.axes_size(rows_ax), mesh.axis_index(rows_ax)
    flat = [x[me * (x.shape[0] // mp):(me + 1) * (x.shape[0] // mp)]
            .detach().clone() if f else x
            for x, f in zip(leaves(params),
                            table_shard_flags(params, mesh, rows_axes))]
    return unflatten(params, flat)


def gather_table_leaves(params, flags, mesh, rows_axes):
    """The whole tree from one whose flagged leaves are local row shards
    (no gradient): the inverse of ``shard_table_leaves``."""
    rows_ax = _present_axes(mesh, rows_axes)
    with torch.no_grad():
        return unflatten(params, [all_gather(x, mesh, rows_ax) if f else x
                                  for x, f in zip(leaves(params), flags)])


def _batch_axes(mesh, bsz: int, other_axes) -> tuple[str, ...]:
    """The reference's rule: the batch splits over every axis when they
    divide it, else over the non-row axes, else it is replicated."""
    if bsz and bsz % mesh.size == 0:
        return tuple(mesh.axis_names)
    if bsz and other_axes and bsz % mesh.axes_size(other_axes) == 0:
        return tuple(other_axes)
    return ()


def _pmean(x, mesh, axes):
    n = mesh.axes_size(axes)
    return psum(x, mesh, axes) / n if n > 1 else x


def sharded_value_and_grad(loss_fn, mesh, *, rows_axes=("model",),
                           flags=None):
    """The train step's loss and gradient on the mesh, for
    ``loss_fn(params, buffers, state, batch, *, step) -> (loss, aux)``.

    Returns ``vag(params, buffers, state, batch, *, step)`` →
    ``((loss, aux), grads)``, ``grads`` a list in ``leaves(params)`` order.
    The ``params["embedding"]`` leaves that ``table_shard_flags`` marks are
    row shards: ``params`` is the whole tree, whose marked leaves each rank
    cuts to its row block, or — with ``flags`` (the marks of the whole
    tree) — a tree that already holds the blocks there
    (``shard_table_leaves``, as the ``Trainer`` stores them). The blocks are
    all-gathered in the forward with autograd, so their gradient comes
    back reduce-scattered — local to the row shard — and is averaged over
    the other axes and divided by the row-shard count, as the reference's
    is. Every other leaf's gradient is averaged over the mesh. The batch
    is data-parallel by the reference's rule (over every axis that divides
    it, else the non-row axes, else replicated); each rank takes its block
    of the whole batch it is given. The loss and the float leaves of
    ``aux`` are averaged over the mesh; integer leaves pass through.

    Parity: a mean of shard means reassociates the batch reduction, so
    losses and gradients match one device's to float32 tolerance, not bit
    for bit."""
    rows_ax = _present_axes(mesh, rows_axes)
    mp = mesh.axes_size(rows_ax)
    other_axes = _dp_axes_of(mesh, rows_ax)
    axes_all = tuple(mesh.axis_names)

    def vag(params, buffers, state, batch, *, step):
        bsz = leaves(batch)[0].shape[0] if leaves(batch) else 0
        with _region.sharded("sharded_value_and_grad",
                             rows_ax + _batch_axes(mesh, bsz, other_axes),
                             kept_axes=rows_ax,
                             merges=(("all-reduce", axes_all),)):
            return _vag(params, buffers, state, batch, step=step)

    def _vag(params, buffers, state, batch, *, step):
        marks = flags
        flat = [p.detach() for p in leaves(params)]
        if marks is None:
            marks = table_shard_flags(params, mesh, rows_axes)
            flat = [_block(p, mesh, rows_ax) if f else p
                    for p, f in zip(flat, marks)]
        bsz = leaves(batch)[0].shape[0] if leaves(batch) else 0
        batch_ax = _batch_axes(mesh, bsz, other_axes)
        local = {k: _block(v, mesh, batch_ax) for k, v in batch.items()}
        flat = [p.requires_grad_(True) for p in flat]
        with torch.enable_grad():
            live = unflatten(params, [
                _GatherRows.apply(p, mesh, rows_ax) if f else p
                for p, f in zip(flat, marks)])
            loss, aux = loss_fn(live, buffers, state, local, step=step)
            grads = list(torch.autograd.grad(loss, flat))
        del live, flat
        loss = _pmean(loss.detach(), mesh, axes_all)
        aux = unflatten(aux, [
            _pmean(x.detach(), mesh, axes_all)
            if torch.is_tensor(x) and x.is_floating_point() else x
            for x in leaves(aux)])
        return (loss, aux), [
            _pmean(g, mesh, other_axes) / mp if f
            else _pmean(g, mesh, axes_all) for g, f in zip(grads, marks)]

    return vag


def sharded_clip_scale(grads, flags, mesh, rows_axes, max_norm: float):
    """``optimizer.clip_scale`` over the global gradient: the squared norms
    of the local row shards (``flags``) summed once over the row axes,
    those of the replicated leaves (the same on every rank) added once.
    Every rank gets the same factor and norm, so the NaN guard's verdict
    agrees everywhere."""
    rows_ax = _present_axes(mesh, rows_axes)
    dev = grads[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    sharded = sum((s for s, f in zip(sq, flags) if f), zero)
    replicated = sum((s for s, f in zip(sq, flags) if not f), zero)
    gnorm = torch.sqrt(psum(sharded, mesh, rows_ax) + replicated)
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0), gnorm
