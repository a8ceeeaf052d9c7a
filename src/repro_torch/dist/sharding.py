"""Partition-spec contract for every workload family on the production mesh.

The port of the reference's ``repro.dist.sharding``, family for family and
spec for spec. Mesh axes: ``("data", "model")`` single-pod (16×16), with a
leading ``"pod"`` axis (2×16×16) multi-pod. Three pspec families:

  LM       — params FSDP-style (last dim over "model", second-to-last over
             "data"); token batches over the data axes; KV caches with the
             sequence dim over "model" (batch over data when batch > 1).
  recsys   — (n, d) embedding tables row-sharded over ``rows_axes``; γ/α/β
             side params and the MLP stay replicated.
  MPE pack — one bit-packed subtable per candidate width, each row-sharded
             over ``rows_axes``. Rows are padded to multiples of 512
             (``core.inference._pad_rows``), so row shards stay aligned to
             whole packed rows (a row is only decodable whole).

``P`` is the port's ``PartitionSpec``: a tuple of dim entries, each None
(replicated), an axis name, or a tuple of axis names. ``NamedSharding``
resolves a spec on a ``Mesh`` to its DTensor placements — per mesh axis
``Shard(dim)`` or ``Replicate()`` — which is how
``torch.distributed.tensor`` places a tensor on ``Mesh.device_mesh``.

In eager SPMD every rank already holds the block it computes on, so the
reference's in-model constraints (``maybe_shard``, ``shard_batch_dim``),
which pin an XLA value's layout, are identities here; ``current_dp_axes``
still reports the active mesh's batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.dist.mesh import current_mesh
from repro_torch.train.tree import tree_map

# Production axis sizes (launch/mesh.py): only dims divisible by these are
# assigned a mesh axis — everything else stays replicated, which keeps every
# pspec valid on any submesh (1×1 included).
PROD_AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}

#: Every mesh axis any pspec family may name.
MESH_AXES = frozenset(PROD_AXIS_SIZE)

#: The axes a table's rows (and a retrieval cell's candidates) split over.
ROWS_AXES = ("model",)

#: The axis groups a single pspec dim may combine, normalized to tuples in
#: mesh order: ``("pod", "data")`` is the multi-pod batch dim;
#: ``("data", "model")`` / ``("pod", "data", "model")`` the every-axis row
#: splits of ``sharded_mixed_expectation``; ``("pod", "model")`` the
#: cross-host table-row split of ``host_packed_table_pspecs``.
AXIS_GROUPS = frozenset({
    ("pod",), ("data",), ("model",),
    ("pod", "data"), ("pod", "model"), ("data", "model"),
    ("pod", "data", "model"),
})

#: name → builder for every pspec family below.
SPEC_FAMILIES = {}


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name or a
    tuple of axis names); dims past its length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _family(fn):
    SPEC_FAMILIES[fn.__name__] = fn
    return fn


def normalize_entry(entry) -> tuple[str, ...] | None:
    """One spec dim entry → tuple of axes (None stays None)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_in_contract(spec) -> bool:
    """True when every dim entry of ``spec`` is a registered axis group."""
    for entry in tuple(spec):
        norm = normalize_entry(entry)
        if norm is not None and norm not in AXIS_GROUPS:
            return False
    return True


def dp_axes(multi_pod: bool = False) -> tuple[str, ...]:
    """The data-parallel (batch) axes of the production mesh."""
    return ("pod", "data") if multi_pod else ("data",)


def current_dp_axes() -> tuple[str, ...] | None:
    """Batch axes of the active mesh, or None when sharding is a no-op."""
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1:
        return None
    dp = tuple(n for n in mesh.axis_names if n != "model")
    return dp or None


def _axes_size(mesh, entry) -> int:
    size = 1
    for n in normalize_entry(entry):
        size *= mesh.shape[n]
    return size


def _fit_spec(shape, spec, mesh) -> P:
    """Drop spec entries whose axes are unknown to ``mesh`` or don't divide
    the dim — a placement that can't be honored cleanly is replicated."""
    fitted = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            fitted.append(None)
            continue
        if not all(n in mesh.shape for n in normalize_entry(entry)):
            fitted.append(None)
            continue
        fitted.append(entry if dim % _axes_size(mesh, entry) == 0 else None)
    return P(*fitted)


def maybe_shard(x, spec: P):
    """Identity. The reference pins an XLA value's layout to ``spec``; in
    eager SPMD each rank already holds the block it computes on, so there
    is nothing to pin."""
    del spec
    return x


def shard_batch_dim(x, axis: int = 0):
    """Identity, for the reason ``maybe_shard`` is: each rank already holds
    its own batch block."""
    del axis
    return x


class NamedSharding(NamedTuple):
    """A spec resolved on a mesh. ``placements`` holds, per mesh axis in
    mesh order, ``Shard(dim)`` for the tensor dim that axis splits, or
    ``Replicate()`` — the placements of ``torch.distributed.tensor``'s
    ``distribute_tensor(x, mesh.device_mesh, placements)``."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e is not None and axis in normalize_entry(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _is_pspec(x) -> bool:
    return isinstance(x, P)


def _spec_map(fn, tree):
    """``fn`` over the specs of a tree whose leaves are ``P``s."""
    if _is_pspec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_map(fn, v) for v in tree)
    return fn(tree)


def tree_named_shardings(mesh, pspec_tree):
    """Map a tree of specs to ``NamedSharding``s on ``mesh``."""
    return _spec_map(lambda ps: NamedSharding(mesh, ps), pspec_tree)


def replicate_like(tree):
    """Rank-matched fully-replicated specs for every leaf of ``tree``."""
    return tree_map(lambda x: P(*([None] * getattr(x, "ndim", 0))), tree)


def cell_shardings(mesh, cell):
    """(in_shardings, out_shardings) for a cell that carries ``in_pspecs``
    and ``out_pspecs``."""
    ins = tuple(tree_named_shardings(mesh, ps) for ps in cell.in_pspecs)
    outs = tree_named_shardings(mesh, cell.out_pspecs)
    return ins, outs


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _fsdp_leaf_spec(leaf) -> P:
    """FSDP-style storage spec: last dim over "model", second-to-last over
    "data" — assigned only when the production axis size divides the dim.
    1-D leaves and scalars stay replicated."""
    nd = leaf.ndim
    if nd < 2:
        return P(*([None] * nd))
    entries = [None] * nd
    if leaf.shape[-1] % PROD_AXIS_SIZE["model"] == 0:
        entries[-1] = "model"
    if leaf.shape[-2] % PROD_AXIS_SIZE["data"] == 0:
        entries[-2] = "data"
    return P(*entries)


@_family
def lm_param_pspecs(params_sds, cfg=None):
    """Specs matching the LM param tree (stacked-layer leaves included):
    the FSDP at-rest placement of every weight."""
    del cfg
    return tree_map(_fsdp_leaf_spec, params_sds)


@_family
def lm_logits_pspecs(batch: int, *, vocab_sharded: bool = False, dp=None,
                     multi_pod: bool = False) -> P:
    """Logits ``(B, V)`` of a prefill/decode step: batch over the data
    axes (``dp`` overrides them) with the vocab dim optionally over
    "model"; a ``batch == 1`` step puts "model" on the vocab dim."""
    if batch > 1:
        axes = tuple(dp) if dp is not None else dp_axes(multi_pod)
        return P(axes, "model" if vocab_sharded else None)
    return P(None, "model")


@_family
def lm_batch_pspecs(multi_pod: bool = False):
    """{"tokens", "labels"}: (B, S) int32, batch over the data axes."""
    dp = dp_axes(multi_pod)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


@_family
def lm_cache_pspecs(*, long_context: bool = False, multi_pod: bool = False):
    """Stacked KV caches {"k","v": (L, B, T, n_kv, hd), "len": ()}: T over
    "model", batch over the data axes except in the long-context cell."""
    batch_ax = None if long_context else dp_axes(multi_pod)
    kv = P(None, batch_ax, "model", None, None)
    return {"k": kv, "v": kv, "len": P()}


@_family
def lm_kv_cache_pspecs(*, quantized: bool = False, long_context: bool = False,
                       multi_pod: bool = False):
    """``lm_cache_pspecs`` plus the int8 scale entries
    {"k_scale","v_scale": (L, B, 1, n_kv, 1)} when ``quantized``: they
    shard with the cache's batch axis only."""
    ps = lm_cache_pspecs(long_context=long_context, multi_pod=multi_pod)
    if quantized:
        scale_ps = P(None, ps["k"][1], None, None, None)
        ps = dict(ps, k_scale=scale_ps, v_scale=scale_ps)
    return ps


# ---------------------------------------------------------------------------
# recsys embedding tables (search/train phase)
# ---------------------------------------------------------------------------

@_family
def recsys_table_pspecs(rows_axes, emb_sds=None):
    """MPE search-phase embedding params: the (n, d) table row-shards over
    ``rows_axes``; γ, α and β replicate. With ``emb_sds`` (a param dict
    from any compressor), unknown leaves get rank-matched replicated
    specs."""
    base = {"emb": P(rows_axes, None), "gamma": P(None, None),
            "alpha": P(None), "beta": P(None)}
    if emb_sds is None:
        return base
    return {k: base[k] if k in base else P(*([None] * v.ndim))
            for k, v in emb_sds.items()}


# ---------------------------------------------------------------------------
# MPE packed serving tables
# ---------------------------------------------------------------------------

@_family
def packed_table_pspecs(table_sds, *, rows_axes=("model",)):
    """Specs for a packed inference table: each per-width subtable
    (rows, words_per_row) row-shards over ``rows_axes``, the word dim never
    splits, and the id→(bucket, row) vectors and α/β replicate."""
    return {
        "subtables": {k: P(rows_axes, None) for k in table_sds["subtables"]},
        "local_idx": P(None),
        "width_idx": P(None),
        "alpha": P(None),
        "beta": P(None),
    }


@_family
def host_packed_table_pspecs(table_sds, *, rows_axes=("pod", "model")):
    """Multi-host layout of a packed table: subtable rows over
    ``("pod", "model")``, pod-major, so one host owns a contiguous row
    range and its "model" neighbours are on the same host."""
    return packed_table_pspecs(table_sds, rows_axes=tuple(rows_axes))


@_family
def tiered_hot_pspecs(hot_sds, *, rows_axes=("model",)):
    """Specs for the hot tier of a ``TieredTableStore``: hot subtables
    row-shard like ``packed_table_pspecs``; the routing vectors and the
    dequant params replicate."""
    return {
        "subtables": {k: P(rows_axes, None) for k in hot_sds["subtables"]},
        "tier_local": P(None),
        "is_hot": P(None),
        "width_idx": P(None),
        "alpha": P(None),
        "beta": P(None),
    }


@_family
def packed_serve_pspecs(params, *, rows_axes=("model",),
                        row_keys=("wide", "fm_linear")):
    """Full param-tree specs for a model serving from a packed table:
    ``params["embedding"]`` gets the packed-table layout, per-feature 1-D
    vectors named in ``row_keys`` row-shard with the vocab, everything else
    replicates."""
    pspecs = {k: replicate_like(v) for k, v in params.items()
              if k != "embedding"}
    pspecs["embedding"] = packed_table_pspecs(params["embedding"],
                                              rows_axes=rows_axes)
    for k in row_keys:
        if k in params:
            pspecs[k] = P(rows_axes)
    return pspecs
