"""Serve-cell builders: (model, config, bound state) → capturable cell defs.

The port of the reference's ``repro.serve.cells``: each builder binds real
tensors (a packed table, the MLP and its BatchNorm statistics) and fixes the
batch shape, so the same builder serves a 3-field test table on the CPU and
the Criteo-scale table on the card.

A ``ServeCellDef`` separates *bound* inputs (params/state/buffers — moved to
the engine's device once, at registration) from *request* inputs (ids,
tokens, KV caches — fresh every call); ``repro_torch.serve.cache.CellCache``
turns the pair into one executable: a CUDA graph captured once on the card,
the eager step on the CPU. In eager SPMD a cell's placement is its
wrappers' own (``repro_torch.dist.shard``); the cell still declares the
reference's partition specs (``bound_pspecs``, ``request_pspecs``,
``out_pspecs``, from the ``repro_torch.dist.sharding`` families), which the
static checker holds to the mesh contract. They are not part of the cache
key or the fingerprint. ``abstract_signature`` lists every input leaf's
(shape, dtype, weak) for the recompile-hazard pass.

On a mesh (``repro_torch.dist``), ``shard_lookup`` routes a score or tiered
cell's gather through the sharded lookups of ``repro_torch.dist.shard``:
subtables row-sharded over ``rows_axes``, the merge by ``lookup_comms``
(``"psum"`` or the capacity-bucketed ``"a2a"``), bit-exact either way. Such
a step holds collectives, so on a mesh of more than one rank its cell runs
eager and is not captured (``serve.cache``).

The LM decode cells take their KV caches as a request input, a dict of
tensors: in the graph those are static inputs that each replay writes in
place (the caches a step returns are the cell's own), and
``make_request_state(device=)`` builds fresh ones with the model's own
``LM.make_kv_caches``.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.cache.tiers import cold_buffer_words, tiered_hot_lookup_fn
from repro_torch.core.inference import packed_lookup_fn
from repro_torch.dist.sharding import (ROWS_AXES, P, dp_axes,
                                       lm_kv_cache_pspecs, lm_logits_pspecs,
                                       lm_param_pspecs, packed_serve_pspecs,
                                       packed_table_pspecs, replicate_like,
                                       tiered_hot_pspecs)
from repro_torch.kernels.tiered_cold.ops import cold_fill
from repro_torch.models.lm import LM
from repro_torch.train.tree import leaves


class ServeCellDef(NamedTuple):
    """One capturable serving cell: a step function plus everything the
    ``CellCache`` needs to build it — *bound* inputs (params/state, fixed
    at registration), the request inputs' ``(shape, dtype)``, and the
    identity fields (``arch``/``shape``/``kind``/``batch``) that key the
    cache."""
    arch: str              # architecture identity (cache-key component)
    shape: str             # shape name, e.g. "serve_p99"
    kind: str              # score | lookup | tiered_score | retrieve |
                           # decode | decode_slotted
    batch: int             # leading-dim capacity of the executable
    step_fn: Callable      # step_fn(*bound, *request) -> outputs
    bound: tuple           # trees fixed at registration (params, state, ...)
    request_specs: tuple   # ((shape, dtype) or a dict of them, ...) for the
                           # per-request inputs
    meta: dict
    static: Any = None     # config baked into step_fn closures (cfg, top_k…)
    make_request_state: Callable | None = None  # fresh KV caches (device=)
    # the declared partition specs (``repro_torch.dist.sharding.P`` trees
    # matching bound / request_specs / the output); empty: replicated
    bound_pspecs: tuple = ()
    request_pspecs: tuple = ()
    out_pspecs: Any = None

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"

    @property
    def fingerprint_blob(self) -> str:
        """The raw repr the fingerprint digests: kind, batch, meta and the
        static config, as the reference's."""
        return repr((self.kind, self.batch, sorted(self.meta.items(), key=str),
                     self.static))

    @property
    def fingerprint(self) -> str:
        """Digest of everything baked into the executable beyond its input
        shapes — the step closure's static config (``static``), kind and
        meta. Part of the cache key: two same-named registrations with
        different baked-in config must not share an executable."""
        return hashlib.sha1(self.fingerprint_blob.encode()).hexdigest()[:12]

    def abstract_signature(self) -> tuple:
        """``((shape, dtype name, weak), ...)`` of every leaf of ``bound``
        and ``request_specs``, in call order: what distinguishes
        executables beyond the cache key. A tensor leaf is ``(shape,
        dtype, False)``, a request spec ``((shape), dtype)`` likewise; a
        Python number is ``((), type, True)`` — torch promotes it weakly
        and a CUDA graph bakes it in as a constant, the port's counterpart
        of a weak-typed leaf (the recompile-hazard pass flags it)."""
        sig = []
        for leaf in leaves(self.bound):
            sig.append(_leaf_signature(leaf))
        for spec in self.request_specs:
            for shape, dtype in _spec_leaves(spec):
                sig.append((tuple(shape), _dtype_name(dtype), False))
        return tuple(sig)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_signature(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), _dtype_name(leaf.dtype), False
    if isinstance(leaf, bool):
        return (), "bool", True
    if isinstance(leaf, int):
        return (), "int64", True
    if isinstance(leaf, float):
        return (), "float32", True
    return (), type(leaf).__name__, False


def _spec_leaves(spec):
    """The ``(shape, dtype)`` leaves of one request spec: a pair, or a dict
    of them (a decode cell's KV caches)."""
    if isinstance(spec, dict):
        for v in spec.values():
            yield from _spec_leaves(v)
    else:
        yield spec


def _serve_param_pspecs(params, rows_axes):
    """A serving param tree's specs: the packed-table layout where
    ``params["embedding"]`` is a packed table, else replicated."""
    emb = params.get("embedding") if isinstance(params, dict) else None
    if isinstance(emb, dict) and "subtables" in emb:
        return packed_serve_pspecs(params, rows_axes=tuple(rows_axes))
    return replicate_like(params)


def packed_score_step(model, cfg, *, top_k: int | None = None,
                      shard_lookup: bool = False, rows_axes=("model",),
                      lookup_comms: str = "psum",
                      bucket_capacity: int | None = None,
                      row_blocks: bool = False):
    """The packed-table scoring computation: eval-mode forward over a packed
    embedding config, optionally topped with a candidate ``top_k``
    (``(values, indices)``).

    ``shard_lookup`` routes the embedding gather through
    ``repro_torch.dist.shard.sharded_packed_lookup`` on the mesh active when
    the step runs (the ``CellCache`` runs it under the engine's mesh), with
    subtables row-sharded over ``rows_axes``; ``lookup_comms`` picks the
    merge — ``"psum"`` or ``"a2a"`` with ``bucket_capacity`` ids a bucket —
    both bit-exact, so the scores match the unsharded cell either way. The
    interaction net (``model.interact``) then runs on every rank over the
    whole batch. On a one-rank mesh the lookup is the single-device one.
    ``row_blocks``: the bound table holds this rank's row blocks
    (``repro_torch.dist.shard.place_table_rows``), not the whole table."""
    if not shard_lookup:
        def serve_step(params, state, buffers, ids):
            logits = model.apply(params, buffers, state, {"ids": ids}, cfg)[0]
            if top_k is not None:
                return tuple(torch.topk(logits, top_k))
            return logits
        return serve_step

    from repro_torch.dist.shard import sharded_packed_lookup
    meta = {k: cfg.comp_cfg[k] for k in ("bits", "d", "n")}

    def serve_step(params, state, buffers, ids):
        gids = ids + buffers["offsets"][None, :]
        emb = sharded_packed_lookup(params["embedding"], meta, gids,
                                    rows_axes=rows_axes,
                                    lookup_comms=lookup_comms,
                                    bucket_capacity=bucket_capacity,
                                    row_blocks=row_blocks)
        logits, _ = model.interact(params, state, emb, gids, cfg)
        if top_k is not None:
            return tuple(torch.topk(logits, top_k))
        return logits
    return serve_step


def packed_score_cell(model, cfg, params, state, buffers, *, batch: int,
                      arch: str, shape: str, rows_axes=("model",),
                      shard_lookup: bool = False, lookup_comms: str = "psum",
                      bucket_capacity: int | None = None,
                      row_blocks: bool = False) -> ServeCellDef:
    """Batched CTR scoring from a packed table: ``ids (B, F) -> logits (B,)``.

    ``cfg`` must carry ``compressor="packed"`` with the table's comp_cfg;
    ``params["embedding"]`` is the packed table. ``shard_lookup`` takes the
    sharded lookup and ``lookup_comms``/``bucket_capacity`` pick its merge
    (see ``packed_score_step``, also for ``row_blocks``); all enter the
    cell fingerprint, so a psum cell and an a2a cell never share an
    executable."""
    n_fields = len(cfg.fields)
    return ServeCellDef(
        arch=arch, shape=shape, kind="score", batch=batch,
        step_fn=packed_score_step(model, cfg, shard_lookup=shard_lookup,
                                  rows_axes=rows_axes,
                                  lookup_comms=lookup_comms,
                                  bucket_capacity=bucket_capacity,
                                  row_blocks=row_blocks),
        bound=(params, state, buffers),
        request_specs=(((batch, n_fields), torch.int32),),
        meta={"kind": "score", "batch": batch, "n_fields": n_fields,
              "shard_lookup": shard_lookup, "lookup_comms": lookup_comms,
              "bucket_capacity": bucket_capacity, "rows_axes": rows_axes,
              "row_blocks": row_blocks},
        static=cfg,
        bound_pspecs=(_serve_param_pspecs(params, rows_axes),
                      replicate_like(state), replicate_like(buffers)),
        request_pspecs=(P(dp_axes(), None),),
        out_pspecs=P(dp_axes()),
    )


def baseline_score_cell(model, cfg, params, state, buffers, *, batch: int,
                        arch: str, shape: str) -> ServeCellDef:
    """Batched CTR scoring for a *baseline* compressor (plain, qr, pep,
    optfs, alpt, lsq — anything registered in ``core.compressors``):
    ``ids (B, F) -> logits (B,)``. The reference's differs from
    ``packed_score_cell`` only in its partition specs (the dense baseline
    tables replicate), so here the two are one cell without the sharded
    lookup."""
    return packed_score_cell(model, cfg, params, state, buffers, batch=batch,
                             arch=arch, shape=shape)


def packed_lookup_cell(table, meta, offsets, *, batch: int, n_fields: int,
                       arch: str, shape: str, rows_axes=("model",),
                       shard_lookup: bool = False, lookup_comms: str = "psum",
                       bucket_capacity: int | None = None,
                       row_blocks: bool = False) -> ServeCellDef:
    """Lookup-only companion cell: the packed gather+unpack+dequant slice of a
    score cell, at the same padded shape. The engine times it per dispatch
    to report the Figure-5 lookup-vs-compute split. ``shard_lookup`` and
    the rest gather as the score cell's do (``packed_score_step``)."""
    lookup = packed_lookup_fn(meta)
    if shard_lookup:
        from repro_torch.dist.shard import sharded_packed_lookup
        lmeta = {k: meta[k] for k in ("bits", "d")}

        def lookup(tbl, gids):
            return sharded_packed_lookup(tbl, lmeta, gids,
                                         rows_axes=rows_axes,
                                         lookup_comms=lookup_comms,
                                         bucket_capacity=bucket_capacity,
                                         row_blocks=row_blocks)

    def lookup_step(tbl, offs, ids):
        return lookup(tbl, ids + offs[None, :])

    return ServeCellDef(
        arch=arch, shape=f"{shape}.lookup", kind="lookup", batch=batch,
        step_fn=lookup_step,
        bound=(table, offsets),
        request_specs=(((batch, n_fields), torch.int32),),
        meta={"kind": "lookup", "batch": batch, "n_fields": n_fields,
              "shard_lookup": shard_lookup, "lookup_comms": lookup_comms,
              "bucket_capacity": bucket_capacity, "rows_axes": rows_axes,
              "row_blocks": row_blocks},
        static=(tuple(meta["bits"]), meta["d"], meta["n"]),
        bound_pspecs=(packed_table_pspecs(table, rows_axes=tuple(rows_axes)),
                      P(None)),
        request_pspecs=(P(dp_axes(), None),),
        out_pspecs=P(dp_axes(), None, None),
    )


def tiered_score_cell(model, cfg, params, state, buffers, hot, meta, *,
                      batch: int, arch: str, shape: str, rows_axes=("model",),
                      shard_lookup: bool = False, lookup_comms: str = "psum",
                      bucket_capacity: int | None = None) -> ServeCellDef:
    """Batched CTR scoring from a **tiered** table: ``(ids (B, F), cold
    (words,)) -> logits (B,)``.

    Hot rows are gathered on the device inside the cell from the bound hot
    tier (``TieredTableStore.hot``) by the packed lookup, which leaves the
    zero row at every cold id; the cold rows arrive as the request's staged
    cold buffer (``TieredTableStore.prefetch_cold``, copied one chunk ahead
    by the engine) and the cold-fill kernel writes them over those zeros,
    so no merge is needed. The interaction net is the model's own
    ``interact``, so the scores match the monolithic score cell.

    ``params`` is the serving param tree *without* the ``"embedding"``
    entry (the tiered store owns the table). The cell binds the store's
    own tensors, which its moves, writebacks and refreshes write in place;
    the cold buffer is sized for every id of the batch cold at the widest
    width (``cold_buffer_words``). ``shard_lookup`` routes the hot gather
    through ``repro_torch.dist.shard.sharded_tiered_hot_lookup`` (hot
    subtables row-sharded over ``rows_axes``, the merge by
    ``lookup_comms``/``bucket_capacity``); the scores still match the
    monolithic cell."""
    n_fields = len(cfg.fields)
    d = int(meta["d"])
    bits = tuple(int(b) for b in meta["bits"])
    if shard_lookup:
        from repro_torch.dist.shard import sharded_tiered_hot_lookup

        def hot_lookup(hot_tree, gids):
            return sharded_tiered_hot_lookup(hot_tree, bits, d, gids,
                                             rows_axes=rows_axes,
                                             lookup_comms=lookup_comms,
                                             bucket_capacity=bucket_capacity)
    else:
        hot_lookup = tiered_hot_lookup_fn(bits, d)
    fill_meta = {"bits": bits, "d": d}
    param_pspecs = replicate_like(params)
    for k in ("wide", "fm_linear"):    # the reference's row-sharded leaves
        if k in params:
            param_pspecs[k] = P(tuple(rows_axes))
    # the port's hot tier also holds the lookup's width index: replicated
    hot_pspecs = tiered_hot_pspecs(hot, rows_axes=tuple(rows_axes))
    hot_pspecs.update({k: replicate_like(v) for k, v in hot.items()
                       if k not in hot_pspecs})

    def tiered_step(p, st, bufs, hot_tree, ids, cold):
        gids = ids + bufs["offsets"][None, :]
        emb = hot_lookup(hot_tree, gids)                        # 0 at cold
        cold_fill(emb, cold, fill_meta, hot_tree["alpha"], hot_tree["beta"])
        logits, _ = model.interact(p, st, emb, gids, cfg)
        return logits

    return ServeCellDef(
        arch=arch, shape=shape, kind="tiered_score", batch=batch,
        step_fn=tiered_step,
        bound=(params, state, buffers, hot),
        request_specs=(((batch, n_fields), torch.int32),
                       ((cold_buffer_words(batch * n_fields, meta),),
                        torch.int32)),
        meta={"kind": "tiered_score", "batch": batch, "n_fields": n_fields,
              "shard_lookup": shard_lookup, "lookup_comms": lookup_comms,
              "bucket_capacity": bucket_capacity},
        static=(cfg, bits, d),
        bound_pspecs=(param_pspecs, replicate_like(state),
                      replicate_like(buffers), hot_pspecs),
        request_pspecs=(P(dp_axes(), None), P(None)),
        out_pspecs=P(dp_axes()),
    )


def two_tower_retrieval_cell(model, cfg, params, state, buffers, *,
                             n_cands: int, top_k: int = 100, arch: str,
                             shape: str = "retrieval_cand") -> ServeCellDef:
    """One user against a padded candidate corpus → masked top-k:
    ``(user_ids (1, Fu), cand_ids (C, Fi), cand_mask (C,)) -> (scores,
    indices)``, C = ``n_cands``.

    Padded candidates score ``-inf`` through the validity mask, so they can
    never enter the top-k of a real request. The towers read their
    BatchNorm running statistics (eval mode); ``cfg`` carries the
    ``packed`` compressor, so each tower is one packed lookup. The
    reference's specs (candidates over ``rows_axes``) are declared; on a
    mesh the cell still runs whole on every rank."""
    fu, fi = len(cfg.user_fields), len(cfg.item_fields)

    def retrieve_step(p, st, bufs, user_ids, cand_ids, cand_mask):
        u, _ = model.user_tower(p, bufs, st, user_ids, cfg)
        v, _ = model.item_tower(p, bufs, st, cand_ids, cfg)
        scores = (v @ u[0]) / cfg.temperature
        scores = scores.masked_fill(~cand_mask, float("-inf"))
        return tuple(torch.topk(scores, top_k))

    return ServeCellDef(
        arch=arch, shape=shape, kind="retrieve", batch=n_cands,
        step_fn=retrieve_step,
        bound=(params, state, buffers),
        request_specs=(((1, fu), torch.int32), ((n_cands, fi), torch.int32),
                       ((n_cands,), torch.bool)),
        meta={"kind": "retrieve", "n_cands": n_cands, "top_k": top_k},
        static=cfg,
        bound_pspecs=(_serve_param_pspecs(params, ROWS_AXES),
                      replicate_like(state), replicate_like(buffers)),
        request_pspecs=(P(None, None), P(ROWS_AXES, None), P(ROWS_AXES)),
        out_pspecs=(P(None), P(None)),
    )


def _cache_specs(cfg, batch: int, max_len: int, kv_dtype) -> dict:
    """``(shape, dtype)`` of each KV-cache tensor ``LM.make_kv_caches``
    makes, read from a cache built on the meta device (no memory)."""
    caches = LM.make_kv_caches(cfg, batch, max_len, kv_dtype, device="meta")
    return {k: (tuple(v.shape), v.dtype) for k, v in caches.items()}


def lm_decode_slotted_cell(cfg, params, buffers, *, batch: int, max_len: int,
                           kv_int8: bool = True, arch: str,
                           shape: str = "decode_cb") -> ServeCellDef:
    """Continuous-batching decode: per-slot cache lengths.

    The batch dim is a pool of ``batch`` KV-cache *slots*; each slot holds
    one request's sequence at its own length. Request inputs are
    ``(tokens (B, 1), lens (B,) int32, caches)`` where ``lens`` is the
    scheduler-owned per-slot valid length (a recycled slot rejoins at 0,
    which re-seeds its int8 scale on the first write) and ``caches`` omits
    the shared ``"len"`` of the classic decode cell. Requests join and
    leave the running batch between steps without a new capture — the
    scheduler's ``DecodeSession`` owns the slot free-list."""
    kv_dtype = torch.int8 if kv_int8 else torch.bfloat16

    def decode_step(p, bufs, tokens, lens, caches):
        return LM.decode_step_slotted(p, bufs, tokens, lens, caches, cfg)

    def make_caches(device=None):
        caches = LM.make_kv_caches(cfg, batch, max_len, kv_dtype,
                                   device=device)
        caches.pop("len")
        return caches

    specs = _cache_specs(cfg, batch, max_len, kv_dtype)
    specs.pop("len")
    cache_ps = {k: v for k, v in lm_kv_cache_pspecs(quantized=kv_int8).items()
                if k != "len"}
    dp = dp_axes()
    return ServeCellDef(
        arch=arch, shape=shape, kind="decode_slotted", batch=batch,
        step_fn=decode_step,
        bound=(params, buffers),
        request_specs=(((batch, 1), torch.int32), ((batch,), torch.int32),
                       specs),
        meta={"kind": "decode_slotted", "batch": batch, "max_len": max_len,
              "kv_int8": kv_int8},
        static=cfg,
        make_request_state=make_caches,
        bound_pspecs=(lm_param_pspecs(params, cfg), replicate_like(buffers)),
        request_pspecs=(P(dp, None) if batch > 1 else P(None, None),
                        P(dp) if batch > 1 else P(None), cache_ps),
        out_pspecs=(lm_logits_pspecs(batch, dp=dp), cache_ps),
    )


def lm_decode_cell(cfg, params, buffers, *, batch: int, max_len: int,
                   kv_int8: bool = True, arch: str,
                   shape: str = "decode") -> ServeCellDef:
    """One-token decode against a persistent KV cache: ``(tokens (B, 1),
    caches) -> (logits (B, V), caches)``.

    The int8 cache with running-absmax scales is the default — the
    paper-aligned halving of the decode-dominant KV traffic; pass
    ``kv_int8=False`` for the bf16 cache."""
    kv_dtype = torch.int8 if kv_int8 else torch.bfloat16

    def decode_step(p, bufs, tokens, caches):
        return LM.decode_step(p, bufs, tokens, caches, cfg)

    def make_caches(device=None):
        return LM.make_kv_caches(cfg, batch, max_len, kv_dtype, device=device)

    cache_ps = lm_kv_cache_pspecs(quantized=kv_int8)
    dp = dp_axes()
    return ServeCellDef(
        arch=arch, shape=shape, kind="decode", batch=batch,
        step_fn=decode_step,
        bound=(params, buffers),
        request_specs=(((batch, 1), torch.int32),
                       _cache_specs(cfg, batch, max_len, kv_dtype)),
        meta={"kind": "decode", "batch": batch, "max_len": max_len,
              "kv_int8": kv_int8},
        static=cfg,
        make_request_state=make_caches,
        bound_pspecs=(lm_param_pspecs(params, cfg), replicate_like(buffers)),
        request_pspecs=(P(dp, None) if batch > 1 else P(None, None),
                        cache_ps),
        out_pspecs=(lm_logits_pspecs(batch, dp=dp), cache_ps),
    )
