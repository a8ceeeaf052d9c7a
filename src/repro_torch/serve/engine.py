"""The serving engine: a submit/poll request lifecycle over captured cells.

Request flow for a scored request:

  submit(ids) ──▶ AdmissionQueue (bounded; deadlines; tenant quotas; shed)
      ──▶ Scheduler.step: coalesce pending requests across callers onto the
          registered cell shapes (one padded cell call serves many
          requests; outputs scatter back per requester via Chunk.spans)
      ──▶ poll(ticket) → logits (n,)

``score`` and ``score_tiered`` are thin synchronous wrappers (submit +
drain + poll): a lone request packs onto exactly the chunks the per-request
planner chooses. The port of the reference's ``repro.serve.engine``: the
same names, signatures, clock reads, counters and summaries.

Every executable is built exactly once per (arch, shape, device, bound
tensors) by the ``CellCache``: on the card a CUDA graph captured at
registration, whose replays launch the ``mpe_lookup`` kernel and the MLP's
products; on the CPU the eager step. The model's tensors move to the
engine's device once, at registration. Per-cell wall-clock is recorded with
the lookup-only companion cell timed alongside, for the paper's Figure-5
lookup-vs-compute split, plus per-dispatch occupancy; per-request
queue-wait / batch-assembly / compute land in ``RequestStats``.

The tiered lane serves from a ``repro_torch.cache.TieredTableStore``: its
cells bind the store's own tensors (the hot tier), which tier moves,
writebacks and refreshes write in place, so a move reaches the captured
graphs with no rebind; each chunk's cold rows are staged one chunk ahead
(``ColdStaging``) while the previous chunk's replay computes.

The retrieve lane serves two-tower retrieval: one user against a
candidate corpus of any size, chunked onto the registered cell's capacity
(``two_tower_retrieval_cell``) and the per-chunk top-ks merged.

The decode lanes serve the LM: ``decode`` steps a classic decode cell
(``lm_decode_cell``) against caches the caller threads through, and
``submit_decode`` rides the scheduler's continuous-batching lane
(``lm_decode_slotted_cell``), whose sequences join and leave a persistent
slot-pooled KV cache between steps. On the card a decode cell's caches are
static inputs of its graph, written in place by every replay: the caches
``decode`` returns are the cell's own, which the next call reads without a
copy (it copies only caches that are not).

One engine holds one mesh (``repro_torch.dist``; default ``host_mesh()``,
1×1 in one process, where every cell is the CUDA graph above). Under a
launcher such as ``torch.distributed.run`` every rank runs its own engine
over the same requests (SPMD); ``shard_lookup`` cells gather through the
sharded lookups of ``repro_torch.dist.shard``, row-sharded over
``rows_axes`` and merged by ``lookup_comms`` (psum, or the
capacity-bucketed all-to-all), and every rank returns the same scores,
bit-identical to one device's. On a mesh of more than one rank such a cell
holds collectives, so it runs eager and is not captured as a graph.
"""
from __future__ import annotations

import gc
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.cache.tiers import ColdStaging
from repro_torch.device import full_float32, resolve_device
from repro_torch.dist.shard import place_table_rows
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.cache import (CellCache, CompiledCell, bound_signature,
                                     mesh_signature)
from repro_torch.serve.cells import (ServeCellDef, packed_lookup_cell,
                                     packed_score_cell, tiered_score_cell)
from repro_torch.serve.queue import (DONE, FAILED, SHED, AdmissionQueue,
                                     RequestFailedError, TenantQuota)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.stats import LatencyStats, RequestStats
from repro_torch.train.tree import tree_map

class RegisteredCell(NamedTuple):
    """A cell after registration: its definition, the warm executable, the
    bound tensors it reads (on the engine's device), and the optional
    Figure-5 lookup-split companion cell."""
    celldef: ServeCellDef
    cell: CompiledCell
    bound: tuple
    lookup: "RegisteredCell | None"


class TieredCell(NamedTuple):
    """A tiered score cell plus the ``TieredTableStore`` that feeds it, the
    per-field id offsets used to globalize request ids for the cold
    prefetch (the cell itself re-globalizes on the device), and on the card
    the cell's double-buffered cold staging."""
    reg: RegisteredCell
    store: object             # repro_torch.cache.TieredTableStore
    offsets: np.ndarray       # (F,) int32
    staging: ColdStaging | None = None

    def stage(self, rows: np.ndarray) -> tuple:
        """One chunk's inputs: its ids padded into the cell's input, and its
        cold fill issued (on the card into the next staging slot, copied
        on the side stream) → (ids tensor, ColdPrefetch). Padding rows are
        not routed: they fetch nothing and stay out of the counters."""
        fill = self.store.prefetch_cold(rows + self.offsets[None, :],
                                        staging=self.staging)
        return self.reg.cell.stage(rows)[0], fill

    def cold_input(self, fill):
        """The cell's cold input holding ``fill``: on the card the graph's
        static buffer, into which the staged copy is copied on the current
        stream once it has landed; on the CPU the fill's own buffer."""
        if self.staging is None:
            return fill.buffer
        fill.wait(self.staging.device)
        cold = self.reg.cell.inputs[1]
        cold[:fill.buffer.numel()].copy_(fill.buffer)
        self.staging.consumed(fill)
        return cold


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _on_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    return tree


def _write_in_place(dst: dict, src: dict):
    """Copy the tree ``src`` into the tensors of ``dst``, key by key, on the
    current stream (the one cells replay on), under the grad mode ``dst``'s
    tensors were made in: an inference tensor is written in inference mode
    only."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _write_in_place(v, src[k])
            continue
        mode = torch.inference_mode() if v.is_inference() else torch.no_grad()
        with mode:
            v.copy_(src[k])


class Engine:
    """Front-end over the cell cache + request batcher, on one device (the
    CUDA card unless ``device`` names another, or the device of a shared
    ``cache``) and one mesh (default: the host mesh — 1×1 in one process,
    where every sharded lookup is the single-device one); cells from
    several models can coexist, keyed by their ``arch`` identity."""

    def __init__(self, device=None, cache: CellCache | None = None,
                 queue_capacity: int = 1024, *, mesh=None,
                 quotas: dict[str, TenantQuota] | None = None,
                 shed_watermark: float = 1.0,
                 coalesce_window_ms: float = 0.0,
                 clock=None):
        if cache is None:
            cache = CellCache(device, mesh=mesh)
        elif device is not None and resolve_device(device).type \
                != cache.device.type:
            raise ValueError(f"engine device {device} differs from its "
                             f"cache's {cache.device}")
        elif mesh is not None and mesh_signature(mesh) \
                != mesh_signature(cache.mesh):
            raise ValueError(f"engine mesh {mesh} differs from its cache's "
                             f"{cache.mesh}")
        self.cache = cache
        self.mesh = cache.mesh
        self.device = cache.device
        full_float32(self.device)   # serving starts here
        # every timestamp in the lifecycle flows from this one callable —
        # inject repro_torch.serve.clock.ManualClock for deterministic tests
        self._clock = clock if clock is not None else time.perf_counter
        self.stats = LatencyStats()
        self.rstats = RequestStats()
        self.queue = AdmissionQueue(queue_capacity, quotas=quotas,
                                    shed_watermark=shed_watermark)
        self.scheduler = Scheduler(self,
                                   coalesce_window_ms=coalesce_window_ms)
        self._requests: dict[int, object] = {}          # ticket -> Request
        self._score: dict[str, RegisteredCell] = {}     # bucket name -> cell
        self._score_batcher = RequestBatcher()
        self._tiered: dict[str, TieredCell] = {}        # bucket name -> cell
        self._tiered_batcher = RequestBatcher()
        self._retrieve: dict[str, RegisteredCell] = {}  # arch -> cell
        self._decode: dict[str, RegisteredCell] = {}    # arch -> cell
        self._pending_swaps: list[tuple] = []           # (arch, table, meta)
        self.swaps_applied = 0
        # traffic-adaptive tiering (repro_torch.cache.policy): one policy
        # drives every registered tiered store; adapters
        # (repro_torch.serve.repack.PressureAdapter) ride the same hook
        self._tier_policy = None
        self._policy_every = 8
        self._policy_rounds = 0
        self._adapters: list = []
        self._hot_seen: dict[str, int] = {}     # shape -> store.hot_version
        self.tier_moves = {"plans": 0, "promotions": 0, "demotions": 0,
                           "bytes": 0}

    # -- registration -------------------------------------------------------

    def _compile(self, celldef: ServeCellDef) -> RegisteredCell:
        bound = tuple(_on_device(b, self.device) for b in celldef.bound)
        # the fingerprint covers config baked into the step closure (model
        # cfg, top_k, …); the bound tensors' addresses, what a graph reads
        key = self.cache.key(
            celldef.arch,
            f"{celldef.shape}@{celldef.batch}#{celldef.fingerprint}",
            bound=bound)

        def build():
            return celldef.step_fn, bound, celldef.request_specs, celldef.meta

        cell = self.cache.get_or_compile(key, build)
        return RegisteredCell(celldef._replace(bound=bound), cell, bound, None)

    def register(self, celldef: ServeCellDef,
                 lookup_cell: ServeCellDef | None = None) -> RegisteredCell:
        """Build (or warm-hit) a cell and route it by kind. Score cells also
        register their capacity as a batcher bucket under their shape name;
        retrieve cells serve ``retrieve`` for their arch, decode cells
        ``decode``, and a slotted decode cell opens the arch's
        continuous-batching session. A decode cell's graph caches, which
        the capture's warm-up calls wrote, are reset to fresh caches."""
        if celldef.kind not in ("score", "retrieve", "decode",
                                "decode_slotted"):
            raise ValueError(f"unroutable cell kind {celldef.kind!r}")
        reg = self._compile(celldef)
        if lookup_cell is not None:
            reg = reg._replace(lookup=self._compile(lookup_cell))
        if celldef.kind.startswith("decode") and reg.cell.inputs:
            _write_in_place(reg.cell.inputs[-1],
                            celldef.make_request_state(device=self.device))
        if celldef.kind == "retrieve":
            self._retrieve[celldef.arch] = reg
        elif celldef.kind == "decode":
            self._decode[celldef.arch] = reg
        elif celldef.kind == "decode_slotted":
            self.scheduler.add_session(celldef.arch, reg)
        else:
            self._score[celldef.shape] = reg
            self._score_batcher.register(celldef.shape, celldef.batch)
        return reg

    def register_packed_model(self, arch, model, cfg, params, state, buffers,
                              *, shapes: dict[str, int],
                              lookup_split: bool = True,
                              rows_axes=("model",),
                              shard_lookup: bool = False,
                              lookup_comms: str = "psum",
                              bucket_capacity: int | None = None):
        """Register one score cell per (shape name → row capacity) for a flat
        CTR model serving from a packed table, each with its lookup-split
        companion when ``lookup_split``. The model's tensors move to the
        engine's device once, here, and every cell reads those tensors; the
        packed table is the cache's own copy (``CellCache.bind``), which a
        swap writes in place and the caller's table never sees.
        ``shard_lookup`` takes the sharded lookup on the engine's mesh (the
        single-device one on a one-rank mesh), subtables row-sharded over
        ``rows_axes``; ``lookup_comms``/``bucket_capacity`` select its merge
        and enter the cell fingerprint. On a mesh of more than one rank the
        bound copy of the table holds only this rank's row blocks, padded
        to the row shards once, here (``CellCache.bind``), and a swap
        writes the new table's blocks into them."""
        state, buffers = (_on_device(t, self.device) for t in (state, buffers))
        row_blocks = bool(shard_lookup) and self.mesh.size > 1
        params = dict(_on_device(params, self.device),
                      embedding=self.cache.bind(
                          params["embedding"], self,
                          rows_axes=tuple(rows_axes) if row_blocks else None))
        meta = {k: cfg.comp_cfg[k] for k in ("bits", "d", "n")}
        n_fields = len(cfg.fields)
        sharding = dict(rows_axes=tuple(rows_axes), shard_lookup=shard_lookup,
                        lookup_comms=lookup_comms,
                        bucket_capacity=bucket_capacity,
                        row_blocks=row_blocks)
        for shape, rows in shapes.items():
            cd = packed_score_cell(model, cfg, params, state, buffers,
                                   batch=rows, arch=arch, shape=shape,
                                   **sharding)
            lc = None
            if lookup_split:
                lc = packed_lookup_cell(params["embedding"], meta,
                                        buffers["offsets"], batch=rows,
                                        n_fields=n_fields, arch=arch,
                                        shape=shape, **sharding)
            self.register(cd, lookup_cell=lc)

    def register_tiered_model(self, arch, model, cfg, params, state, buffers,
                              store, *, shapes: dict[str, int],
                              rows_axes=("model",),
                              shard_lookup: bool = False,
                              lookup_comms: str = "psum",
                              bucket_capacity: int | None = None):
        """Register one **tiered** score cell per (shape name → row capacity)
        serving from a ``repro_torch.cache.TieredTableStore``: the store's
        hot tier binds into the cell (the store's own tensors, on the
        engine's device), cold rows ride each request as staged fills (see
        ``score_tiered``).

        ``params`` may carry an ``"embedding"`` entry (the monolithic packed
        table) — it is dropped; the store owns the table now.
        ``shard_lookup``/``rows_axes``/``lookup_comms``/``bucket_capacity``
        route the hot gather as ``register_packed_model``'s do the packed
        one."""
        if store.device.type != self.device.type:
            raise ValueError(f"the store's hot tier lies on {store.device}, "
                             f"the engine serves on {self.device}")
        state, buffers = (_on_device(t, self.device) for t in (state, buffers))
        p = _on_device({k: v for k, v in params.items() if k != "embedding"},
                       self.device)
        offsets = buffers["offsets"]
        # registration, not a request: the offsets are read once
        offsets = np.asarray(offsets.cpu() if torch.is_tensor(offsets)  # staticcheck: ignore[RL403]
                             else offsets, np.int32)
        for shape, rows in shapes.items():
            cd = tiered_score_cell(model, cfg, p, state, buffers, store.hot,
                                   store.meta, batch=rows, arch=arch,
                                   shape=shape, rows_axes=rows_axes,
                                   shard_lookup=shard_lookup,
                                   lookup_comms=lookup_comms,
                                   bucket_capacity=bucket_capacity)
            reg = self._compile(cd)
            staging = None
            if reg.cell.inputs:   # a graph: its cold input is staged
                staging = ColdStaging(cd.request_specs[1][0][0], self.device)
            self._tiered[shape] = TieredCell(reg, store, offsets, staging)
            self._tiered_batcher.register(shape, rows)
            self._hot_seen[shape] = store.hot_version

    # -- serving-time precision adaptation (repro_torch.serve.repack) -------

    def request_swap(self, table, meta, *, arch: str | None = None):
        """Queue an atomic packed-table swap (serving-time precision
        adaptation, ``repro_torch.serve.repack``).

        The swap applies at the **next ``sched_step`` boundary**, never
        mid-round: the scheduler reads every chunk's output before the round
        ends, so no coalesced batch can see a torn table. The new ``table``
        must match the live table's shapes and dtypes exactly (a
        capacity-conforming repack — ``TableSwapper`` guarantees this): it
        is copied into the bound tensors in place, which the captured graphs
        read by address, so **zero recompiles** occur. Engines on one cache
        that registered over the same table share those tensors, so the
        swap raises while another of them lives: register it over a table
        of its own to swap one engine alone."""
        self._pending_swaps.append((arch, table, dict(meta)))

    def live_packed_table(self, *, arch: str | None = None):
        """The packed table (tensors on the engine's device) bound into the
        score cells of ``arch`` — the shape template a repack must conform
        to."""
        for reg in self._score.values():
            if arch is None or reg.celldef.arch == arch:
                return reg.bound[0]["embedding"]
        raise ValueError(f"no packed score cell registered for arch={arch!r}")

    def _apply_swaps(self):
        while self._pending_swaps:
            arch, table, meta = self._pending_swaps.pop(0)
            self._swap_now(arch, table, meta)

    def _swap_now(self, arch, table, meta):
        regs = [reg for reg in self._score.values()
                if arch is None or reg.celldef.arch == arch]
        tiered = {shape: tc for shape, tc in self._tiered.items()
                  if arch is None or tc.reg.celldef.arch == arch}
        if not regs and not tiered:
            raise ValueError(
                f"table swap targets no registered cell (arch={arch!r})")
        live = [(reg.bound[0]["embedding"], reg.celldef.meta)
                for reg in regs]
        live += [(reg.lookup.bound[0], reg.lookup.celldef.meta)
                 for reg in regs if reg.lookup is not None]
        # a table bound as this rank's row blocks takes the new one's blocks
        live = [(old, place_table_rows(table, self.mesh, meta["rows_axes"])
                 if meta.get("row_blocks") else table)
                for old, meta in live]
        for old, new in live:
            self._check_swap_layout(old, new, "packed-table")
        # the score cells and their lookup companions read one table
        tables = list({old["width_idx"].data_ptr(): (old, new)
                       for old, new in live}.values())
        for old, _ in tables:
            others = self._sharers(old)
            if others:
                raise ValueError(
                    f"table swap would change the scores of {others} "
                    f"other engine(s) registered over the same packed table "
                    f"on this cache; register them over a table of their "
                    f"own")
        for old, new in tables:
            _write_in_place(old, new)
        refreshed = set()
        for shape, tc in tiered.items():
            if id(tc.store) not in refreshed:    # one refresh per store
                refreshed.add(id(tc.store))
                tc.store.refresh(table, meta)
            self._tiered[shape] = self._rebind_hot(tc)
            self._hot_seen[shape] = tc.store.hot_version
        self.swaps_applied += 1

    def _sharers(self, table) -> int:
        """How many other live engines read the bound ``table``."""
        n = sum(e is not self for e in self.cache.holders(table))
        if n:
            gc.collect()     # an engine is a reference cycle: drop dead ones
            n = sum(e is not self for e in self.cache.holders(table))
        return n

    @staticmethod
    def _check_swap_layout(old, new, what: str):
        """A swap must be invisible to the executable: identical tree
        structure, shapes and dtypes — otherwise the captured graph could
        not read it."""
        def sig(tree):
            return tree_map(lambda x: (tuple(x.shape), str(x.dtype)), tree)
        if sig(old) != sig(new):
            raise ValueError(
                f"table swap would change the compiled {what} layout — "
                f"repack with row_capacities pinned to the live table "
                f"(repro_torch.serve.repack.subtable_capacities)")

    # -- traffic-adaptive tiering (repro_torch.cache.policy) ----------------

    def attach_tier_policy(self, policy, *, every: int = 8):
        """Wire an admission/eviction policy (``cache.DecayAdmissionPolicy``
        or ``cache.StaticTierPolicy``) into the serving loop: every
        registered tiered store feeds its lookup stream to the policy, and
        every ``every``-th ``sched_step`` the policy plans a bounded batch
        of promotions/demotions that the stores apply incrementally, in
        place — no re-pack, no recapture. Returns the policy."""
        stores = self._tier_stores()
        if not stores:
            raise ValueError(
                "attach_tier_policy requires a registered tiered model "
                "(register_tiered_model)")
        for store in stores:
            store.attach_policy(policy)
        self._tier_policy = policy
        self._policy_every = int(every)
        return policy

    def attach_adapter(self, adapter):
        """Register a drift adapter (``repro_torch.serve.repack.
        PressureAdapter``) on the policy cadence hook: ``adapter.step(
        engine)`` runs once per ``sched_step``, after tier moves apply — the
        adapter decides its own cadence and may queue atomic table swaps
        (``request_swap``), which land at the *next* round's swap point."""
        self._adapters.append(adapter)
        return adapter

    def _tier_stores(self) -> list:
        """The distinct ``TieredTableStore``s behind the tiered cells (one
        store usually backs several shape buckets)."""
        stores, seen = [], set()
        for tc in self._tiered.values():
            if id(tc.store) not in seen:
                seen.add(id(tc.store))
                stores.append(tc.store)
        return stores

    def _policy_step(self):
        if self._tier_policy is None and not self._adapters:
            return
        self._policy_rounds += 1
        if (self._tier_policy is not None
                and self._policy_rounds % self._policy_every == 0):
            for store in self._tier_stores():
                plan = self._tier_policy.plan(store)
                self.tier_moves["plans"] += 1
                if plan.n_moves:
                    s = store.apply_moves(plan.promote, plan.demote)
                    self.tier_moves["promotions"] += s["promotions"]
                    self.tier_moves["demotions"] += s["demotions"]
                    self.tier_moves["bytes"] += s["bytes"]
        for adapter in self._adapters:
            adapter.step(self)
        self._sync_tiered()

    def _sync_tiered(self):
        """Check every tiered cell whose store wrote its hot tier
        (promotions, writebacks) since the last sync — the counterpart of
        the reference's rebind: the store wrote in place, so there is
        nothing to rebind, only the layout to hold."""
        for shape, tc in list(self._tiered.items()):
            if self._hot_seen.get(shape) != tc.store.hot_version:
                self._tiered[shape] = self._rebind_hot(tc)
                self._hot_seen[shape] = tc.store.hot_version

    def _rebind_hot(self, tc: TieredCell) -> TieredCell:
        """The reference re-``device_put``s the store's new hot arrays; the
        port's store wrote its tensors in place, which the cell's graph
        reads by address. What stays is the check: the cell must still read
        the store's tensors, at the same shapes and addresses."""
        reg = tc.reg
        hot_i = len(reg.bound) - 1          # (params, state, buffers, hot)
        self._check_swap_layout(reg.bound[hot_i], tc.store.hot, "hot-tier")
        if bound_signature(reg.bound[hot_i]) != bound_signature(tc.store.hot):
            raise RuntimeError(
                f"the tiered cell {reg.celldef.name} no longer reads its "
                f"store's hot tier: a store must write its tensors in place")
        return tc

    def writeback_embeddings(self, ids, vectors) -> dict:
        """Flow training-time embedding updates (global feature ids →
        full-precision vectors) into every registered tiered store:
        re-quantized under each feature's current width, mirror written
        first, hot copies patched in place. Call between scheduling
        rounds."""
        out = {"written": 0, "bytes": 0}
        for store in self._tier_stores():
            s = store.writeback(ids, vectors)
            out["written"] += s["written"]
            out["bytes"] += s["bytes"]
        self._sync_tiered()
        return out

    # -- request lifecycle: submit / poll / drain ---------------------------

    def _timed_call(self, reg: RegisteredCell, *request):
        t0 = self._clock()
        out = reg.cell.compiled(*request)
        if self.device.type == "cuda":
            # deliberate timing barrier: wall-clock per call is the product
            torch.cuda.synchronize(self.device)  # staticcheck: ignore[RL403]
        return out, (self._clock() - t0) * 1e3

    def submit(self, ids, *, kind: str = "score",
               deadline_ms: float | None = None, now: float | None = None,
               overlap: bool = True, tenant: str = "default",
               priority: int = 0) -> int | None:
        """Admit an (n, F) scoring request into the queue -> ticket, or None
        when the admission policy sheds it (queue full, load watermark, or
        tenant queue-share quota; all counted per kind and tenant).

        ``kind`` routes the request to a lane: ``"score"`` (packed cells) or
        ``"tiered"`` (hot/cold store cells, where ``overlap`` controls the
        one-chunk-ahead cold-fill staging). ``tenant``/``priority`` place
        the request in the multi-tenant
        scheduling lanes (priority 0 is most urgent; dispatch is EDF within
        a lane). ``now`` overrides the arrival timestamp for open-loop
        replay; ``deadline_ms`` is relative to it — requests still queued
        past their deadline are shed at drain."""
        if kind not in ("score", "tiered"):
            raise ValueError(
                f"unroutable request kind {kind!r} (use 'score' or 'tiered'; "
                f"LM generation goes through submit_decode)")
        ids = np.asarray(ids, np.int32)
        req = self.queue.submit(
            kind, ids, ids.shape[0],
            now=self._clock() if now is None else now,
            deadline_ms=deadline_ms,
            meta={"overlap": overlap} if kind == "tiered" else None,
            tenant=tenant, priority=priority)
        if req is None:
            self.rstats.record_shed(kind, tenant=tenant)
            return None
        self._requests[req.ticket] = req
        return req.ticket

    def submit_decode(self, prompt, max_new: int, *, arch: str | None = None,
                      deadline_ms: float | None = None,
                      now: float | None = None, tenant: str = "default",
                      priority: int = 0) -> int | None:
        """Admit an LM generation request (prompt replay + ``max_new`` greedy
        tokens) into the continuous-batching decode lane -> ticket, or None
        when shed. Requires a registered ``lm_decode_slotted_cell``; the
        sequence joins the running decode batch when a KV-cache slot frees
        up, without a new capture or a restart of the batch."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        session = self.scheduler._pick_session(arch)
        if prompt.shape[0] + int(max_new) > session.max_len:
            raise ValueError(
                f"sequence of {prompt.shape[0]}+{int(max_new)} tokens exceeds "
                f"the cell's max_len={session.max_len}")
        req = self.queue.submit(
            "decode", (prompt, int(max_new), arch), 1,
            now=self._clock() if now is None else now,
            deadline_ms=deadline_ms, tenant=tenant, priority=priority)
        if req is None:
            self.rstats.record_shed("decode", tenant=tenant)
            return None
        self._requests[req.ticket] = req
        return req.ticket

    def poll(self, ticket: int):
        """The completed result for ``ticket`` — scored requests return the
        (n,) logits, decode requests the generated tokens — or None while
        the request is still queued/in flight. Raises ``RuntimeError`` on a shed
        ticket and ``RequestFailedError`` on a ticket whose dispatch raised.

        A finished ticket (done, shed or failed) is consumed by its poll;
        polling it again raises KeyError."""
        req = self._requests[ticket]
        if req.status == SHED:
            del self._requests[ticket]
            raise RuntimeError(
                f"request {ticket} was shed (deadline passed while queued)")
        if req.status == FAILED:
            del self._requests[ticket]
            raise RequestFailedError(
                f"request {ticket} failed in dispatch: {req.error}")
        if req.status != DONE:
            return None
        del self._requests[ticket]
        return req.result

    def try_poll(self, ticket: int) -> dict:
        """Non-raising poll for harness code (the socket server): always
        returns ``{"status": ...}`` — ``pending``, ``done`` (+ ``result``),
        ``shed``, ``failed`` (+ ``error``), or ``unknown`` (never issued, or
        already consumed). Terminal tickets are consumed like ``poll``."""
        req = self._requests.get(ticket)
        if req is None:
            return {"status": "unknown"}
        if req.status == SHED:
            del self._requests[ticket]
            return {"status": "shed"}
        if req.status == FAILED:
            del self._requests[ticket]
            return {"status": "failed", "error": req.error}
        if req.status != DONE:
            return {"status": "pending"}
        del self._requests[ticket]
        return {"status": "done", "result": req.result}

    def sched_step(self, *, now: float | None = None) -> float:
        """Run one scheduling round (coalesce + dispatch the score lane).
        ``now=None`` uses the engine's clock; an explicit ``now`` threads a
        virtual open-loop timeline through the dispatch timestamps and
        returns the advanced cursor.

        Queued table swaps (``request_swap``) apply here, *before* the round
        dispatches — the atomic swap point: every chunk of a round reads
        the same table. The tier policy and drift adapters run right after
        the swap point (``_policy_step``), so tier moves are likewise never
        observed mid-round."""
        self._apply_swaps()
        self._policy_step()
        return self.scheduler.step(now=now)

    def drain(self, *, now: float | None = None) -> float:
        """Scheduling rounds until the queue is empty. Returns the final
        clock cursor."""
        cursor = now
        while self.scheduler.busy:
            cursor = self.sched_step(now=cursor)
        return cursor if cursor is not None else self._clock()

    # -- synchronous wrappers (submit + drain + poll) -----------------------

    def score(self, ids, *, return_logits: bool = False) -> np.ndarray:
        """Score an (n, F) id batch; any n — the scheduler packs it onto the
        registered cell shapes. Returns probabilities (or raw logits)."""
        ticket = self.submit(ids)
        if ticket is None:
            raise RuntimeError("request shed: admission queue full")
        self.drain()
        out = self.poll(ticket)
        return out if return_logits else _sigmoid(out)

    def score_tiered(self, ids, *, overlap: bool = True,
                     return_logits: bool = False) -> np.ndarray:
        """Score an (n, F) id batch through the tiered hot/cold store.

        Hot rows are gathered on the device inside the cell; each chunk's
        cold-row fill (packed words, host-gathered) is staged **one chunk
        ahead** while the previous chunk's cell is still computing, so the
        cold transfer hides under compute. ``overlap=False`` stages each
        fill synchronously right before its dispatch. Results are identical
        either way (the pipeline only moves bytes earlier)."""
        ticket = self.submit(ids, kind="tiered", overlap=overlap)
        if ticket is None:
            raise RuntimeError("request shed: admission queue full")
        self.drain()
        out = self.poll(ticket)
        return out if return_logits else _sigmoid(out)

    def tier_counters(self) -> dict:
        """Per-bucket ``TieredTableStore.counters()`` (stores may be shared
        across buckets, in which case the numbers repeat)."""
        return {name: tc.store.counters()
                for name, tc in sorted(self._tiered.items())}

    def retrieve(self, user_ids, cand_ids, *, arch: str | None = None):
        """Top-k retrieval of one user against a candidate corpus of any
        size. An oversized corpus is chunked onto the cell's candidate
        capacity and the per-chunk top-ks merged; padded candidates are
        masked to -inf inside the cell. Returns (scores, indices) as numpy,
        sorted by score, best first."""
        reg = self._pick(self._retrieve, arch, "retrieval")
        cap = reg.celldef.batch
        top_k = reg.celldef.meta["top_k"]
        user = np.asarray(user_ids, np.int32)
        cand_ids = np.asarray(cand_ids, np.int32)
        all_scores, all_idx = [], []
        for start in range(0, cand_ids.shape[0], cap):
            part = cand_ids[start:start + cap]
            request = reg.cell.stage(user, part,
                                     np.ones((part.shape[0],), bool))
            (scores, idx), total_ms = self._timed_call(reg, *request)
            self.stats.record(reg.celldef.name, total_ms)
            keep = min(top_k, part.shape[0])
            # read before the next replay writes the graph's outputs
            all_scores.append(scores[:keep].cpu().numpy())  # staticcheck: ignore[RL403]
            all_idx.append(idx[:keep].cpu().numpy() + start)  # staticcheck: ignore[RL403]
        scores = np.concatenate(all_scores)
        idx = np.concatenate(all_idx)
        order = np.argsort(-scores)[:top_k]
        return scores[order], idx[order]

    @staticmethod
    def _pick(table: dict, arch: str | None, what: str) -> RegisteredCell:
        if not table:
            raise ValueError(f"no {what} cell registered")
        if arch is not None:
            return table[arch]
        if len(table) > 1:
            raise ValueError(
                f"multiple {what} cells registered ({sorted(table)}); "
                f"pass arch=")
        return next(iter(table.values()))

    def decode(self, tokens, caches=None, *, arch: str | None = None):
        """One decode step for a (b, 1) token batch, b ≤ the cell's capacity.
        ``caches=None`` starts fresh KV caches (int8 + running-absmax scales
        when the cell was registered with ``kv_int8``, the default). Returns
        (logits (b, V) as float32 numpy, new_caches) — feed ``new_caches``
        back in. On the card they are the cell's own caches, written in
        place: the caches passed in are copied into them unless they are
        them already, and the next replay writes over them."""
        reg = self._pick(self._decode, arch, "decode")
        tokens = np.asarray(tokens, np.int32)
        b = tokens.shape[0]
        toks = reg.cell.stage(tokens)[0]
        if caches is None:
            caches = self.fresh_caches(arch=reg.celldef.arch)
        (logits, new_caches), total_ms = self._timed_call(reg, toks, caches)
        self.stats.record(reg.celldef.name, total_ms)
        # the request's answer goes to the host
        return logits[:b].to(torch.float32).cpu().numpy(), new_caches  # staticcheck: ignore[RL403]

    def fresh_caches(self, *, arch: str | None = None):
        """Fresh KV caches for a decode cell on the engine's device — built
        by the model's own cache constructor (bound at cell build time, so
        layout and scale seeding stay the model's)."""
        reg = self._pick(self._decode, arch, "decode")
        return reg.celldef.make_request_state(device=self.device)

    # -- introspection ------------------------------------------------------

    def registered_cells(self) -> dict:
        """Every registered cell, keyed by its ``CellKey``: {key:
        RegisteredCell}; tiered cells unwrap to their ``RegisteredCell``,
        lookup-split companions under their own keys."""
        out = {}
        regs = list(self._score.values())
        regs += [tc.reg for tc in self._tiered.values()]
        regs += list(self._retrieve.values())
        regs += list(self._decode.values())
        regs += [session.reg for session in self.scheduler.sessions.values()]
        for reg in regs:
            for r in (reg, reg.lookup):
                if r is not None:
                    out[r.cell.key] = r
        return out

    @property
    def compile_count(self) -> int:
        return self.cache.compiles

    @property
    def registered_shapes(self) -> dict:
        """The score-path cell-shape registry: shape name → row capacity."""
        return self._score_batcher.shapes

    def counters(self) -> dict:
        """Cell-cache counters plus per-cell occupancy (valid rows / padded
        rows over every dispatch — the coalescing win), the admission
        queue's depth/shed counters (per kind and per tenant), goodput —
        completed-request counts — split by lane and by tenant, and the
        tier policy's moves."""
        out = dict(self.cache.counters())
        out["occupancy"] = self.stats.occupancy()
        out["queue"] = self.queue.counters()
        out["goodput"] = {"by_lane": self.rstats.lane_counts(),
                          "by_tenant": self.rstats.tenant_counts()}
        out["tier_moves"] = dict(self.tier_moves)
        return out

    def summary(self, *, skip_warmup: int = 0) -> dict:
        """Per-cell latency percentiles (Figure-5 lookup/compute split) with
        per-cell ``occupancy`` merged in where dispatches recorded it."""
        return self.stats.summary(skip_warmup=skip_warmup)

    def request_summary(self, *, skip_warmup: int = 0,
                        by: str = "kind") -> dict:
        """Per-request breakdown: end-to-end latency plus the three-way
        queue-wait / batch-assembly / compute split. ``by`` groups the
        records: ``"kind"``, ``"lane"`` (``kind:p<priority>``) or
        ``"tenant"`` (with per-tenant shed/failed counts)."""
        summaries = {"kind": self.rstats.summary,
                     "lane": self.rstats.lane_summary,
                     "tenant": self.rstats.tenant_summary}
        return summaries[by](skip_warmup=skip_warmup)
