"""Coalescing scheduler: the dispatch edge of the request lifecycle.

The port of the reference's ``repro.serve.scheduler`` for the score and
tiered lanes.
The scheduler drains the ``AdmissionQueue`` and turns *many* callers'
requests into *few* cell-shaped dispatches on the captured-cell substrate
(``CellCache`` executables — never rebuilt, never reshaped):

  - **score / tiered lanes** — pending requests come out of the queue in
    priority/EDF order (the queue owns lane ordering and per-tenant quotas)
    and are coalesced by ``RequestBatcher.pack`` into the registered cell
    shapes: one padded cell call carries row spans from many requests, and
    the outputs scatter back per requester (``Chunk.spans``). A tiered
    chunk's cold rows are staged one chunk ahead of the replay that reads
    them.
  - **max-wait coalescing window** — with ``coalesce_window_ms > 0`` the
    lane *holds* a light load (fewer pending rows than the smallest
    registered bucket) for up to the window, trading p99 for occupancy; the
    window expires against the same clock that stamps arrivals. ``0`` (the
    default) dispatches immediately.
  - **fault isolation** — a dispatch that raises fails only the requests
    riding that chunk (status ``FAILED``; ``poll`` re-raises with the
    original error); every other pending request keeps flowing and the
    engine stays drainable.

Time is driven by the caller: ``step(now=None)`` uses the engine's clock
(live serving), while an explicit ``now`` advances a virtual timeline by
measured work (deterministic open-loop replay — ``launch/serve.py --qps``).
The clock is read at the reference's points and in its order, so a replay
under ``TickClock`` follows the reference's trajectory. The decode lane
comes with ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.queue import DISPATCHED, DONE, FAILED

# lanes the scheduler coalesces through RequestBatcher.pack
SCORED_KINDS = ("score", "tiered")


class Scheduler:
    """Drains the admission queue into coalesced cell dispatches.

    One ``step`` handles the score and tiered lanes once each, in the
    queue's priority/EDF
    order, subject to tenant quotas and the max-wait window. ``step``
    returns the advanced ``now`` cursor so an open-loop replay can thread a
    virtual timeline through it — when a round dispatches nothing because
    the lane is holding for its coalescing window, the returned cursor
    jumps to the window's expiry so virtual drains terminate.
    """

    def __init__(self, engine, *, coalesce_window_ms: float = 0.0):
        if coalesce_window_ms < 0:
            raise ValueError(
                f"coalesce_window_ms must be >= 0, got {coalesce_window_ms}")
        self.engine = engine
        self.coalesce_window_ms = float(coalesce_window_ms)
        self._progress = False     # did this step dispatch anything?

    @property
    def busy(self) -> bool:
        return bool(len(self.engine.queue))

    # -- clock helpers ------------------------------------------------------

    def _advance(self, cursor: float, elapsed_s: float, wall: bool) -> float:
        return self.engine._clock() if wall else cursor + elapsed_s

    def _next_window_expiry(self) -> float | None:
        """Earliest max-wait-window expiry across lanes with pending work."""
        if self.coalesce_window_ms <= 0:
            return None
        window_s = self.coalesce_window_ms / 1e3
        oldest = [self.engine.queue.oldest_arrival(kind)
                  for kind in SCORED_KINDS]
        expiries = [t + window_s for t in oldest if t is not None]
        return min(expiries) if expiries else None

    # -- one scheduling round ----------------------------------------------

    def step(self, *, now: float | None = None) -> float:
        wall = now is None
        cursor = self.engine._clock() if wall else float(now)
        self._progress = False
        cursor = self._dispatch_scored("score", cursor, wall)
        cursor = self._dispatch_scored("tiered", cursor, wall)
        if not wall and not self._progress:
            # the lane held for its coalescing window: jump the virtual
            # cursor to the expiry so drain() terminates. The hold test is
            # ``now - arrival < window``, which at ``now = arrival + window``
            # can still hold by the rounding of the sum; a cursor already
            # at the expiry moves one float step on, or the round would
            # repeat forever (the reference's scheduler does)
            expiry = self._next_window_expiry()
            if expiry is not None:
                cursor = expiry if expiry > cursor \
                    else float(np.nextafter(cursor, np.inf))
        return cursor

    def _shed_expired(self, expired):
        for req in expired:
            self.engine.rstats.record_shed(req.kind, tenant=req.tenant)

    # -- score / tiered lanes ------------------------------------------------

    def _take(self, kind: str, cursor: float):
        """Drain one scored lane, applying the max-wait coalescing window:
        below the smallest bucket's row count the lane holds (everything
        stays queued) until the oldest pending request ages past the
        window."""
        engine = self.engine
        if self.coalesce_window_ms > 0:
            batcher = (engine._score_batcher if kind == "score"
                       else engine._tiered_batcher)
            shapes = batcher.shapes
            min_rows = min(shapes.values()) if shapes else 0
            return engine.queue.take(kind, now=cursor, min_rows=min_rows,
                                     max_wait_s=self.coalesce_window_ms / 1e3)
        return engine.queue.take(kind, now=cursor)

    def _fail_chunk(self, ready, chunk, err: Exception, cursor: float,
                    kind: str):
        """Fault isolation: a dispatch raised — fail exactly the requests
        with rows in this chunk (later chunks skip their spans), release
        their quota, and keep the round going."""
        msg = f"{type(err).__name__}: {err}"
        for span in chunk.spans:
            req = ready[span.req]
            if req.status == FAILED:
                continue
            req.status = FAILED
            req.error = msg
            req.complete_t = cursor
            self.engine.queue.release(req)
            self.engine.rstats.record_failed(kind, tenant=req.tenant)

    def _dispatch_scored(self, kind: str, cursor: float, wall: bool) -> float:
        engine = self.engine
        ready, expired = self._take(kind, cursor)
        self._shed_expired(expired)
        if not ready:
            return cursor
        self._progress = True

        for req in ready:
            req.result = np.empty((req.n_rows,), np.float32)
        batcher = (engine._score_batcher if kind == "score"
                   else engine._tiered_batcher)
        chunks = batcher.pack([r.n_rows for r in ready])

        if kind == "tiered":
            return self._dispatch_tiered(ready, chunks, cursor, wall)

        for chunk in chunks:
            reg = engine._score[chunk.bucket]
            try:
                t0 = engine._clock()
                rows = RequestBatcher.gather([r.payload for r in ready], chunk)
                # padded to the cell's rows in its pinned staging buffer, on
                # to its static input: no padded copy of the ids on the host
                x = reg.cell.stage(rows)
                assembly_ms = (engine._clock() - t0) * 1e3
                self._mark_dispatch(ready, chunk, cursor)
                y, total_ms = engine._timed_call(reg, *x)
                # read before the next replay: the cells share one pool
                y = y.cpu().numpy()
            except Exception as err:   # fault injection: fail only this chunk
                self._fail_chunk(ready, chunk, err, cursor, kind)
                continue
            lookup_ms = None
            if reg.lookup is not None:
                try:
                    _, lookup_ms = engine._timed_call(reg.lookup, *x)
                except Exception:   # stats companion only — the chunk's
                    lookup_ms = None    # results already computed fine
            engine.stats.record(reg.celldef.name, total_ms, lookup_ms,
                                valid_rows=chunk.n_valid,
                                capacity_rows=chunk.rows)
            cursor = self._advance(cursor, (assembly_ms + total_ms) / 1e3,
                                   wall)
            self._scatter(ready, chunk, y, assembly_ms, total_ms, cursor,
                          kind)
        return cursor

    def _dispatch_tiered(self, ready, chunks, cursor: float,
                         wall: bool) -> float:
        """Tiered chunks stage each chunk's cold fill one chunk ahead of the
        in-flight replay (on the card: gathered into one of the cell's two
        pinned slots and copied on a side stream while the other slot's
        copy is read). ``overlap=False`` on every coalesced request stages
        synchronously. The clock is read where the reference reads it."""
        engine = self.engine
        overlap = all((r.meta or {}).get("overlap", True) for r in ready)
        payloads = [r.payload for r in ready]
        cuda = engine.device.type == "cuda"

        def stage(chunk):
            t0 = engine._clock()
            tc = engine._tiered[chunk.bucket]
            rows = RequestBatcher.gather(payloads, chunk)
            x, fill = tc.stage(rows)
            return tc, x, fill, (engine._clock() - t0) * 1e3

        def safe_stage(chunk):
            try:
                return stage(chunk)
            except Exception as err:   # staged one ahead: defer to its chunk
                return err

        staged = safe_stage(chunks[0]) if overlap else None
        for k, chunk in enumerate(chunks):
            try:
                if overlap:
                    if isinstance(staged, Exception):
                        raise staged
                    tc, x, fill, assembly_ms = staged
                else:
                    tc, x, fill, assembly_ms = stage(chunk)
                self._mark_dispatch(ready, chunk, cursor)
                t0 = engine._clock()
                y = tc.reg.cell.compiled(x, tc.cold_input(fill))
                if overlap and k + 1 < len(chunks):
                    staged = safe_stage(chunks[k + 1])   # under y's replay
                if cuda:
                    # deliberate timing barrier: chunk latency feeds stats
                    torch.cuda.synchronize(engine.device)
                total_ms = (engine._clock() - t0) * 1e3
                # read before the next replay: the cells share one pool
                y = y.cpu().numpy()
            except Exception as err:   # fault injection: fail only this chunk
                self._fail_chunk(ready, chunk, err, cursor, "tiered")
                if overlap and k + 1 < len(chunks):
                    staged = safe_stage(chunks[k + 1])
                continue
            engine.stats.record(tc.reg.celldef.name, total_ms,
                                valid_rows=chunk.n_valid,
                                capacity_rows=chunk.rows)
            cursor = self._advance(cursor, (assembly_ms + total_ms) / 1e3,
                                   wall)
            self._scatter(ready, chunk, y, assembly_ms, total_ms, cursor,
                          "tiered")
        return cursor

    @staticmethod
    def _mark_dispatch(ready, chunk, cursor: float):
        for span in chunk.spans:
            req = ready[span.req]
            if req.dispatch_t is None:
                req.status = DISPATCHED
                req.dispatch_t = cursor
                req.queue_ms = (cursor - req.arrival_t) * 1e3

    def _scatter(self, ready, chunk, y: np.ndarray, assembly_ms: float,
                 compute_ms: float, cursor: float, kind: str):
        """Write a chunk's outputs back per requester and complete requests
        whose rows all arrived; assembly/compute attribute to requests in
        proportion to their rows in the chunk."""
        live = [s for s in chunk.spans if ready[s.req].status != FAILED]
        RequestBatcher.scatter(
            y, chunk._replace(spans=tuple(live)), [r.result for r in ready])
        for span in live:
            req = ready[span.req]
            frac = span.n / chunk.n_valid
            req.assembly_ms += assembly_ms * frac
            req.compute_ms += compute_ms * frac
            req.rows_done += span.n
            if req.rows_done == req.n_rows:
                req.status = DONE
                req.complete_t = cursor
                req.payload = None      # drop the ids; only the result stays
                self.engine.queue.release(req)
                self.engine.rstats.record(
                    kind, queue_ms=req.queue_ms, assembly_ms=req.assembly_ms,
                    compute_ms=req.compute_ms, latency_ms=req.latency_ms,
                    tenant=req.tenant, priority=req.priority)
