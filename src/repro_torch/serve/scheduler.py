"""Coalescing scheduler + continuous-batching decode: the dispatch edge of
the request lifecycle.

The port of the reference's ``repro.serve.scheduler``.
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
  - **decode lane** — a ``DecodeSession`` per registered
    ``lm_decode_slotted_cell`` runs *continuous batching*: the batch dim is
    a pool of KV-cache slots with a free-list; a request joins by taking a
    free slot at length 0 and replaying its prompt token by token through
    the running batch (other slots keep decoding their own sequences), and
    a finished sequence's slot is recycled for the next waiting request
    without a new capture. On the card the session's caches are the cell's
    static graph inputs, written in place by every replay.
  - **fault isolation** — a dispatch that raises fails only the requests
    riding that chunk (status ``FAILED``; ``poll`` re-raises with the
    original error) and, on the decode lane, recycles the failed jobs' KV
    slots; every other pending request keeps flowing and the engine stays
    drainable.

Time is driven by the caller: ``step(now=None)`` uses the engine's clock
(live serving), while an explicit ``now`` advances a virtual timeline by
measured work (deterministic open-loop replay — ``launch/serve.py --qps``).
The clock is read at the reference's points and in its order, so a replay
under ``TickClock`` follows the reference's trajectory.

Under a ``torch.profiler`` the scored lanes' phases are spans
(``repro_torch.spans``), children of the engine's ``serve.round``:
``serve.take`` (the take, its shedding and the result buffers) and
``serve.pack``, then for each score chunk ``serve.gather``, ``serve.stage``
(``CompiledCell.stage``), ``serve.replay``, ``serve.wait``,
``serve.readback``, ``serve.lookup_split`` (the Figure-5 companion's call)
and ``serve.scatter`` (the stats and the requests' results).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.queue import DISPATCHED, DONE, FAILED

# lanes the scheduler coalesces through RequestBatcher.pack (decode is the
# continuous-batching lane and paces itself)
SCORED_KINDS = ("score", "tiered")


class DecodeJob:
    """One generation request inside a ``DecodeSession``: replay the prompt,
    then greedy-decode ``max_new`` tokens."""
    __slots__ = ("req", "prompt", "fed", "out", "max_new")

    def __init__(self, req, prompt: np.ndarray, max_new: int):
        self.req = req
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.fed = 0          # tokens fed into the cell so far
        self.out: list[int] = []
        self.max_new = int(max_new)

    def next_token(self) -> int:
        """The next input token: prompt replay first, then feed back the
        previously generated token."""
        if self.fed < len(self.prompt):
            return int(self.prompt[self.fed])
        return self.out[self.fed - len(self.prompt)]

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class DecodeSession:
    """A persistent decode batch: one slotted cell, one device-resident KV
    cache whose batch dim is a slot pool, and the free-list that recycles
    slots between steps. On the card the caches are the cell's static
    graph inputs (which the engine resets to fresh caches at
    registration); on the CPU fresh caches of the cell's own making."""

    def __init__(self, reg, device):
        self.reg = reg
        self.cap = reg.celldef.batch
        self.max_len = reg.celldef.meta["max_len"]
        static = reg.cell.inputs
        self.caches = (static[2] if static
                       else reg.celldef.make_request_state(device=device))
        self.lens = np.zeros((self.cap,), np.int32)
        self.free = list(range(self.cap - 1, -1, -1))
        self.active: dict[int, DecodeJob] = {}
        self.waiting: list[DecodeJob] = []
        self.steps = 0

    def admit(self, job: DecodeJob):
        if len(job.prompt) + job.max_new > self.max_len:
            raise ValueError(
                f"sequence of {len(job.prompt)}+{job.max_new} tokens exceeds "
                f"the cell's max_len={self.max_len}")
        self.waiting.append(job)

    @property
    def busy(self) -> bool:
        return bool(self.active or self.waiting)

    def join_waiting(self, now: float):
        """Move waiting jobs into free cache slots (joining the running
        batch is the job's dispatch moment)."""
        while self.waiting and self.free:
            slot = self.free.pop()
            job = self.waiting.pop(0)
            self.lens[slot] = 0
            self.active[slot] = job
            job.req.status = DISPATCHED
            job.req.dispatch_t = now
            job.req.queue_ms = (now - job.req.arrival_t) * 1e3

    def step_tokens(self) -> np.ndarray:
        tokens = np.zeros((self.cap, 1), np.int32)
        for slot, job in self.active.items():
            tokens[slot, 0] = job.next_token()
        return tokens

    def advance(self, logits: np.ndarray, step_ms: float, assembly_ms: float,
                now: float, rstats, queue) -> list[DecodeJob]:
        """Account one decode step: feed counters advance, prompt-done slots
        emit a greedy token, finished jobs release their slot. Returns the
        jobs completed this step."""
        completed = []
        share = step_ms / max(len(self.active), 1)
        asm_share = assembly_ms / max(len(self.active), 1)
        for slot, job in list(self.active.items()):
            job.fed += 1
            self.lens[slot] += 1
            job.req.compute_ms += share
            job.req.assembly_ms += asm_share
            if job.fed >= len(job.prompt):
                job.out.append(int(np.argmax(logits[slot])))
            if job.done:
                req = job.req
                req.result = np.asarray(job.out, np.int32)
                req.status = DONE
                req.complete_t = now
                req.payload = None
                queue.release(req)
                rstats.record("decode", queue_ms=req.queue_ms or 0.0,
                              assembly_ms=req.assembly_ms,
                              compute_ms=req.compute_ms,
                              latency_ms=req.latency_ms,
                              tenant=req.tenant, priority=req.priority)
                del self.active[slot]
                self.free.append(slot)   # recycled, never recaptured
                completed.append(job)
        self.steps += 1
        return completed

    def fail_active(self, err: Exception, now: float, rstats, queue):
        """A decode dispatch raised: fail every active job, recycle their KV
        slots (stale cache contents are harmless: a joining job resets its
        slot's length to 0), and leave waiting jobs queued."""
        msg = f"{type(err).__name__}: {err}"
        for slot, job in list(self.active.items()):
            req = job.req
            req.status = FAILED
            req.error = msg
            req.complete_t = now
            req.payload = None
            queue.release(req)
            rstats.record_failed("decode", tenant=req.tenant)
            del self.active[slot]
            self.free.append(slot)


class Scheduler:
    """Drains the admission queue into coalesced cell dispatches.

    One ``step`` handles the score and tiered lanes once each, in the
    queue's priority/EDF order, subject to tenant quotas and the max-wait
    window; every decode session with active slots advances one token.
    ``step``
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
        self.sessions: dict[str, DecodeSession] = {}   # arch -> session
        self._progress = False     # did this step dispatch anything?

    def add_session(self, arch: str, reg) -> DecodeSession:
        session = DecodeSession(reg, self.engine.device)
        self.sessions[arch] = session
        return session

    @property
    def busy(self) -> bool:
        return bool(len(self.engine.queue)
                    or any(s.busy for s in self.sessions.values()))

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
        cursor = self._dispatch_decode(cursor, wall)
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
        with spans.span("serve.take"):
            ready, expired = self._take(kind, cursor)
            self._shed_expired(expired)
            for req in ready:
                req.result = np.empty((req.n_rows,), np.float32)
        if not ready:
            return cursor
        self._progress = True

        batcher = (engine._score_batcher if kind == "score"
                   else engine._tiered_batcher)
        with spans.span("serve.pack"):
            chunks = batcher.pack([r.n_rows for r in ready])

        if kind == "tiered":
            return self._dispatch_tiered(ready, chunks, cursor, wall)

        for chunk in chunks:
            reg = engine._score[chunk.bucket]
            try:
                t0 = engine._clock()
                with spans.span("serve.gather"):
                    rows = RequestBatcher.gather([r.payload for r in ready],
                                                 chunk)
                # padded to the cell's rows in its pinned staging buffer, on
                # to its static input: no padded copy of the ids on the host
                x = reg.cell.stage(rows)
                assembly_ms = (engine._clock() - t0) * 1e3
                self._mark_dispatch(ready, chunk, cursor)
                y, total_ms = engine._timed_call(reg, *x)
                with spans.span("serve.readback"):
                    # read before the next replay: the cells share one pool
                    y = y.cpu().numpy()  # staticcheck: ignore[RL403]
            except Exception as err:   # fault injection: fail only this chunk
                self._fail_chunk(ready, chunk, err, cursor, kind)
                continue
            lookup_ms = None
            if reg.lookup is not None:
                with spans.span("serve.lookup_split"):
                    try:
                        _, lookup_ms = engine._timed_call(reg.lookup, *x)
                    except Exception:   # stats companion only — the chunk's
                        lookup_ms = None    # results already computed fine
            with spans.span("serve.scatter"):
                engine.stats.record(reg.celldef.name, total_ms, lookup_ms,
                                    valid_rows=chunk.n_valid,
                                    capacity_rows=chunk.rows)
                cursor = self._advance(cursor,
                                       (assembly_ms + total_ms) / 1e3, wall)
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
                    torch.cuda.synchronize(engine.device)  # staticcheck: ignore[RL403]
                total_ms = (engine._clock() - t0) * 1e3
                # read before the next replay: the cells share one pool
                # the chunk's answer goes to the host
                y = y.cpu().numpy()  # staticcheck: ignore[RL403]
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

    # -- decode lane (continuous batching) ----------------------------------

    def _dispatch_decode(self, cursor: float, wall: bool) -> float:
        engine = self.engine
        ready, expired = engine.queue.take("decode", now=cursor)
        self._shed_expired(expired)
        for req in ready:
            prompt, max_new, arch = req.payload
            session = self._pick_session(arch)
            session.admit(DecodeJob(req, prompt, max_new))
        for session in self.sessions.values():
            self._shed_expired_waiting(session, cursor)
            session.join_waiting(cursor)
            if not session.active:
                continue
            self._progress = True
            try:
                t0 = engine._clock()
                # tokens and lens into the cell's inputs (lens is copied:
                # the session mutates it in place)
                staged = session.reg.cell.stage(session.step_tokens(),
                                                session.lens.copy())
                assembly_s = engine._clock() - t0
                (logits, new_caches), total_ms = engine._timed_call(
                    session.reg, staged[0], staged[1], session.caches)
                # read before the next replay writes the graph's outputs
                logits = logits.to(torch.float32).cpu().numpy()  # staticcheck: ignore[RL403]
            except Exception as err:   # fail active jobs, recycle their slots
                session.fail_active(err, cursor, engine.rstats, engine.queue)
                session.join_waiting(cursor)
                continue
            session.caches = new_caches
            engine.stats.record(session.reg.celldef.name, total_ms,
                                valid_rows=len(session.active),
                                capacity_rows=session.cap)
            cursor = self._advance(cursor, assembly_s + total_ms / 1e3, wall)
            session.advance(logits, total_ms, assembly_s * 1e3, cursor,
                            engine.rstats, engine.queue)
            session.join_waiting(cursor)   # freed slots recycle immediately
        return cursor

    def _shed_expired_waiting(self, session: DecodeSession, now: float):
        """Deadlines hold while a job waits for a slot, not just while it
        sits in the admission queue: a waiting job past its deadline is shed
        before it can take a freed slot."""
        keep = []
        for job in session.waiting:
            req = job.req
            if req.deadline_t is not None and now > req.deadline_t:
                self.engine.queue.note_shed(req, now=now)
                self.engine.rstats.record_shed("decode", tenant=req.tenant)
            else:
                keep.append(job)
        session.waiting = keep

    def _pick_session(self, arch: str | None) -> DecodeSession:
        if not self.sessions:
            raise ValueError("no continuous-batching decode cell registered "
                             "(register an lm_decode_slotted_cell)")
        if arch is not None:
            return self.sessions[arch]
        if len(self.sessions) > 1:
            raise ValueError(
                f"multiple decode sessions ({sorted(self.sessions)}); "
                f"pass arch=")
        return next(iter(self.sessions.values()))
