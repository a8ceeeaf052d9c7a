"""Admission queue: the arrival edge of the request lifecycle.

Serving decouples *arrival* from *dispatch*: callers ``submit`` requests into
a bounded queue and the scheduler (``repro_torch.serve.scheduler``) drains it into
coalesced cell-shaped batches. The queue owns the admission policy:

  - **backpressure** — the queue is bounded (``capacity`` requests); a full
    queue *sheds* new arrivals (reject-on-full, counted in ``shed_full``)
    instead of growing without bound — the open-loop overload behaviour the
    Figure-5-style latency split needs to stay measurable;
  - **priority lanes + EDF** — each request carries a ``priority`` (0 is the
    most urgent lane) and ``take`` drains lanes in priority order with
    earliest-deadline-first dispatch *inside* each lane (ties broken by
    ticket, so a single-tenant no-deadline stream dispatches in exactly the
    PR-5 FIFO order — bit-identical results);
  - **per-tenant quotas** — ``quotas[tenant] = TenantQuota(max_queued,
    max_inflight_rows)`` bounds a tenant's queue share at admission
    (``shed_quota``) and its dispatched-but-incomplete rows at drain
    (over-quota requests *defer* — stay queued — rather than shed);
  - **load-adaptive shedding** — above ``shed_watermark`` occupancy only the
    priority-0 lane is admitted (``shed_load``): background traffic is the
    first to go when the queue backs up, long before reject-on-full;
  - **deadlines** — a request may carry a deadline; requests still queued
    past it are shed at drain time (``shed_deadline``) rather than burning
    cell capacity on answers nobody is waiting for;
  - **timestamps** — arrival, dispatch and completion times are recorded per
    request, so queue-wait is separable from batch-assembly and compute in
    the latency breakdown (``repro_torch.serve.stats.RequestStats``).

All shed/admit counters are kept both as totals (back-compat) and split per
request kind and per tenant (``counters()["per_kind"]`` /
``["per_tenant"]``), so an overloaded lane is distinguishable from an
overloaded queue.

Timestamps are driven by the caller-provided ``now`` (the engine passes its
injectable clock — ``time.perf_counter`` by default; the open-loop replay in
``launch/serve.py`` passes a virtual timeline), so the same queue serves
live traffic and deterministic offline replay.
"""
from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple

# request lifecycle states
QUEUED = "queued"
DISPATCHED = "dispatched"   # at least one chunk dispatched, results pending
DONE = "done"
SHED = "shed"
FAILED = "failed"           # a dispatch raised; the error rode back instead


class RequestFailedError(RuntimeError):
    """Polling a ticket whose dispatch raised mid-``sched_step``. The
    message carries the original exception's type and text."""


class TenantQuota(NamedTuple):
    """Per-tenant admission/dispatch budget.

    ``max_queued`` caps the tenant's *queue share* (pending requests; the
    arrival edge — exceeding it sheds with ``shed_quota``).
    ``max_inflight_rows`` caps the tenant's dispatched-but-incomplete rows
    (the drain edge — over-quota requests stay queued until in-flight work
    completes). Either may be None (unbounded)."""
    max_queued: int | None = None
    max_inflight_rows: int | None = None


_COUNTER_KEYS = ("admitted", "shed_full", "shed_deadline", "shed_quota",
                 "shed_load")


class Request:
    """One submitted request and its lifecycle record."""
    __slots__ = ("ticket", "kind", "payload", "meta", "n_rows", "arrival_t",
                 "deadline_t", "dispatch_t", "complete_t", "status", "result",
                 "rows_done", "queue_ms", "assembly_ms", "compute_ms",
                 "tenant", "priority", "error")

    def __init__(self, ticket: int, kind: str, payload, n_rows: int,
                 arrival_t: float, deadline_t: float | None, meta=None,
                 tenant: str = "default", priority: int = 0):
        self.ticket = ticket
        self.kind = kind
        self.payload = payload
        self.meta = meta
        self.n_rows = int(n_rows)
        self.arrival_t = float(arrival_t)
        self.deadline_t = deadline_t
        self.dispatch_t = None
        self.complete_t = None
        self.status = QUEUED
        self.result = None
        self.rows_done = 0
        self.queue_ms = None
        self.assembly_ms = 0.0
        self.compute_ms = 0.0
        self.tenant = tenant
        self.priority = int(priority)
        self.error = None

    @property
    def latency_ms(self) -> float | None:
        if self.complete_t is None:
            return None
        return (self.complete_t - self.arrival_t) * 1e3

    @property
    def lane(self) -> str:
        """The scheduling lane: request kind + priority level."""
        return f"{self.kind}:p{self.priority}"


class AdmissionQueue:
    """Bounded multi-lane queue of admitted requests with shed counters.

    The queue never dispatches anything itself — the scheduler calls
    ``take`` to drain one kind's pending requests (shedding the expired ones
    on the way out, in priority/EDF order, subject to per-tenant in-flight
    quotas). All counters are cumulative over the queue's life.
    """

    def __init__(self, capacity: int = 1024, *,
                 quotas: dict[str, TenantQuota] | None = None,
                 shed_watermark: float = 1.0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not 0.0 < shed_watermark <= 1.0:
            raise ValueError(
                f"shed_watermark must be in (0, 1], got {shed_watermark}")
        self.capacity = int(capacity)
        self.quotas = dict(quotas or {})
        self.shed_watermark = float(shed_watermark)
        self._pending: deque[Request] = deque()
        self._next_ticket = 0
        self._per_kind: dict[str, dict[str, int]] = {}
        self._per_tenant: dict[str, dict[str, int]] = {}
        self._queued_by_tenant: dict[str, int] = {}
        self._inflight_rows: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._pending)

    # -- counter plumbing ----------------------------------------------------

    def _bump(self, counter: str, kind: str, tenant: str):
        for table, key in ((self._per_kind, kind), (self._per_tenant, tenant)):
            rec = table.setdefault(key, dict.fromkeys(_COUNTER_KEYS, 0))
            rec[counter] += 1

    def _total(self, counter: str) -> int:
        return sum(rec[counter] for rec in self._per_kind.values())

    @property
    def admitted(self) -> int:
        return self._total("admitted")

    @property
    def shed_full(self) -> int:
        return self._total("shed_full")

    @property
    def shed_deadline(self) -> int:
        return self._total("shed_deadline")

    @property
    def shed_quota(self) -> int:
        return self._total("shed_quota")

    @property
    def shed_load(self) -> int:
        return self._total("shed_load")

    # -- admission -----------------------------------------------------------

    def submit(self, kind: str, payload, n_rows: int, *, now: float,
               deadline_ms: float | None = None, meta=None,
               tenant: str = "default", priority: int = 0) -> Request | None:
        """Admit a request, or shed it (returns None) when an admission rule
        rejects it: queue full (``shed_full``), queue above the watermark
        and ``priority > 0`` (``shed_load``), or the tenant's queue share
        exhausted (``shed_quota``).

        ``now`` is the arrival timestamp on the caller's clock; a relative
        ``deadline_ms`` becomes an absolute deadline on the same clock."""
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        quota = self.quotas.get(tenant)
        if (quota is not None and quota.max_inflight_rows is not None
                and int(n_rows) > quota.max_inflight_rows):
            # could never dispatch: deferring it would wedge the scheduler
            raise ValueError(
                f"request of {n_rows} rows exceeds tenant {tenant!r} "
                f"max_inflight_rows={quota.max_inflight_rows}")
        if len(self._pending) >= self.capacity:
            self._bump("shed_full", kind, tenant)
            return None
        if (priority > 0 and self.shed_watermark < 1.0
                and len(self._pending) >= self.shed_watermark * self.capacity):
            self._bump("shed_load", kind, tenant)
            return None
        if (quota is not None and quota.max_queued is not None
                and self._queued_by_tenant.get(tenant, 0)
                >= quota.max_queued):
            self._bump("shed_quota", kind, tenant)
            return None
        deadline_t = None if deadline_ms is None else now + deadline_ms / 1e3
        req = Request(self._next_ticket, kind, payload, n_rows, now,
                      deadline_t, meta=meta, tenant=tenant, priority=priority)
        self._next_ticket += 1
        self._pending.append(req)
        self._bump("admitted", kind, tenant)
        self._queued_by_tenant[tenant] = \
            self._queued_by_tenant.get(tenant, 0) + 1
        return req

    # -- drain ---------------------------------------------------------------

    @staticmethod
    def _edf_key(req: Request):
        # priority lanes first; EDF inside a lane; ticket (arrival order)
        # breaks ties — so no-priority no-deadline traffic drains pure FIFO
        deadline = math.inf if req.deadline_t is None else req.deadline_t
        return (req.priority, deadline, req.ticket)

    def take(self, kind: str, *, now: float, min_rows: int | None = None,
             max_wait_s: float | None = None) -> tuple[list, list]:
        """Drain the pending requests of ``kind`` -> (ready, expired).

        ``ready`` comes out in dispatch order: priority lane 0 first,
        earliest deadline first within a lane, ticket order on ties.
        Requests whose deadline passed while they queued are shed (status
        ``SHED``, counted) instead of dispatched; other kinds stay queued
        untouched, as do requests a tenant in-flight quota defers.

        ``min_rows``/``max_wait_s`` implement the scheduler's **max-wait
        coalescing window**: when the ready rows sum below ``min_rows`` and
        the oldest pending request of this kind is younger than
        ``max_wait_s``, everything stays queued and ``ready`` is empty — the
        lane keeps coalescing until the bucket fills or the window expires
        (expired requests are still shed while holding)."""
        candidates, keep = [], deque()
        while self._pending:
            req = self._pending.popleft()
            if req.kind != kind:
                keep.append(req)
                continue
            candidates.append(req)
        expired, live = [], []
        for req in candidates:
            if req.deadline_t is not None and now > req.deadline_t:
                req.status = SHED
                req.complete_t = now
                self._bump("shed_deadline", req.kind, req.tenant)
                self._queued_by_tenant[req.tenant] -= 1
                expired.append(req)
            else:
                live.append(req)
        live.sort(key=self._edf_key)

        if (max_wait_s is not None and live
                and sum(r.n_rows for r in live) < (min_rows or 0)
                and now - min(r.arrival_t for r in live) < max_wait_s):
            # hold: not enough rows to fill the smallest bucket and the
            # oldest request hasn't waited out the coalescing window yet
            keep.extend(sorted(live, key=lambda r: r.ticket))
            self._pending = keep
            return [], expired

        ready, taken_rows = [], {}
        deferred = []
        for req in live:
            quota = self.quotas.get(req.tenant)
            if quota is not None and quota.max_inflight_rows is not None:
                inflight = (self._inflight_rows.get(req.tenant, 0)
                            + taken_rows.get(req.tenant, 0))
                if inflight + req.n_rows > quota.max_inflight_rows:
                    deferred.append(req)
                    continue
            taken_rows[req.tenant] = \
                taken_rows.get(req.tenant, 0) + req.n_rows
            ready.append(req)
        for req in ready:
            self._inflight_rows[req.tenant] = \
                self._inflight_rows.get(req.tenant, 0) + req.n_rows
            self._queued_by_tenant[req.tenant] -= 1
        keep.extend(sorted(deferred, key=lambda r: r.ticket))
        self._pending = keep
        return ready, expired

    def release(self, req: Request):
        """Return a taken request's rows to its tenant's in-flight budget —
        called once when the request completes, fails or is shed after
        dispatch (decode jobs shed while waiting for a KV slot)."""
        left = self._inflight_rows.get(req.tenant, 0) - req.n_rows
        self._inflight_rows[req.tenant] = max(left, 0)

    def note_shed(self, req: Request, *, now: float):
        """Shed a request that was already taken (e.g. a decode job whose
        deadline passed while it waited for a KV slot): counts it under
        ``shed_deadline`` for its kind/tenant and releases its quota."""
        req.status = SHED
        req.complete_t = now
        req.payload = None
        self._bump("shed_deadline", req.kind, req.tenant)
        self.release(req)

    # -- introspection -------------------------------------------------------

    def pending_rows(self, kind: str) -> int:
        return sum(r.n_rows for r in self._pending if r.kind == kind)

    def oldest_arrival(self, kind: str) -> float | None:
        arrivals = [r.arrival_t for r in self._pending if r.kind == kind]
        return min(arrivals) if arrivals else None

    def counters(self) -> dict:
        """Totals (back-compat) plus the per-kind / per-tenant split of
        every admission counter and the live in-flight row budget."""
        return {"capacity": self.capacity, "depth": len(self._pending),
                "admitted": self.admitted, "shed_full": self.shed_full,
                "shed_deadline": self.shed_deadline,
                "shed_quota": self.shed_quota, "shed_load": self.shed_load,
                "per_kind": {k: dict(v)
                             for k, v in sorted(self._per_kind.items())},
                "per_tenant": {t: dict(v)
                               for t, v in sorted(self._per_tenant.items())},
                "inflight_rows": {t: n for t, n
                                  in sorted(self._inflight_rows.items())
                                  if n}}
