"""Per-cell and per-request serving latency accounting.

Two views of the same traffic:

  - ``LatencyStats`` (per **cell** dispatch) follows the paper's Figure-5
    protocol: end-to-end dispatch latency split into *table lookup* (packed
    gather + unpack + dequant, timed by running the lookup-only companion
    cell at the same padded shape) and *computation*. It also accumulates
    per-cell **occupancy** — valid rows over padded capacity — so the
    coalescing win of the scheduler is measurable per dispatch.
  - ``RequestStats`` (per **request**) extends the split upstream of the
    cell: *queue wait* (arrival → first dispatch), *batch assembly* (span
    gather + pad + the copy into the cell's pinned staging buffer and on to
    the card) and *compute* (cell dispatch to ready), plus the end-to-end
    latency on the caller's clock.

Both summarize into the reference's keys and groupings (``kind``, ``lane``,
``tenant``).
"""
from __future__ import annotations

import numpy as np


def _pcts(values, *, skip_warmup: int = 0) -> dict:
    arr = np.asarray(values, np.float64)
    if arr.shape[0] > skip_warmup:
        arr = arr[skip_warmup:]
    return {"count": int(len(values)),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean())}


class LatencyStats:
    """Append-only per-cell latency records with percentile summaries."""

    def __init__(self):
        self._total_ms: dict[str, list] = {}
        self._lookup_ms: dict[str, list] = {}
        self._occupancy: dict[str, list] = {}   # [valid_rows, padded_rows]

    def record(self, cell: str, total_ms: float, lookup_ms: float | None = None,
               *, valid_rows: int | None = None,
               capacity_rows: int | None = None):
        self._total_ms.setdefault(cell, []).append(float(total_ms))
        if lookup_ms is not None:
            self._lookup_ms.setdefault(cell, []).append(float(lookup_ms))
        if valid_rows is not None and capacity_rows is not None:
            acc = self._occupancy.setdefault(cell, [0, 0])
            acc[0] += int(valid_rows)
            acc[1] += int(capacity_rows)

    def occupancy(self) -> dict:
        """Per-cell {valid_rows, padded_rows, occupancy} over every recorded
        dispatch — the fraction of padded rows that carried real work."""
        return {cell: {"valid_rows": v, "padded_rows": p,
                       "occupancy": (v / p) if p else 0.0}
                for cell, (v, p) in sorted(self._occupancy.items())}

    def cells(self):
        return sorted(self._total_ms)

    def percentiles(self, cell: str, *, skip_warmup: int = 0) -> dict:
        """p50/p99/mean of total latency plus the lookup/compute split.

        ``skip_warmup`` drops the first N records before aggregating; falls
        back to all records when fewer than N+1 exist."""
        lat = np.asarray(self._total_ms[cell])
        if lat.shape[0] > skip_warmup:
            lat = lat[skip_warmup:]
        out = {
            "count": int(len(self._total_ms[cell])),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(lat.mean()),
        }
        lk = self._lookup_ms.get(cell)
        if lk:
            lk = np.asarray(lk)
            if lk.shape[0] > skip_warmup:
                lk = lk[skip_warmup:]
            lookup_p50 = float(np.percentile(lk, 50))
            out["lookup_p50_ms"] = lookup_p50
            out["compute_p50_ms"] = max(out["p50_ms"] - lookup_p50, 0.0)
        occ = self._occupancy.get(cell)
        if occ is not None and occ[1]:
            out["occupancy"] = occ[0] / occ[1]
        return out

    def summary(self, *, skip_warmup: int = 0) -> dict:
        return {c: self.percentiles(c, skip_warmup=skip_warmup)
                for c in self.cells()}

    def format_table(self, *, skip_warmup: int = 0) -> str:
        lines = []
        for cell, s in self.summary(skip_warmup=skip_warmup).items():
            line = (f"{cell:<28} n={s['count']:<5} "
                    f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms")
            if "lookup_p50_ms" in s:
                line += (f" lookup={s['lookup_p50_ms']:.2f}ms "
                         f"compute={s['compute_p50_ms']:.2f}ms")
            if "occupancy" in s:
                line += f" occ={s['occupancy']:.2f}"
            lines.append(line)
        return "\n".join(lines)


class RequestStats:
    """Per-request three-way latency breakdown, grouped by request kind,
    by *lane* (``kind:p<priority>``) or by *tenant*.

    One record per completed request: *queue wait* (arrival → first chunk
    dispatch), *batch assembly* (span gather + pad + staging, summed over
    the request's chunks), *compute* (cell dispatch-to-ready, summed)
    and the end-to-end latency on the caller's clock. Shed and failed
    requests are counted (split by kind/tenant), not timed (they never
    deliver a result)."""

    def __init__(self):
        # key: (kind, tenant, priority) -> field lists
        self._records: dict[tuple, dict[str, list]] = {}
        self.shed = 0
        self.failed = 0
        self._shed_by: dict[tuple, int] = {}     # (kind, tenant) -> n
        self._failed_by: dict[tuple, int] = {}

    def record(self, kind: str, *, queue_ms: float, assembly_ms: float,
               compute_ms: float, latency_ms: float,
               tenant: str = "default", priority: int = 0):
        rec = self._records.setdefault(
            (kind, tenant, int(priority)),
            {"queue_ms": [], "assembly_ms": [], "compute_ms": [],
             "latency_ms": []})
        rec["queue_ms"].append(float(queue_ms))
        rec["assembly_ms"].append(float(assembly_ms))
        rec["compute_ms"].append(float(compute_ms))
        rec["latency_ms"].append(float(latency_ms))

    def record_shed(self, kind: str, tenant: str = "default"):
        self.shed += 1
        key = (kind, tenant)
        self._shed_by[key] = self._shed_by.get(key, 0) + 1

    def record_failed(self, kind: str, tenant: str = "default"):
        self.failed += 1
        key = (kind, tenant)
        self._failed_by[key] = self._failed_by.get(key, 0) + 1

    def kinds(self):
        return sorted({kind for kind, _, _ in self._records})

    def lane_counts(self) -> dict[str, int]:
        """Completed requests per lane (``kind:p<priority>``) — the goodput
        view ``engine.counters()`` surfaces."""
        out: dict[str, int] = {}
        for (kind, _, priority), rec in self._records.items():
            lane = f"{kind}:p{priority}"
            out[lane] = out.get(lane, 0) + len(rec["latency_ms"])
        return dict(sorted(out.items()))

    def tenant_counts(self) -> dict[str, int]:
        """Completed requests per tenant."""
        out: dict[str, int] = {}
        for (_, tenant, _), rec in self._records.items():
            out[tenant] = out.get(tenant, 0) + len(rec["latency_ms"])
        return dict(sorted(out.items()))

    @staticmethod
    def _merge(recs: list[dict]) -> dict[str, list]:
        out = {"queue_ms": [], "assembly_ms": [], "compute_ms": [],
               "latency_ms": []}
        for rec in recs:
            for field, values in rec.items():
                out[field].extend(values)
        return out

    def _group(self, label_fn) -> dict[str, dict[str, list]]:
        groups: dict[str, list] = {}
        for key, rec in self._records.items():
            groups.setdefault(label_fn(*key), []).append(rec)
        return {label: self._merge(recs)
                for label, recs in sorted(groups.items())}

    def _summarize(self, grouped: dict, shed_key_fn, *,
                   skip_warmup: int = 0) -> dict:
        out = {}
        for label, rec in grouped.items():
            out[label] = {
                "count": len(rec["latency_ms"]),
                "latency": _pcts(rec["latency_ms"], skip_warmup=skip_warmup),
                "queue": _pcts(rec["queue_ms"], skip_warmup=skip_warmup),
                "assembly": _pcts(rec["assembly_ms"], skip_warmup=skip_warmup),
                "compute": _pcts(rec["compute_ms"], skip_warmup=skip_warmup),
            }
            shed, failed = shed_key_fn(label)
            if shed:
                out[label]["shed"] = shed
            if failed:
                out[label]["failed"] = failed
        return out

    def summary(self, *, skip_warmup: int = 0) -> dict:
        """{kind: {latency: pcts, queue_ms: pcts, assembly_ms: pcts,
        compute_ms: pcts}} — the three-way split + end-to-end."""
        def by_kind(label):
            return (sum(n for (k, _), n in self._shed_by.items()
                        if k == label),
                    sum(n for (k, _), n in self._failed_by.items()
                        if k == label))
        return self._summarize(self._group(lambda k, t, p: k), by_kind,
                               skip_warmup=skip_warmup)

    def lane_summary(self, *, skip_warmup: int = 0) -> dict:
        """The same breakdown keyed by lane — ``kind:p<priority>`` — so a
        high-priority lane's p99 is separable from the background lane's."""
        return self._summarize(
            self._group(lambda k, t, p: f"{k}:p{p}"),
            lambda label: (0, 0), skip_warmup=skip_warmup)

    def tenant_summary(self, *, skip_warmup: int = 0) -> dict:
        """The same breakdown keyed by tenant, with per-tenant shed/failed
        counts merged in — the per-tenant goodput/SLO view."""
        def by_tenant(label):
            return (sum(n for (_, t), n in self._shed_by.items()
                        if t == label),
                    sum(n for (_, t), n in self._failed_by.items()
                        if t == label))
        return self._summarize(self._group(lambda k, t, p: t), by_tenant,
                               skip_warmup=skip_warmup)

    def format_table(self, *, skip_warmup: int = 0, by: str = "kind") -> str:
        summaries = {"kind": self.summary, "lane": self.lane_summary,
                     "tenant": self.tenant_summary}[by]
        lines = []
        for label, s in summaries(skip_warmup=skip_warmup).items():
            lines.append(
                f"{label:<12} n={s['count']:<5} "
                f"e2e p50={s['latency']['p50_ms']:.2f}ms "
                f"p99={s['latency']['p99_ms']:.2f}ms | "
                f"queue={s['queue']['p50_ms']:.2f}ms "
                f"assembly={s['assembly']['p50_ms']:.2f}ms "
                f"compute={s['compute']['p50_ms']:.2f}ms")
        if self.shed:
            lines.append(f"shed={self.shed}")
        if self.failed:
            lines.append(f"failed={self.failed}")
        return "\n".join(lines)
