"""Per-cell serving latency accounting.

``LatencyStats`` follows the paper's Figure-5 protocol: end-to-end dispatch
latency split into *table lookup* (packed gather + unpack + dequant, timed
by running the lookup alone at the same padded shape) and *computation*. It
also accumulates per-cell **occupancy** — valid rows over padded capacity.
"""
from __future__ import annotations

import numpy as np


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
