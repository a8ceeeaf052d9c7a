"""Serving-time precision adaptation: plan → re-pack → swap, zero recompiles.

The port of the reference's ``repro.serve.repack``. The paper fixes each
feature group's bit-width when the table is packed (§3.3/§4); production
memory pressure and popularity shifts argue for re-assigning precision
*while serving*. The substrate makes that a pure data swap: every per-width
subtable is a separate tensor of the bound packed table, so as long as a
new assignment is packed into the **same subtable shapes**, the captured
executables are untouched — the engine copies the new table into the bound
tensors in place, which the graphs read by address, and nothing is
recaptured.

Three pieces:

  - ``RepackPlanner`` — policy, numpy only (the reference's, line for
    line). Given the current per-group assignment and a bytes budget
    (``plan_budget``) or tier hit/miss counters (``plan_pressure``), emit a
    new per-group width assignment that respects the per-width row
    *capacities* of the live table.
  - ``TableSwapper`` — mechanism. Holds the full-precision master embedding
    (+ the trained α/β) and re-packs any assignment into the pinned
    capacities via ``core.inference.build_packed_table(row_capacities=...)``
    on the master's device, then queues the swap on the engine.
  - ``Engine.request_swap`` / ``Engine._apply_swaps`` — the atomic swap
    point: queued swaps apply only **between** ``sched_step``s.

``PressureAdapter`` closes the loop from live serving counters: it reads
the tiered stores' windowed hit/miss counts and plans pressure or promote
repacks, which the swapper queues.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.inference import _pad_rows, build_packed_table
from repro_torch.core.packing import row_bytes


def subtable_capacities(table) -> dict:
    """Per-width padded row counts of a packed table: ``{"b<width>": rows}``.

    These are the shapes the serving executables were compiled against — the
    hard constraint every repack plan must fit inside."""
    return {k: int(v.shape[0]) for k, v in table["subtables"].items()}


def headroom_capacities(meta, *, fraction: float = 0.5,
                        multiple: int = 8) -> dict:
    """Capacity template reserving repack headroom: each non-zero width
    bucket is sized to hold ``ceil(fraction * n)`` features (rounded up to
    ``multiple`` rows, so row shards stay aligned to whole packed rows).

    Build the serving table with
    ``build_packed_table(..., row_capacities=headroom_capacities(meta))`` and
    any later assignment that puts at most that fraction of the features into
    one bucket swaps in without recompiling. The cost is padding bytes at
    rest — the production trade for a fixed executable fleet."""
    n = int(meta["n"])
    rows = _pad_rows(int(np.ceil(fraction * n)), multiple)
    return {f"b{b}": rows for b in meta["bits"] if b != 0}


class RepackPlan(NamedTuple):
    """One planner decision: the new per-group/per-feature assignment plus
    the byte math that justified it (``tests/test_repack.py`` asserts
    ``bytes_packed`` ≤ the requested budget and capacity feasibility)."""
    group_bits_idx: np.ndarray    # (G,) int32 — new per-group width index
    feature_bits_idx: np.ndarray  # (n,) int32 — expanded per feature
    bytes_packed: int             # projected pad-free packed payload bytes
    bytes_before: int             # payload bytes under the input assignment
    n_features_moved: int         # features whose width changed


class RepackPlanner:
    """Capacity-constrained precision (re-)assignment policy.

    ``meta`` is the packed table's static metadata (``bits``/``d``/``n``),
    ``group_of_feature`` the (n,) feature→group map the pipeline trained with
    (``core.mpe.make_groups``), ``capacities`` the per-width row capacities
    of the live table (``subtable_capacities``), and ``frequencies`` an
    optional per-feature access-count vector — groups are demoted coldest
    first (summed frequency), promoted hottest first; without it, group index
    order is used (``make_groups`` orders groups hottest-first already).

    The planner is *policy only*: it never touches device state. Feasibility
    means every width bucket's feature count stays within its capacity
    (width 0 stores nothing and is always feasible), so whatever the planner
    emits, ``TableSwapper.repack`` can pack without changing a shape.
    """

    def __init__(self, meta, group_of_feature, capacities: dict, *,
                 frequencies=None):
        self.bits = tuple(meta["bits"])
        self.d = int(meta["d"])
        self.n = int(meta["n"])
        self.gof = np.asarray(group_of_feature, np.int32)
        self.n_groups = int(self.gof.max()) + 1 if self.gof.size else 0
        self.capacities = {k: int(v) for k, v in capacities.items()}
        self.group_size = np.bincount(self.gof, minlength=self.n_groups)
        if frequencies is not None:
            freqs = np.asarray(frequencies, np.float64)
            gfreq = np.zeros((self.n_groups,), np.float64)
            np.add.at(gfreq, self.gof, freqs)
            self.group_priority = gfreq
        else:
            # make_groups assigns hottest features to the lowest group ids
            self.group_priority = -np.arange(self.n_groups, dtype=np.float64)

    # -- byte/capacity math -------------------------------------------------

    def _row_bytes(self) -> np.ndarray:
        return np.array([row_bytes(self.d, b) if b else 0 for b in self.bits],
                        np.int64)

    def bytes_packed(self, group_bits_idx) -> int:
        """Pad-free packed payload bytes under an assignment."""
        fb = np.asarray(group_bits_idx, np.int32)[self.gof]
        return int(self._row_bytes()[fb].sum())

    def bucket_counts(self, group_bits_idx) -> np.ndarray:
        """(m,) feature count per width bucket under an assignment."""
        fb = np.asarray(group_bits_idx, np.int32)[self.gof]
        return np.bincount(fb, minlength=len(self.bits))

    def capacity_ok(self, group_bits_idx) -> bool:
        """True when every non-zero bucket fits its pinned row capacity."""
        counts = self.bucket_counts(group_bits_idx)
        return all(counts[i] <= self.capacities.get(f"b{b}", 0)
                   for i, b in enumerate(self.bits) if b != 0)

    def _fits(self, counts, i: int, size: int) -> bool:
        b = self.bits[i]
        if b == 0:
            return True
        return counts[i] + size <= self.capacities.get(f"b{b}", 0)

    # -- planning -----------------------------------------------------------

    def plan_budget(self, group_bits_idx, bytes_budget: int) -> RepackPlan:
        """Demote groups (coldest first, one width notch at a time, each to
        the widest narrower bucket with free capacity) until the packed
        payload fits ``bytes_budget``. Deterministic greedy; a budget below
        the all-zero-width floor simply bottoms out at width 0."""
        assign = np.asarray(group_bits_idx, np.int32).copy()
        before = self.bytes_packed(assign)
        rb = self._row_bytes()
        counts = self.bucket_counts(assign)
        total = before
        order = np.argsort(self.group_priority, kind="stable")  # coldest first
        changed = True
        while total > bytes_budget and changed:
            changed = False
            for g in order:
                if total <= bytes_budget:
                    break
                i = int(assign[g])
                if i == 0:
                    continue
                size = int(self.group_size[g])
                j = next((j for j in range(i - 1, -1, -1)
                          if self._fits(counts, j, size)), None)
                if j is None:
                    continue
                assign[g] = j
                counts[i] -= size
                counts[j] += size
                total -= size * int(rb[i] - rb[j])
                changed = True
        return self._finish(group_bits_idx, assign)

    def plan_pressure(self, group_bits_idx, counters: dict, *,
                      max_shrink: float = 0.5) -> RepackPlan:
        """Turn a ``TieredTableStore.counters()`` record into a byte budget:
        the cold-lookup share of traffic scales a shrink factor (up to
        ``max_shrink``), so a store thrashing its cold tier narrows the tail
        until the bytes a miss moves get proportionally cheaper. A 100% hit
        rate plans the identity assignment."""
        total = counters.get("hot_lookups", 0) + counters.get("cold_lookups", 0)
        miss = counters.get("cold_lookups", 0) / total if total else 0.0
        before = self.bytes_packed(group_bits_idx)
        budget = int(before * (1.0 - max_shrink * miss))
        return self.plan_budget(group_bits_idx, budget)

    def plan_promote(self, group_bits_idx, *, bytes_budget: int) -> RepackPlan:
        """Spend spare budget the other way: promote the hottest groups one
        notch at a time (to the narrowest wider bucket with capacity) while
        the payload stays within ``bytes_budget``."""
        assign = np.asarray(group_bits_idx, np.int32).copy()
        rb = self._row_bytes()
        counts = self.bucket_counts(assign)
        total = self.bytes_packed(assign)
        m = len(self.bits)
        order = np.argsort(-self.group_priority, kind="stable")  # hottest first
        changed = True
        while changed:
            changed = False
            for g in order:
                i = int(assign[g])
                if i >= m - 1:
                    continue
                size = int(self.group_size[g])
                j = next((j for j in range(i + 1, m)
                          if self._fits(counts, j, size)), None)
                if j is None:
                    continue
                delta = size * int(rb[j] - rb[i])
                if total + delta > bytes_budget:
                    continue
                assign[g] = j
                counts[i] -= size
                counts[j] += size
                total += delta
                changed = True
        return self._finish(group_bits_idx, assign)

    def _finish(self, old_assign, assign: np.ndarray) -> RepackPlan:
        old_fb = np.asarray(old_assign, np.int32)[self.gof]
        fb = assign[self.gof]
        return RepackPlan(
            group_bits_idx=assign,
            feature_bits_idx=fb.astype(np.int32),
            bytes_packed=self.bytes_packed(assign),
            bytes_before=int(self._row_bytes()[old_fb].sum()),
            n_features_moved=int((fb != old_fb).sum()),
        )


class TableSwapper:
    """Re-packs the master embedding under a planner assignment and queues
    the atomic swap on a live engine.

    ``emb``/``alpha``/``beta`` are the retrained full-precision artifacts the
    original table was packed from (``run_mpe_pipeline``'s
    ``final_params["embedding"]``) — the master copy a production parameter
    server would hold; ``cfg`` the same ``MPEConfig``; ``capacities`` the
    pinned per-width row counts (defaults to the engine's live table shapes
    at first ``repack``). Swaps re-quantize from the master, so repacking to
    the identical assignment reproduces the original table bit for bit. The
    master's tensors stay where they are given (numpy arrays become CPU
    tensors); each repack is built on their device."""

    def __init__(self, engine, emb, alpha, beta, cfg, *,
                 capacities: dict | None = None, arch: str | None = None):
        self.engine = engine
        self.emb, self.alpha, self.beta = (
            t if torch.is_tensor(t) else torch.from_numpy(np.asarray(t))
            for t in (emb, alpha, beta))
        self.cfg = cfg
        self.arch = arch
        self.capacities = (dict(capacities) if capacities is not None
                           else None)
        self.n_swaps = 0

    def _resolve_capacities(self) -> dict:
        if self.capacities is None:
            table = self.engine.live_packed_table(arch=self.arch)
            self.capacities = subtable_capacities(table)
        return self.capacities

    def build(self, feature_bits_idx):
        """Pack ``feature_bits_idx`` into the pinned capacities →
        ``(table, meta)``, without touching the engine. Raises when the
        assignment doesn't fit (the planner should never emit one)."""
        fb = torch.from_numpy(np.asarray(feature_bits_idx, np.int32))
        return build_packed_table(self.emb, fb, self.alpha, self.beta,
                                  self.cfg,
                                  row_capacities=self._resolve_capacities())

    def repack(self, plan) -> dict:
        """Re-pack ``plan`` (a ``RepackPlan`` or a bare per-feature width
        index array) and queue the swap; it lands atomically at the engine's
        next ``sched_step`` boundary. Returns a summary dict
        (``bytes_packed``, ``n_features_moved``, ``swaps``)."""
        fb = (plan.feature_bits_idx if isinstance(plan, RepackPlan)
              else np.asarray(plan, np.int32))
        table, meta = self.build(fb)
        self.engine.request_swap(table, meta, arch=self.arch)
        self.n_swaps += 1
        summary = {"swaps": self.n_swaps,
                   "n_features": int(fb.size),
                   "compiles": self.engine.compile_count}
        if isinstance(plan, RepackPlan):
            summary.update(bytes_packed=plan.bytes_packed,
                           bytes_before=plan.bytes_before,
                           n_features_moved=plan.n_features_moved)
        return summary


class PressureAdapter:
    """Drive ``RepackPlanner.plan_pressure`` from *live* serving counters —
    precision follows traffic drift automatically.

    Attach with ``Engine.attach_adapter``; ``step(engine)`` runs once per
    ``sched_step`` (after the tier policy's moves). Every ``every`` rounds
    the adapter takes a **windowed** hit/miss delta across the engine's
    tiered stores — windowing, not cumulative counters, so old traffic
    can't mask fresh drift — and plans against it:

      - miss share above ``promote_below`` → ``plan_pressure`` narrows the
        tail (cold thrash makes each miss's bytes cheaper);
      - miss share at/below ``promote_below`` → ``plan_promote`` spends the
        recovered headroom widening the hottest groups back toward the
        baseline byte payload.

    A plan moving fewer than ``min_moved`` features is dropped (the swap
    re-quantizes from the master embedding). Queued swaps land at the
    *next* round's atomic swap point, with zero recaptures: the capacities
    were pinned when the serving table was built."""

    def __init__(self, planner: RepackPlanner, swapper: TableSwapper,
                 group_bits_idx, *, every: int = 32, max_shrink: float = 0.5,
                 promote_below: float = 0.02, min_moved: int = 1):
        self.planner = planner
        self.swapper = swapper
        self.assignment = np.asarray(group_bits_idx, np.int32).copy()
        self.base_bytes = planner.bytes_packed(self.assignment)
        self.every = int(every)
        self.max_shrink = float(max_shrink)
        self.promote_below = float(promote_below)
        self.min_moved = int(min_moved)
        self._rounds = 0
        self._seen = (0, 0)     # cumulative (hot, cold) at last window edge
        self.repacks = 0

    def step(self, engine) -> dict | None:
        """One cadence tick; returns the repack summary when a swap was
        queued this round, else None."""
        self._rounds += 1
        if self._rounds % self.every:
            return None
        hot = cold = 0
        for store in engine._tier_stores():
            c = store.counters()
            hot += c["hot_lookups"]
            cold += c["cold_lookups"]
        window = {"hot_lookups": hot - self._seen[0],
                  "cold_lookups": cold - self._seen[1]}
        self._seen = (hot, cold)
        total = window["hot_lookups"] + window["cold_lookups"]
        if total == 0:
            return None
        miss = window["cold_lookups"] / total
        if miss <= self.promote_below:
            plan = self.planner.plan_promote(self.assignment,
                                             bytes_budget=self.base_bytes)
        else:
            plan = self.planner.plan_pressure(self.assignment, window,
                                              max_shrink=self.max_shrink)
        if plan.n_features_moved < self.min_moved:
            return None
        summary = self.swapper.repack(plan)
        self.assignment = plan.group_bits_idx
        self.repacks += 1
        return summary
