"""Traffic-adaptive tier policy: frequency-decay admission over the hot set.

The port's own copy of the reference's ``repro.cache.policy`` (pure numpy,
the same scores and plans). The hot/cold split of ``TieredTableStore`` is seeded once from training-set
frequency, but production popularity drifts hour to hour — *Mixed-Precision
Embedding Using a Cache* (Yang et al., 2020) makes the serving-time cache
policy the thing that keeps a mixed-precision table viable at scale. This
module closes that loop: it turns the store's live lookup stream into
**exponentially-decayed per-feature scores** (an LRU-ish recency/frequency
blend) and emits bounded batches of promotions/demotions that the store
applies *incrementally* — no full re-pack, no recompile (the hot subtable
shapes never change; moves land in free slots or swap row-for-row).

Score model (lazy decay — O(touched) per observation, O(n) per plan):

    score_f(t) = score_f(t_last) * 0.5^((t - t_last)/halflife) + hits

where ``t`` advances by one tick per ``observe`` call (one dispatched chunk).
A feature's score is therefore a half-life-weighted hit count: traffic from
``halflife`` chunks ago counts half as much as current traffic, so a
popularity shift re-ranks the vocabulary within a few half-lives.

Promotion batching: each ``plan`` emits at most ``max_moves`` moves, filling
free hot slots hottest-cold-feature first, then swapping cold risers against
the coldest hot residents only when the riser's score beats the victim's by
the hysteresis ``margin`` (> 1 damps thrash on near-ties). All ordering is
deterministic (stable sorts, feature-id tie-break).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TierPlan(NamedTuple):
    """One policy decision: global feature ids to promote into the hot tier
    and to demote out of it, plus the decayed scores that justified the
    moves (debug/telemetry; the store only consumes the id arrays)."""
    promote: np.ndarray        # (p,) int64 global feature ids, hottest first
    demote: np.ndarray         # (q,) int64 global feature ids
    promote_score: np.ndarray  # (p,) float64 decayed scores at plan time
    demote_score: np.ndarray   # (q,) float64

    @property
    def n_moves(self) -> int:
        """Total rows this plan touches (promotions + demotions)."""
        return int(self.promote.size + self.demote.size)


class StaticTierPolicy:
    """The no-op policy: keep the training-frequency split forever.

    Exists so ``--cache-policy static`` and the adaptive policy drive the
    identical code path in benchmarks and tests — same observation hooks,
    same plan cadence, zero moves."""

    def observe(self, ids) -> None:
        """Ignore the traffic (the static split never re-ranks)."""

    def plan(self, store) -> TierPlan:
        """An empty plan: nothing promotes, nothing demotes."""
        empty = np.zeros((0,), np.int64)
        return TierPlan(empty, empty, np.zeros((0,)), np.zeros((0,)))


class DecayAdmissionPolicy:
    """Frequency-decay admission/eviction over a ``TieredTableStore``.

    ``n`` is the store's vocabulary size; ``halflife`` the score half-life in
    observation ticks (one tick per ``observe`` call — one dispatched chunk
    in the serving engine); ``max_moves`` bounds each plan's promotion batch;
    ``margin`` is the swap hysteresis (a cold riser must beat the coldest
    hot resident's score by this factor before they trade places).

    Attach with ``TieredTableStore.attach_policy(policy)`` — the store then
    feeds every valid looked-up id into ``observe`` from ``prefetch_cold``,
    so the scores see exactly the traffic the hit/miss counters see.
    """

    def __init__(self, n: int, *, halflife: float = 256.0,
                 max_moves: int = 64, margin: float = 1.1):
        if halflife <= 0:
            raise ValueError(f"halflife must be > 0, got {halflife}")
        if margin < 1.0:
            raise ValueError(f"margin must be >= 1, got {margin}")
        self.n = int(n)
        self.halflife = float(halflife)
        self.max_moves = int(max_moves)
        self.margin = float(margin)
        self._decay = 0.5 ** (1.0 / self.halflife)   # per-tick factor
        self._score = np.zeros((self.n,), np.float64)
        self._last = np.zeros((self.n,), np.float64)  # tick of last touch
        self._t = 0.0
        self.observations = 0

    # -- observation ---------------------------------------------------------

    def observe(self, ids) -> None:
        """Fold one chunk's looked-up ids into the decayed scores.

        Lazy decay: only the touched features pay the catch-up
        multiplication, so a chunk costs O(unique ids) regardless of
        vocabulary size."""
        ids = np.asarray(ids).reshape(-1)
        self._t += 1.0
        self.observations += 1
        if ids.size == 0:
            return
        u, c = np.unique(ids, return_counts=True)
        self._score[u] = (self._score[u]
                          * self._decay ** (self._t - self._last[u]) + c)
        self._last[u] = self._t

    def scores(self) -> np.ndarray:
        """Every feature's score decayed to the current tick (O(n))."""
        return self._score * self._decay ** (self._t - self._last)

    # -- planning ------------------------------------------------------------

    def plan(self, store) -> TierPlan:
        """Emit at most ``max_moves`` promotions/demotions against ``store``.

        Per width bucket (moves never cross buckets — a row only fits its
        own packed width): free hot slots fill with the highest-scoring cold
        features that have any traffic; then cold risers swap against the
        coldest hot residents while ``riser > resident * margin``. The plan
        is feasible by construction: every promotion either lands in a free
        slot or is paired with a demotion of the same width."""
        scores = self.scores()
        width_idx = store._width_idx_np
        is_hot = store._is_hot_np
        free = store.free_slot_counts()
        budget = self.max_moves
        promote, demote = [], []
        pro_s, dem_s = [], []
        for i, b in enumerate(store.meta["bits"]):
            if b == 0 or budget <= 0:
                continue
            feats = np.nonzero(width_idx == i)[0]
            cold = feats[~is_hot[feats]]
            hot = feats[is_hot[feats]]
            if cold.size == 0:
                continue
            # hottest cold features first; coldest hot residents first —
            # stable under score ties via the feature-id tie-break
            cold = cold[np.lexsort((cold, -scores[cold]))]
            hot = hot[np.lexsort((hot, scores[hot]))]
            k = 0
            n_free = min(int(free.get(f"b{b}", 0)), budget)
            while k < n_free and k < cold.size and scores[cold[k]] > 0.0:
                promote.append(cold[k]); pro_s.append(scores[cold[k]])
                k += 1
            budget -= k
            j = 0
            while (budget >= 2 and k < cold.size and j < hot.size
                   and scores[cold[k]] > scores[hot[j]] * self.margin):
                promote.append(cold[k]); pro_s.append(scores[cold[k]])
                demote.append(hot[j]); dem_s.append(scores[hot[j]])
                k += 1; j += 1; budget -= 2
        return TierPlan(np.asarray(promote, np.int64),
                        np.asarray(demote, np.int64),
                        np.asarray(pro_s, np.float64),
                        np.asarray(dem_s, np.float64))
