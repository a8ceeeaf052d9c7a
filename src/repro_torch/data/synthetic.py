"""Synthetic CTR data with a planted logistic ground truth (pure numpy).

Generates request streams matching CTR statistics: per-field Zipf
popularity, per-feature latent weights drawn from a hash, planted pairwise
interactions, and a bias calibrated to the positive ratio. Its
``expected_frequencies`` is MPE's frequency prior. Batches are pure
functions of (seed, step, host_id, n_hosts), identical to the reference's
generator on the same spec. ``DriftingCTR`` rotates the popular ids as
the steps go (the tiered cache's drifting traffic).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CTRSpec(NamedTuple):
    field_vocabs: tuple            # per-field vocabulary sizes
    batch_size: int = 1024
    zipf_exponent: float = 1.1
    positive_logit_bias: float = -1.1   # ≈25% positive (Criteo-like)
    signal_scale: float = 0.8
    rare_decay: float = 0.25       # signal std multiplier at the rarest rank
    n_pairs: int = 4               # planted field-pair interactions
    seed: int = 0


def _hash_normal(ids: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic per-id standard normal via splitmix64 + Box-Muller."""
    salt_mix = np.uint64((salt * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) % (1 << 64))
    x = ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + salt_mix
    x ^= x >> np.uint64(30); x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27); x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    u1 = (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    y = x * np.uint64(0xD6E8FEB86659FD93)
    y ^= y >> np.uint64(32)
    u2 = (y >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return np.sqrt(-2.0 * np.log(np.clip(u1, 1e-12, 1.0))) * np.cos(2 * np.pi * u2)


class SyntheticCTR:
    def __init__(self, spec: CTRSpec):
        self.spec = spec
        self.n_fields = len(spec.field_vocabs)
        self.offsets = np.concatenate(
            [[0], np.cumsum(spec.field_vocabs)[:-1]]).astype(np.int64)
        self.total_vocab = int(sum(spec.field_vocabs))
        rng = np.random.default_rng(spec.seed)
        # planted interactions between random field pairs
        self.pairs = [tuple(rng.choice(self.n_fields, 2, replace=False))
                      for _ in range(spec.n_pairs)]
        # per-field Zipf CDF for popularity-ranked local ids
        self._cdfs = []
        for v in spec.field_vocabs:
            p = np.arange(1, v + 1, dtype=np.float64) ** (-spec.zipf_exponent)
            p /= p.sum()
            self._cdfs.append(np.cumsum(p))

    # -- frequency prior ---------------------------------------------------
    def expected_frequencies(self) -> np.ndarray:
        """Expected per-(global)feature access probability — MPE's prior."""
        out = np.empty((self.total_vocab,), np.float64)
        for f, v in enumerate(self.spec.field_vocabs):
            pdf = np.diff(self._cdfs[f], prepend=0.0)
            out[self.offsets[f]:self.offsets[f] + v] = pdf
        return out

    # -- latent ground truth ------------------------------------------------
    def _weight(self, gids: np.ndarray, local_rank: np.ndarray,
                vocab: np.ndarray, salt: int) -> np.ndarray:
        """Rank-dependent signal: frequent features carry cleaner weight."""
        s = self.spec
        frac = local_rank.astype(np.float64) / np.maximum(vocab - 1, 1)
        scale = s.signal_scale * (1.0 - (1.0 - s.rare_decay) * np.sqrt(frac))
        return _hash_normal(gids, salt) * scale

    def true_logit(self, ids: np.ndarray) -> np.ndarray:
        """ids: (B, F) popularity-ranked local ids -> (B,) ground-truth logit."""
        s = self.spec
        gids = ids.astype(np.int64) + self.offsets[None, :]
        vocab = np.asarray(s.field_vocabs, np.int64)[None, :]
        z = self._weight(gids, ids, vocab, salt=1).sum(axis=1)
        for pi, (a, b) in enumerate(self.pairs):
            z = z + (self._weight(gids[:, a], ids[:, a], vocab[:, a], salt=10 + pi)
                     * self._weight(gids[:, b], ids[:, b], vocab[:, b], salt=20 + pi))
        return z + s.positive_logit_bias

    # -- streaming ----------------------------------------------------------
    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        s = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([s.seed, step, host_id, n_hosts]))
        ids = np.empty((s.batch_size, self.n_fields), np.int64)
        for f in range(self.n_fields):
            u = rng.random(s.batch_size)
            ids[:, f] = np.searchsorted(self._cdfs[f], u)
        z = self.true_logit(ids)
        label = (rng.random(s.batch_size) < 1.0 / (1.0 + np.exp(-z))).astype(np.int32)
        return {"ids": ids.astype(np.int32), "label": label}

    def eval_set(self, n_batches: int, start_step: int = 1_000_000):
        """Held-out batches: steps far past any training step."""
        return [self.batch(start_step + i) for i in range(n_batches)]


class DriftingCTR(SyntheticCTR):
    """Non-stationary power-law-with-drift request stream.

    Ids are drawn from the same per-field Zipf popularity ranks as
    ``SyntheticCTR``, then **rotated** within each field's vocabulary by a
    step-dependent offset:

        id = (zipf_rank_draw + offset_f(step)) mod vocab_f
        offset_f(step) = floor(drift_rate · step)
                         + (floor(shift_frac · vocab_f) if step ≥ shift_at)

    so the marginal distribution stays exactly power-law at every step while
    *which* features are popular drifts continuously (``drift_rate`` ids per
    step) and/or jumps wholesale at ``shift_at``. The frequency prior
    (``expected_frequencies``) describes step 0, so a static hot/cold split
    seeded from it decays as the stream drifts — the workload of the
    traffic-adaptive tier policy (``repro_torch.cache.policy``). Batches are
    pure functions of (seed, step, host_id, n_hosts), identical to the
    reference's.
    """

    def __init__(self, spec: CTRSpec, *, drift_rate: float = 0.0,
                 shift_at: int | None = None, shift_frac: float = 0.3,
                 step0: int = 0):
        super().__init__(spec)
        self.drift_rate = float(drift_rate)
        self.shift_at = None if shift_at is None else int(shift_at)
        self.shift_frac = float(shift_frac)
        self.step0 = int(step0)     # drift clock zero (serving streams often
        # start at a large step to stay disjoint from training batches)

    def field_offset(self, field: int, step: int) -> int:
        """The rotation applied to ``field``'s ids at ``step``."""
        v = int(self.spec.field_vocabs[field])
        t = max(step - self.step0, 0)
        off = int(np.floor(self.drift_rate * t))
        if self.shift_at is not None and t >= self.shift_at:
            off += int(self.shift_frac * v)
        return off % v

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        s = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([s.seed, step, host_id, n_hosts]))
        ids = np.empty((s.batch_size, self.n_fields), np.int64)
        for f in range(self.n_fields):
            u = rng.random(s.batch_size)
            v = int(s.field_vocabs[f])
            ids[:, f] = (np.searchsorted(self._cdfs[f], u)
                         + self.field_offset(f, step)) % v
        z = self.true_logit(ids)
        label = (rng.random(s.batch_size)
                 < 1.0 / (1.0 + np.exp(-z))).astype(np.int32)
        return {"ids": ids.astype(np.int32), "label": label}
