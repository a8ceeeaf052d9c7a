"""Feature-frequency statistics — the prior MPE's grouping relies on (§3.2).

The port's own copy of the reference's ``repro.embeddings.frequency`` (pure
numpy, the same results): the Zipf profile of the synthetic streams, the
hot/cold split of the tiered cache (``repro_torch.cache``) and an exact
counter.
"""
from __future__ import annotations

import numpy as np


def zipf_frequencies(n: int, exponent: float = 1.1, seed: int | None = None) -> np.ndarray:
    """Expected access counts for a Zipf(exponent) vocabulary of size n."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    f = ranks ** (-exponent)
    if seed is not None:
        rng = np.random.default_rng(seed)
        f = f[rng.permutation(n)]  # decouple id order from rank order
    return f / f.sum()


def hot_feature_mask(frequencies, hot_fraction: float) -> np.ndarray:
    """Boolean mask of the top-``hot_fraction`` features by access frequency.

    The ``ceil(hot_fraction * n)`` most frequent features are pinned in the
    device-resident hot tier, the long tail stays in host memory. Ties are
    broken by feature id (stable), so the split is deterministic.
    ``hot_fraction`` 0 pins nothing, 1 pins everything.
    """
    f = np.asarray(frequencies, np.float64).reshape(-1)
    if not 0.0 <= hot_fraction <= 1.0:
        raise ValueError(f"hot_fraction must be in [0, 1], got {hot_fraction}")
    n_hot = int(np.ceil(hot_fraction * f.shape[0]))
    mask = np.zeros(f.shape, bool)
    if n_hot:
        # stable sort on (-freq, id): deterministic under ties
        order = np.lexsort((np.arange(f.shape[0]), -f))
        mask[order[:n_hot]] = True
    return mask


def count_frequencies(id_batches, n: int) -> np.ndarray:
    """Exact counts over an iterable of integer-array batches."""
    counts = np.zeros((n,), np.int64)
    for batch in id_batches:
        ids = np.asarray(batch).reshape(-1)
        np.add.at(counts, ids, 1)
    return counts
