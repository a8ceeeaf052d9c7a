"""Synthetic token streams for the LM architectures, as the reference's
``repro/data/tokens.py`` draws them: Zipf-distributed unigrams (the
property MPE's frequency grouping exploits on token embeddings) with a
hashed bigram kernel, so next-token prediction has structure beyond
unigram frequency. The same numpy generator and draws in the same order:
the batches are the reference's, bit for bit.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int,
                 zipf_exponent: float = 1.05, seed: int = 0):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = seed
        p = np.arange(1, vocab + 1, dtype=np.float64) ** (-zipf_exponent)
        self.cdf = np.cumsum(p / p.sum())

    def expected_frequencies(self) -> np.ndarray:
        return np.diff(self.cdf, prepend=0.0)

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id, n_hosts]))
        toks = np.empty((self.batch, self.seq_len + 1), np.int64)
        toks[:, 0] = np.searchsorted(self.cdf, rng.random(self.batch))
        for t in range(self.seq_len):
            # bigram kernel: with p=0.5 the next token is a hash of the current
            fresh = np.searchsorted(self.cdf, rng.random(self.batch))
            chained = (toks[:, t] * 2654435761 + 12345) % self.vocab
            use_chain = rng.random(self.batch) < 0.5
            toks[:, t + 1] = np.where(use_chain, chained, fresh)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
