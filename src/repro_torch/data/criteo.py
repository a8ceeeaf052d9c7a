"""Streaming loader for the real Criteo TSV format (deployment path).

The public Criteo Display Advertising Challenge file is TSV:
    label \\t I1..I13 (ints, may be empty) \\t C1..C26 (32-bit hex, may be empty)

This loader applies the paper's §5.1.1 preprocessing exactly:
  - numeric x -> floor(log²(x)) for x > 2 else 1 (discretized to categorical);
  - missing values -> a per-field sentinel id;
  - features seen once -> OOV (approximated streaming via a min-count filter
    built on a first counting pass, or a user-provided vocab);
  - each of the 39 resulting categorical fields gets its own id space.

Usage:
    vocabs, counts = build_criteo_vocab("train.txt", min_count=2)
    ds = CriteoTSV("train.txt", vocabs, batch_size=10_000)
    for step, batch in enumerate(ds):   # {"ids": (B, 39) int32, "label": (B,)}
        ...

The reading and the vocabularies are host code, the reference's line for
line; batches come out as tensors on the caller's device (the CUDA card
unless the caller names another). The synthetic generator
(``data/synthetic.py``) stays the default stream; this module reads local
files only.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from repro_torch.device import resolve_device

N_INT, N_CAT = 13, 26
N_FIELDS = N_INT + N_CAT


def _discretize(raw: str) -> str:
    """Paper §5.1.1: x -> floor(log²(x)) for x>2 else 1; '' -> missing."""
    if raw == "":
        return "<missing>"
    x = int(raw)
    if x <= 2:
        return "1"
    return str(int(math.floor(math.log(x) ** 2)))


def _row_tokens(line: str):
    parts = line.rstrip("\n").split("\t")
    label = int(parts[0])
    toks = []
    for i in range(N_INT):
        raw = parts[1 + i] if 1 + i < len(parts) else ""
        toks.append(_discretize(raw))
    for c in range(N_CAT):
        raw = parts[1 + N_INT + c] if 1 + N_INT + c < len(parts) else ""
        toks.append(raw if raw else "<missing>")
    return label, toks


def build_criteo_vocab(path: str, min_count: int = 2, max_rows: int | None = None):
    """First pass: per-field token counts -> vocab dicts (token -> local id).

    Tokens below ``min_count`` map to the field's OOV id (paper: features
    appearing once are replaced by OOV). id 0 is OOV for every field.
    """
    counts = [defaultdict(int) for _ in range(N_FIELDS)]
    with open(path) as f:
        for n, line in enumerate(f):
            if max_rows is not None and n >= max_rows:
                break
            _, toks = _row_tokens(line)
            for fi, t in enumerate(toks):
                counts[fi][t] += 1
    vocabs = []
    for fi in range(N_FIELDS):
        vocab = {"<oov>": 0}
        for tok, c in sorted(counts[fi].items(), key=lambda kv: -kv[1]):
            if c >= min_count:
                vocab[tok] = len(vocab)
        vocabs.append(vocab)
    return vocabs, counts


def vocab_sizes(vocabs) -> tuple:
    return tuple(len(v) for v in vocabs)


def frequencies_from_counts(vocabs, counts) -> np.ndarray:
    """Global per-feature frequency vector aligned with the offsets layout —
    MPE's grouping prior, from the same counting pass."""
    sizes = vocab_sizes(vocabs)
    out = np.zeros((sum(sizes),), np.float64)
    offset = 0
    for fi, vocab in enumerate(vocabs):
        for tok, lid in vocab.items():
            out[offset + lid] = counts[fi].get(tok, 1)
        # OOV absorbs the filtered tail
        tail = sum(c for t, c in counts[fi].items() if t not in vocab)
        out[offset] = max(tail, 1)
        offset += sizes[fi]
    return out


class CriteoTSV:
    """Second pass: stream batches of globalizable local ids, as int32
    tensors on ``device``."""

    def __init__(self, path: str, vocabs, batch_size: int = 10_000,
                 loop: bool = False, device=None):
        self.path, self.vocabs, self.batch_size = path, vocabs, batch_size
        self.loop = loop
        self.device = resolve_device(device)

    def __iter__(self):
        for batch in self._host_batches():
            yield {k: torch.from_numpy(v).to(self.device)
                   for k, v in batch.items()}

    def _host_batches(self):
        while True:
            with open(self.path) as f:
                ids = np.zeros((self.batch_size, N_FIELDS), np.int32)
                labels = np.zeros((self.batch_size,), np.int32)
                fill = 0
                for line in f:
                    label, toks = _row_tokens(line)
                    for fi, t in enumerate(toks):
                        ids[fill, fi] = self.vocabs[fi].get(t, 0)
                    labels[fill] = label
                    fill += 1
                    if fill == self.batch_size:
                        yield {"ids": ids.copy(), "label": labels.copy()}
                        fill = 0
                if fill:  # final partial batch, padded by repetition
                    reps = -(-self.batch_size // fill)
                    yield {"ids": np.tile(ids[:fill], (reps, 1))[:self.batch_size],
                           "label": np.tile(labels[:fill], reps)[:self.batch_size]}
            if not self.loop:
                return
