"""Request batching onto registered cell shapes.

Serving executables are compiled at a small set of fixed batch shapes (the
cell-shape registry: e.g. ``serve_p99`` = 512 rows, ``serve_bulk`` = 262144).
An incoming request of arbitrary size is *planned* onto those shapes:

  - a request that fits rides the smallest bucket that holds it (a 300-row
    request pads to the 512-row ``serve_p99`` cell);
  - an oversized request (a 100k bulk job against a 4k bulk cell) is chunked
    into full largest-bucket chunks plus a remainder on the smallest bucket
    that holds it.

Padding appends rows of id 0 (always a valid row — lookups stay in-bounds)
and carries a validity mask; ``unpad`` drops the padded tail. Padded rows are
wasted compute, never wrong answers: serving runs the models in eval mode,
where every row is computed independently (BatchNorm reads running stats).

``pack`` is the coalescing variant (the scheduler's planner): many pending
requests are packed as one concatenated super-request onto the same buckets,
and each ``Chunk`` carries per-request ``Span``s so one padded cell
invocation serves many callers and outputs scatter back per requester.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Span(NamedTuple):
    """One requester's slice of a coalesced chunk: rows
    ``[src_start, src_start + n)`` of request ``req`` land at rows
    ``[dst_start, dst_start + n)`` of the padded chunk (and its outputs
    scatter back the same way)."""
    req: int         # requester index (position in the packed sequence)
    src_start: int   # offset within the request
    dst_start: int   # offset within the chunk
    n: int           # rows carried


class Chunk(NamedTuple):
    """One slice of a planned request: which registered bucket serves rows
    ``[start, start + n_valid)`` of the original request, padded up to the
    bucket's compiled capacity ``rows``.

    ``spans`` is set by the coalescing planner (``pack``): the per-request
    row spans sharing this chunk, so one padded cell invocation serves many
    requesters and ``unpad`` scatters results back per requester. A
    single-request plan leaves it None."""
    bucket: str      # registered shape name
    rows: int        # bucket capacity (the compiled leading dim)
    start: int       # offset of this chunk in the request (packed order)
    n_valid: int     # real rows carried (<= rows)
    spans: tuple = None   # per-request Spans (coalesced plans only)


class RequestBatcher:
    """Shape registry + planning + pad/unpad."""

    def __init__(self, shapes: dict[str, int] | None = None):
        self._shapes: dict[str, int] = {}
        for name, rows in (shapes or {}).items():
            self.register(name, rows)

    def register(self, name: str, rows: int):
        if rows <= 0:
            raise ValueError(f"bucket {name!r}: rows must be positive")
        self._shapes[name] = int(rows)

    @property
    def shapes(self) -> dict[str, int]:
        return dict(self._shapes)

    def _sorted(self):
        return sorted(self._shapes.items(), key=lambda kv: (kv[1], kv[0]))

    def smallest_fitting(self, n: int) -> tuple[str, int] | None:
        for name, rows in self._sorted():
            if rows >= n:
                return name, rows
        return None

    def plan(self, n: int) -> list[Chunk]:
        """Cover an ``n``-row request with registered buckets."""
        if not self._shapes:
            raise ValueError("no cell shapes registered")
        if n <= 0:
            raise ValueError(f"empty request (n={n})")
        max_name, max_rows = max(self._sorted(), key=lambda kv: kv[1])
        chunks, start = [], 0
        while n - start > max_rows:
            chunks.append(Chunk(max_name, max_rows, start, max_rows))
            start += max_rows
        rem = n - start
        name, rows = self.smallest_fitting(rem)
        chunks.append(Chunk(name, rows, start, rem))
        return chunks

    def pack(self, sizes) -> list[Chunk]:
        """Coalesce many requests into cell-shaped chunks.

        ``sizes`` is the pending requests' row counts in dispatch (FIFO)
        order. The packed plan covers their *concatenation* with registered
        buckets — identical bucket choices to ``plan(sum(sizes))``, so a
        single request packs exactly like it plans — and each chunk carries
        the ``Span``s mapping its rows back to (request, offset). Every
        request's rows appear exactly once, in order, across the spans.
        """
        sizes = [int(n) for n in sizes]
        for i, n in enumerate(sizes):
            if n <= 0:
                raise ValueError(f"empty request at position {i} (n={n})")
        chunks = self.plan(sum(sizes))
        # walk the requests across the chunk boundaries
        out, req, consumed = [], 0, 0
        for chunk in chunks:
            spans, filled = [], 0
            while filled < chunk.n_valid:
                take = min(sizes[req] - consumed, chunk.n_valid - filled)
                spans.append(Span(req, consumed, filled, take))
                filled += take
                consumed += take
                if consumed == sizes[req]:
                    req, consumed = req + 1, 0
            out.append(chunk._replace(spans=tuple(spans)))
        return out

    @staticmethod
    def gather(arrs, chunk: Chunk) -> np.ndarray:
        """Assemble a coalesced chunk's valid rows from the per-request
        arrays (``arrs[span.req]``), in span order."""
        parts = [np.asarray(arrs[s.req])[s.src_start:s.src_start + s.n]
                 for s in chunk.spans]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    @staticmethod
    def scatter(out, chunk: Chunk, sinks):
        """Scatter a cell output's valid rows back per requester:
        ``sinks[span.req][span.src_start : +span.n] = out[span.dst_start : +span.n]``."""
        for s in chunk.spans:
            sinks[s.req][s.src_start:s.src_start + s.n] = \
                np.asarray(out)[s.dst_start:s.dst_start + s.n]

    @staticmethod
    def pad(arr: np.ndarray, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """Pad axis 0 to ``rows`` with zeros; returns (padded, validity mask)."""
        arr = np.asarray(arr)
        n = arr.shape[0]
        if n > rows:
            raise ValueError(f"chunk of {n} rows exceeds bucket of {rows}")
        mask = np.zeros((rows,), bool)
        mask[:n] = True
        if n == rows:
            return arr, mask
        pad_width = [(0, rows - n)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width), mask

    @staticmethod
    def unpad(out, n_valid: int):
        """Drop the padded tail of a cell output (leading axis)."""
        return out[:n_valid]

    def split(self, arr: np.ndarray):
        """Plan + pad a whole request: yields (chunk, padded, mask)."""
        arr = np.asarray(arr)
        for chunk in self.plan(arr.shape[0]):
            padded, mask = self.pad(
                arr[chunk.start:chunk.start + chunk.n_valid], chunk.rows)
            yield chunk, padded, mask
