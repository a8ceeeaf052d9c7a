"""The yardstick's arithmetic: the card's published peaks, and the bytes and
operations each measured kernel must move or compute for its call's shapes
and inputs. A roofline share is the least time these allow over the time
the trace gives the kernel's launches.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; where the work depends on the data, what
these inputs need (distinct rows and their widths for a lookup, touched
rows for a segment sum).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: device memory 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s (the configurations run float32 with
# TF32 off, so their products run there)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

F32 = 4


def bound_s(nbytes: float, flops: float = 0.0,
            flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """The least time for ``nbytes`` of device memory traffic and
    ``flops`` operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)


def words_per_row(d: int, b: int) -> int:
    """32-bit words of one packed row of ``d`` codes at ``b`` bits."""
    return -(-d * b // 32)


def lookup_bytes(n_ids: int, d: int, m: int, distinct: int, kept: int,
                 words: int) -> int:
    """The packed lookup of ``n_ids`` ids of width ``d`` (``m`` candidate
    widths) over ``distinct`` distinct rows, ``kept`` of them not of width
    0, whose packed rows hold ``words`` words in all: per id the id read
    and its float32 row written; per distinct row its width entry and,
    where its width is not 0, its local index and packed words; alpha and
    beta once."""
    return (n_ids * (F32 + F32 * d) + distinct * F32 + kept * F32
            + F32 * words + F32 * (m + d))


def packed_rows(width_counts, d: int, bits) -> tuple:
    """(kept, words) of distinct rows counted by width index."""
    kept = sum(c for i, c in enumerate(width_counts) if bits[i])
    words = sum(c * words_per_row(d, bits[i])
                for i, c in enumerate(width_counts) if bits[i])
    return kept, words


def qat_bytes(t: int, d: int, m: int) -> dict:
    """The Eq. 9 mixture over ``t`` rows of width ``d`` and ``m`` widths:
    the forward reads rows, probabilities, alpha, beta and writes the
    mixture; the backward reads those and the cotangent and writes the
    four gradients."""
    fwd = F32 * (t * d + t * m + m + d + t * d)
    bwd = F32 * (t * d + t * m + m + d + t * d + t * d + t * m + m + d)
    return {"fwd": fwd, "bwd": bwd}


def segment_bytes(t: int, w: int, touched: int) -> int:
    """A gather's backward: the sort of ``t`` int32 ids (read, then the
    sorted ids and int64 positions written), the cotangent (t, w) and the
    sorted ids read, the ``touched`` distinct rows of the gradient
    written."""
    sort = t * F32 + t * (F32 + 8)
    return sort + t * w * F32 + t * F32 + touched * w * F32


def adam_bytes(elements: int) -> int:
    """One Adam pass over float32 leaves: parameter, gradient and both
    moments read, parameter and moments written."""
    return 7 * F32 * elements


def flash_work(bh: int, s: int, hd: int, kind: str,
               causal: bool = False) -> dict:
    """Flash attention over ``bh`` (batch x head) sequences of ``s``: the
    forward with its logsumexp rows reads q, k, v and writes o and lse;
    the backward reads q, k, v, o, do and lse and writes dq, dk, dv. The
    products: q k^T and p v forward, five of them backward."""
    tensor, rows = F32 * bh * s * hd, F32 * bh * s
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    nbytes = {"fwd_stats": 4 * tensor + rows, "bwd": 8 * tensor + rows}[kind]
    flops = (10 if kind == "bwd" else 4) * hd * pairs
    return {"bytes": nbytes, "flops": flops}


def dense_flops(rows: int, dims) -> int:
    """Forward operations of a chain of dense products over ``rows``:
    2 x rows x d_in x d_out a product."""
    return 2 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
