"""Recompile-hazard pass (RC3xx): keep serving zero-recapture.

The port of the reference's ``repro.analysis.recompile``. The serving
path's contract is *capture once per (arch, shape, device, bound tensors,
mesh)*: ``CellCache`` keys executables by ``(arch,
shape@batch#fingerprint, ...)`` and a warm process captures nothing more.
These rules catch the ways a cell definition breaks that, by diffing the
cache key's ingredients against the abstract signature
(``ServeCellDef.abstract_signature``):

  RC301  a weak leaf — a Python number in ``bound`` (or the request
         specs). Torch promotes it weakly, and a CUDA graph bakes it in as
         a constant: a new value means a new capture, the port's
         counterpart of the weak type that re-traces a jax cell.
  RC302  the fingerprint blob contains a ``0x…`` object address — some
         ``static`` ingredient falls back to the default ``__repr__``, so
         the same registration fingerprints differently every process.
  RC303  two cell definitions produce the same cache key but different
         abstract signatures — the key under-identifies the executable.
  RC304  walking the cell twice yields different op sequences —
         Python-level nondeterminism in the step (dict order, RNG, time)
         makes each capture a different graph.
"""
from __future__ import annotations

import re

from repro_torch.analysis.findings import Finding

_ADDR = re.compile(r"0x[0-9a-fA-F]{6,}")


def check_fingerprint(celldef) -> list[Finding]:
    """RC301/RC302 over one cell definition."""
    findings = []
    blob = celldef.fingerprint_blob
    m = _ADDR.search(blob)
    if m:
        findings.append(Finding(
            "RC302", f"fingerprint blob contains object address {m.group(0)}"
            f" (default __repr__ of a static/meta ingredient) — the "
            f"fingerprint changes every process; give the object a stable "
            f"repr", celldef.name))
    for i, (shape, dtype, weak) in enumerate(celldef.abstract_signature()):
        if weak:
            findings.append(Finding(
                "RC301", f"input leaf #{i} ({dtype}{list(shape)}) is a "
                f"Python number — promoted weakly and baked into the "
                f"captured graph as a constant; bind a 0-d tensor "
                f"(torch.tensor(..., dtype=...)) at build time",
                celldef.name))
    return findings


def _key_of(celldef) -> tuple:
    # the engine's CellKey minus the device, bound tensors and mesh (the
    # same for every cell of one engine's registration)
    return (celldef.arch,
            f"{celldef.shape}@{celldef.batch}#{celldef.fingerprint}")


def check_key_collisions(celldefs) -> list[Finding]:
    """RC303 across a set of cell definitions."""
    findings = []
    seen: dict[tuple, tuple] = {}
    for cd in celldefs:
        key = _key_of(cd)
        sig = cd.abstract_signature()
        prev = seen.setdefault(key, sig)
        if prev != sig:
            findings.append(Finding(
                "RC303", f"cache key {key[1]!r} collides across cell "
                f"definitions with different abstract signatures — the "
                f"second registration warm-hits an executable captured for "
                f"other inputs", cd.name))
    return findings


def check_trace_determinism(celldef, make_walk) -> list[Finding]:
    """RC304: walk twice, compare the op sequences. ``make_walk()`` runs
    the cell under a fresh ``OpWalk`` and returns it (the runner owns the
    mesh and the inputs)."""
    a, b = (_ADDR.sub("0xADDR", repr(make_walk().signature()))
            for _ in range(2))
    if a != b:
        return [Finding(
            "RC304", "walking the step function twice ran different ops — "
            "nondeterministic Python in the cell makes every capture a "
            "different graph", celldef.name)]
    return []
