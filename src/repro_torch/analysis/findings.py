"""Finding model shared by every checker, plus pragma suppression.

The port's copy of the reference's ``repro.analysis.findings``: the same
``Finding.render`` format and the same ``# staticcheck: ignore[...]``
pragma.

A ``Finding`` is one rule violation rendered ruff-style::

    src/repro_torch/serve/cells.py:297:1: SC202 out_pspec P(None, 'model') ...
    cell dlrm/serve_p99@64: PF102 int8 -> float32 convert outside ...

Trace-level findings carry the cell/kernel name in ``where`` and, when the
walked op has a user frame, the source ``file``/``line`` it executes from
— which is also where an inline suppression pragma applies::

    deq = codes.to(torch.float32) * alpha  # staticcheck: ignore[PF102]

The pragma suppresses the named rule(s) for findings attributed to that
line (``ignore`` with no bracket suppresses every rule). Suppression is
per-line, not per-file — a blanket opt-out would defeat the gate.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_PRAGMA = re.compile(r"#\s*staticcheck:\s*ignore(?:\[([A-Z0-9,\s]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation."""
    code: str                  # e.g. "PF102"
    message: str
    where: str                 # cell/kernel name, or the linted file
    file: str | None = None    # source file the violation executes from
    line: int | None = None    # 1-indexed line in ``file``
    col: int = 1
    extra: dict = field(default_factory=dict, compare=False)

    def render(self) -> str:
        loc = (f"{self.file}:{self.line}:{self.col}" if self.file
               else self.where)
        prefix = f" [{self.where}]" if self.file and self.where != self.file \
            else ""
        return f"{loc}: {self.code} {self.message}{prefix}"


def parse_pragmas(source: str) -> dict[int, set[str] | None]:
    """line number -> suppressed rule codes (None = every rule)."""
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(text)
        if not m:
            continue
        codes = m.group(1)
        out[i] = (None if codes is None
                  else {c.strip() for c in codes.split(",") if c.strip()})
    return out


class PragmaIndex:
    """Lazy per-file pragma tables for suppression lookups."""

    def __init__(self):
        self._cache: dict[str, dict[int, set[str] | None]] = {}

    def _table(self, path: str) -> dict[int, set[str] | None]:
        if path not in self._cache:
            try:
                with open(path) as f:
                    self._cache[path] = parse_pragmas(f.read())
            except OSError:
                self._cache[path] = {}
        return self._cache[path]

    def suppressed(self, finding: Finding) -> bool:
        if finding.file is None or finding.line is None:
            return False
        codes = self._table(finding.file).get(finding.line, ())
        return codes is None or finding.code in codes


def filter_suppressed(findings, pragmas: PragmaIndex | None = None):
    """Drop findings whose source line carries a matching ignore pragma."""
    pragmas = pragmas if pragmas is not None else PragmaIndex()
    return [f for f in findings if not pragmas.suppressed(f)]
