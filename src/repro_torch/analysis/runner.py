"""Orchestrates the static-analysis passes into one report.

The port of the reference's ``repro.analysis.runner``. Two independent
halves:

* ``check_engine(engine)`` — the walk-level passes over every cell an
  engine has registered: precision flow (PF1xx), sharding contract (SC2xx),
  recompile hazards (RC3xx), collective budgets (BC5xx).
* ``lint_tree(repo_root)`` (from ``.lint``) — the AST rules (RL4xx) over
  ``src/repro_torch``.

``run(repo_root)`` is the whole gate: build the tiny standard corpus
(``.corpus``), run both halves, return findings sorted by rule code.
Findings carrying a file/line honor ``# staticcheck: ignore[...]`` pragmas
at that line (walk-level findings attribute to the *user frame* of the
offending op, so the pragma goes where the op is written).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.budgets import (check_budget, load_budgets,
                                          measure_collectives)
from repro_torch.analysis.corpus import (budget_name, build_corpus, is_packed,
                                         walk_cell)
from repro_torch.analysis.findings import (Finding, PragmaIndex,
                                           filter_suppressed)
from repro_torch.analysis.lint import lint_tree
from repro_torch.analysis.precision import check_precision
from repro_torch.analysis.recompile import (check_fingerprint,
                                            check_key_collisions,
                                            check_trace_determinism)
from repro_torch.analysis.shardspec import (check_celldef_specs,
                                            check_scope_merges)


@dataclass
class Report:
    """One static-analysis run: findings, the per-cell collective
    measurements (kept so ``--update-budgets`` reuses them), the kernel
    regions each cell's walk saw and, for each region, how many walks
    (RC304 walks each cell twice more) showed it."""
    findings: list = field(default_factory=list)
    measured: dict = field(default_factory=dict)   # budget name -> bytes
    regions: dict = field(default_factory=dict)    # cell name -> names
    region_walks: dict = field(default_factory=dict)   # name -> walks
    n_cells: int = 0

    def count_regions(self, walk):
        """``walk``, after adding one to each of its regions' walks."""
        for name in {it.name for it in walk.regions()}:
            self.region_walks[name] = self.region_walks.get(name, 0) + 1
        return walk

    @property
    def codes(self) -> set:
        return {f.code for f in self.findings}

    def render(self) -> str:
        lines = [f.render() for f in
                 sorted(self.findings, key=lambda f: (f.code, f.where))]
        lines.append(f"{len(self.findings)} finding(s) across "
                     f"{self.n_cells} cell(s)")
        return "\n".join(lines)


def check_cell(reg, mesh, device, *, budgets=None,
               report: Report | None = None,
               skip_budgets: bool = False) -> Report:
    """Every walk-level pass over one registered cell."""
    report = report if report is not None else Report()
    celldef = reg.celldef
    walk = report.count_regions(walk_cell(reg, mesh, device))

    # walk-level findings attribute to the op's line: its pragma applies
    report.findings += filter_suppressed(
        check_precision(walk, celldef.name, packed=is_packed(celldef))
        + check_scope_merges(walk, celldef.name))
    report.findings += check_celldef_specs(celldef)
    report.findings += check_fingerprint(celldef)
    report.findings += check_trace_determinism(
        celldef,
        lambda: report.count_regions(walk_cell(reg, mesh, device)))
    report.regions[celldef.name] = sorted({it.name for it in walk.regions()})

    if not skip_budgets:
        name = budget_name(reg.cell.key)
        measured = measure_collectives(walk)
        report.measured[name] = measured
        report.findings += check_budget(name, measured,
                                        budgets if budgets is not None
                                        else {})
    report.n_cells += 1
    return report


def check_engine(engine, *, budgets=None,
                 skip_budgets: bool = False) -> Report:
    """All walk-level passes over every cell ``engine`` registered."""
    report = Report()
    cells = engine.registered_cells()
    for reg in cells.values():
        check_cell(reg, engine.mesh, engine.device, budgets=budgets,
                   report=report, skip_budgets=skip_budgets)
    report.findings += check_key_collisions(
        [reg.celldef for reg in cells.values()])
    return report


def run(repo_root: str, *, mesh=None, lint: bool = True,
        trace: bool = True, budgets: dict | None = None,
        device=None) -> Report:
    """The whole gate: corpus on ``device`` (default: the CUDA card) +
    walk-level passes + source lint. ``budgets`` defaults to the checked-in
    ``budgets.json``."""
    report = Report()
    if trace:
        engine = build_corpus(mesh, device=device)
        report = check_engine(
            engine, budgets=budgets if budgets is not None
            else load_budgets())
    if lint:
        report.findings += lint_tree(repo_root)

    # walk-level findings with a file/line honor source pragmas too (lint
    # findings were already filtered in lint_source; re-checking is
    # idempotent)
    pragmas = PragmaIndex()
    report.findings = [f for f in report.findings
                       if not pragmas.suppressed(f)]
    report.findings.sort(key=lambda f: (f.code, f.where, f.line or 0))
    return report


__all__ = ["Report", "check_cell", "check_engine", "lint_tree", "run",
           "Finding"]
