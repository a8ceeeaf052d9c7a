"""repro_torch.analysis — static contract checker for the port.

The port of the reference's ``repro.analysis``. Four walk-level passes
run over the op walks of registered serving cells (``.op_walk``: every
aten op a step runs, kernel calls as opaque regions, collectives where
``dist/shard.py`` issues them), plus an AST lint over ``src/repro_torch``,
all reported ruff-style with the reference's rule codes:

==========  ============================================================
 PF1xx       precision flow (``.precision``): float64 leaks, dequants
             outside the sanctioned modules, packed words into float
             math, int8 wraparound arithmetic
 SC2xx       sharding contract (``.shardspec``): specs vs the
             ``dist.sharding`` mesh contract; the sharded wrappers'
             bucket-merge invariant
 RC3xx       recompile hazards (``.recompile``): Python numbers among a
             cell's inputs, unstable fingerprints, cache-key collisions,
             walk nondeterminism
 BC5xx       collective budgets (``.budgets``): per-cell cross-rank
             bytes vs checked-in ``budgets.json``
 RL4xx       source lint (``.lint``): hand-rolled partition specs, raw
             collectives outside ``dist/``, host syncs in the serve
             path, float64 literals, nondeterminism in cell-definition
             modules
==========  ============================================================

Entry points: ``run`` (the whole gate — what
``scripts/staticcheck_torch.py`` calls), or the per-pass ``check_*``
functions. Inline suppression: ``# staticcheck: ignore[PF102]`` on the
offending line. Nothing here imports jax or the reference package.
"""
from repro_torch.analysis.findings import (Finding, PragmaIndex,
                                           filter_suppressed, parse_pragmas)
from repro_torch.analysis.runner import (Report, check_cell, check_engine,
                                         lint_tree, run)

__all__ = [
    "Finding", "PragmaIndex", "Report", "check_cell", "check_engine",
    "filter_suppressed", "lint_tree", "parse_pragmas", "run",
]
