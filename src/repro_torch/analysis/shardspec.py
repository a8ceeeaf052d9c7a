"""Sharding-contract pass (SC2xx): pspec families and the merge invariant.

The port of the reference's ``repro.analysis.shardspec``. Two symbolic
checks run against a cell *definition* (they inspect declared specs, not
placements):

  SC201  a spec entry names a mesh axis outside ``dist.sharding.MESH_AXES``
         — it can never resolve on a production mesh.
  SC202  a spec dim entry normalizes to an axis group outside
         ``dist.sharding.AXIS_GROUPS`` — an out-of-contract placement.

One structural check runs on the op walk of a cell on a mesh of more than
one rank (the port's counterpart of the reference's shard_map check):

  SC204  a sharded wrapper's scope takes operands split over some mesh
         axes and returns a result no longer split over them, but a merge
         it declares is missing: no collective of the merge's kind inside
         it runs over exactly the merge's axes, or an axis split and not
         kept is in no declared merge — the bucket-merge invariant. Every
         ownership-masked rank-local partial (the packed lookup, the
         tiered hot lookup, the bag, the train step's gradients) must be
         merged by a collective over exactly its row axes, or each rank
         returns its own partial as the whole result. A scope merges by
         one all-reduce over the axes split and not kept unless it
         declares otherwise (``repro_torch.kernels.region.sharded``): the
         a2a lookup by the gather of its slices and, when it spills, the
         all-reduce of its spill buffer; flash and the QAT expectation by
         gathers. An all-to-all merges nothing: it only moves rows.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.dist.sharding import (AXIS_GROUPS, MESH_AXES, P,
                                       normalize_entry)


def _iter_specs(tree):
    """Every ``P`` leaf of a (possibly nested) spec tree."""
    if isinstance(tree, P):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_specs(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_specs(v)


def check_spec_tree(tree, where: str, *, role: str) -> list[Finding]:
    """SC201/SC202 over one declared spec tree (``role``: which input or
    output slot, for the message)."""
    findings = []
    for spec in _iter_specs(tree):
        for entry in tuple(spec):
            norm = normalize_entry(entry)
            if norm is None:
                continue
            unknown = [a for a in norm if a not in MESH_AXES]
            if unknown:
                findings.append(Finding(
                    "SC201", f"{role} spec {spec} names mesh axis "
                    f"{unknown[0]!r} not in the production mesh contract "
                    f"{sorted(MESH_AXES)}", where))
            elif norm not in AXIS_GROUPS:
                findings.append(Finding(
                    "SC202", f"{role} spec {spec} entry {entry!r} is not a "
                    f"registered axis group (dist.sharding.AXIS_GROUPS) — "
                    f"use a pspec family from dist/sharding.py", where))
    return findings


def check_celldef_specs(celldef) -> list[Finding]:
    """SC201/SC202 over every declared spec of a ``ServeCellDef``."""
    where = celldef.name
    findings = []
    for i, ps in enumerate(celldef.bound_pspecs):
        findings += check_spec_tree(ps, where, role=f"bound[{i}]")
    for i, ps in enumerate(celldef.request_pspecs):
        findings += check_spec_tree(ps, where, role=f"request[{i}]")
    findings += check_spec_tree(celldef.out_pspecs, where, role="out")
    return findings


def check_scope_merges(walk, where: str) -> list[Finding]:
    """SC204 over every sharded scope of a walked cell."""
    findings = []
    for i, scope in enumerate(walk.scopes):
        missing = tuple(dict.fromkeys(
            a for a in scope.split_axes if a not in scope.kept_axes))
        if not missing:
            continue
        merges = scope.merges if scope.merges is not None \
            else (("all-reduce", missing),)
        seen = {(it.name, frozenset(it.axes)) for it in walk.inside(i)
                if it.kind == "collective"}
        undeclared = sorted(set(missing)
                            - {a for _, axes in merges for a in axes})
        if undeclared:
            findings.append(Finding(
                "SC204", f"{scope.name} splits its operands over "
                f"{undeclared} but no result keeps the axis and no merge "
                f"over it is declared — each rank returns an unmerged "
                f"partial (the bucket-merge invariant)",
                where, file=scope.file, line=scope.line))
        for kind, axes in merges:
            if (kind, frozenset(axes)) not in seen:
                findings.append(Finding(
                    "SC204", f"{scope.name} splits its operands over "
                    f"{list(axes)} but no {kind} inside runs over exactly "
                    f"them — each rank returns an unmerged partial (the "
                    f"bucket-merge invariant)",
                    where, file=scope.file, line=scope.line))
    return findings
