"""Collective-budget pass (BC5xx): per-cell collective bytes stay bounded.

The port of the reference's ``repro.analysis.budgets``. A layout change can
be numerically perfect and still move extra bytes between ranks (a stray
table gather is orders of magnitude over), so each cell's measured
per-device collective bytes are checked in and gated:

  BC501  a cell's per-device collective bytes (``launch.trace_analysis.
         analyze`` over its op walk) exceed its checked-in budget.
  BC502  a cell has no budget entry — new cells must check in a budget
         (``scripts/staticcheck_torch.py --update-budgets``).

The budgets are the port's own, in ``repro_torch/analysis/budgets.json``,
measured on a 2×2 mesh of 4 gloo ranks (``staticcheck_torch.py --world
4``) with ``HEADROOM`` over the measured bytes. They are not the
reference's HLO bytes: the port's eager-SPMD wrappers return the whole
result on every rank, gathering it over the data axes, which an XLA
partition leaves sharded. On one rank every collective is skipped and a
cell measures 0 bytes.
"""
from __future__ import annotations

import json
import os

from repro_torch.analysis.findings import Finding
from repro_torch.launch.trace_analysis import analyze

BUDGETS_PATH = os.path.join(os.path.dirname(__file__), "budgets.json")

#: headroom multiplier applied by ``--update-budgets``.
HEADROOM = 1.25


def measure_collectives(walk) -> dict:
    """Per-kind collective bytes of one walked step."""
    return analyze(walk)["collectives_per_device"]


def load_budgets(path: str | None = None) -> dict:
    path = path or BUDGETS_PATH
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}


def save_budgets(budgets: dict, path: str | None = None) -> None:
    path = path or BUDGETS_PATH
    with open(path, "w") as f:
        json.dump(budgets, f, indent=2, sort_keys=True)
        f.write("\n")


def budget_entry(measured: dict) -> dict:
    """A fresh budget line: measured total bytes with headroom."""
    return {"total_bytes": int(measured["total_bytes"] * HEADROOM)}


def check_budget(name: str, measured: dict,
                 budgets: dict) -> list[Finding]:
    """BC501/BC502 for one cell's measured collectives."""
    entry = budgets.get(name)
    if entry is None:
        return [Finding(
            "BC502", f"no collective budget checked in for this cell — run "
            f"scripts/staticcheck_torch.py --update-budgets --world 4 and "
            f"commit budgets.json", name)]
    total = float(measured["total_bytes"])
    cap = float(entry["total_bytes"])
    if total > cap:
        kinds = {k: int(v["bytes"]) for k, v in measured.items()
                 if isinstance(v, dict) and v.get("bytes")}
        return [Finding(
            "BC501", f"collective bytes {int(total)} exceed the checked-in "
            f"budget {int(cap)} (per-kind: {kinds}) — a layout change is "
            f"moving extra cross-rank bytes", name)]
    return []
