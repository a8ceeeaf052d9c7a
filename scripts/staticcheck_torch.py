#!/usr/bin/env python
"""Static contract checker CLI for the PyTorch port.

Runs ``repro_torch.analysis`` over the repo: the AST lint (RL4xx) over
``src/repro_torch`` plus the walk-level passes (PF/SC/RC/BC) over the tiny
standard cell corpus, built on the CUDA card (or ``--device cpu``). With
``--world 4`` it starts 4 gloo ranks on the CPU, which serve the corpus on
a 2×2 mesh, so the sharded wrappers' collectives and the a2a cells are
walked; rank 0 reports. Imports neither jax nor the reference package.

Exit codes: 0 clean, 1 findings, 2 internal error.

Usage:
    python scripts/staticcheck_torch.py                   # on the card
    python scripts/staticcheck_torch.py --device cpu      # on the CPU
    python scripts/staticcheck_torch.py --lint-only       # AST rules only
    python scripts/staticcheck_torch.py --trace-only --device cpu
    python scripts/staticcheck_torch.py --select PF,SC2 --device cpu
    python scripts/staticcheck_torch.py --world 4 --update-budgets
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")
WALL_S = 600           # a world's wall limit
GROUP_TIMEOUT_S = 120  # every collective's


def _report(args, report) -> int:
    from repro_torch.analysis.budgets import budget_entry, save_budgets

    if args.update_budgets:
        budgets = {name: budget_entry(measured)
                   for name, measured in sorted(report.measured.items())}
        save_budgets(budgets)
        # stale BC findings were gated on the old file; drop them
        report.findings = [f for f in report.findings
                           if not f.code.startswith("BC")]
        print(f"budgets.json updated: {len(budgets)} cell(s)")
    if args.select:
        prefixes = tuple(p.strip() for p in args.select.split(",")
                         if p.strip())
        report.findings = [f for f in report.findings
                           if f.code.startswith(prefixes)]
    print(report.render())
    return 1 if report.findings else 0


def _rank_main(args) -> int:
    """One gloo rank of a ``--world`` run: the corpus on the 2×2 mesh."""
    import torch
    import torch.distributed as dist

    import repro_torch.analysis as A

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(args.store, 'store')}",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        report = A.run(REPO_ROOT, lint=not args.trace_only and args.rank == 0,
                       device="cpu")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return _report(args, report) if args.rank == 0 else 0


def _world(args, argv) -> int:
    """Start ``--world`` ranks of this script and wait for them all."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as store:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv,
             "--rank", str(r), "--store", store], env=env)
            for r in range(args.world)]
        deadline = time.monotonic() + WALL_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if any(c not in (0, 1) for c in codes):
        print(f"a rank failed: exit codes {codes}", file=sys.stderr)
        return 2
    return codes[0]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lint-only", action="store_true",
                    help="AST rules only; no corpus, no walk")
    ap.add_argument("--trace-only", action="store_true",
                    help="walk-level passes only; skip the AST lint")
    ap.add_argument("--select", default=None, metavar="PREFIXES",
                    help="comma-separated rule-code prefixes to keep "
                         "(e.g. 'PF,SC2')")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite src/repro_torch/analysis/budgets.json "
                         "from the measured collective bytes (+25%% "
                         "headroom) instead of gating on it (measure with "
                         "--world 4)")
    ap.add_argument("--device", default=None,
                    help="the corpus's device (default: the CUDA card)")
    ap.add_argument("--world", type=int, default=1,
                    help="gloo ranks on the CPU (4: the corpus on a 2x2 "
                         "mesh)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)

    if args.lint_only:
        from repro_torch.analysis.lint import lint_tree
        findings = lint_tree(REPO_ROOT)
        for f in findings:
            print(f.render())
        print(f"{len(findings)} lint finding(s)")
        return 1 if findings else 0
    if args.world > 1:
        if args.device not in (None, "cpu"):
            ap.error("--world runs gloo ranks on the CPU")
        if args.rank is None:
            return _world(args, argv)
        return _rank_main(args)

    import repro_torch.analysis as A
    report = A.run(REPO_ROOT, lint=not args.trace_only, device=args.device)
    return _report(args, report)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        import traceback
        traceback.print_exc()
        sys.exit(2)
