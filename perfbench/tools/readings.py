"""The readings that set a cell's limits, at the cell's own sizes, in one
process: the program's on sound runs (``--program``), the control's
(``--control``: the plain reference in the program's place, its float32
products in TF32, the nearest precision below the configurations' float32
with TF32 off) and the program's with a fault of ``perfbench/faults``
planted in its timed path (``--fault <name>:<seeds>``, repeatable). Each
run of the program is a whole run of the cell (its window ``--seconds``
long) by the harness; each prints one JSON line: every number the cell's
driver reads, and whether the cell's limits call it correct.

    python3 perfbench/tools/readings.py --workload dlrm-criteo.search \\
        --program 1,2,3 --control 4,5,6 --fault table_unchanged:7,8 --seconds 2
"""
import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def program(run, fault: str | None = None) -> dict:
    """A whole run of the cell, a fault planted where ``fault`` names one."""
    with pytest.MonkeyPatch.context() as mp:
        if fault is not None:
            importlib.import_module(f"perfbench.faults.{fault}").plant(mp)
        out = harness.execute(run)
    ok, _ = harness.judge(out, run.workload["limits"])
    return {"correct": ok, "readings": out["checks"], "e2e": out["e2e"]}


def control(run, seed: int) -> dict:
    """The control's readings on ``seed`` at the run's sizes, and whether
    the cell's limits call them correct."""
    driver = importlib.import_module(
        f"perfbench.traffic.{run.workload['driver']}")
    readings = driver.control(run, seed)
    ok, _ = harness.judge({"checks": readings},
                          {k: v for k, v in run.workload["limits"].items()
                           if k in readings})
    return {"correct": ok, "readings": readings}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    plan = [("program", None, s) for s in seeds(args.program)]
    plan += [("control", None, s) for s in seeds(args.control)]
    for spec in args.fault:
        name, _, listed = spec.partition(":")
        plan += [("fault", name, s) for s in seeds(listed)]
    for mode, fault, seed in plan:
        t0 = time.perf_counter()
        run = harness.Run(args.workload, seed, args.seconds, False, device,
                          t0)
        out = (control(run, seed) if mode == "control"
               else program(run, fault))
        del run
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "mode": mode,
                          "fault": fault, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)


if __name__ == "__main__":
    main()
