"""The benchmark's driver, led by data: a cell's file names its configuration
and its traffic driver; the driver runs the program under that traffic and
hands back its end-to-end numbers, the numbers its correctness check
compared, and what the per-layer readers read; this module prints the
result line.

    perfbench/workloads/<cell>.json   the cell: config, driver, parameters,
                                      chips, why, and each check's limit
    perfbench/configs/<config>.json   the configuration's sizes and source
    perfbench/traffic/<driver>.py     run(run) -> outcome
    perfbench/models/<model>.py       the program's side of a model
    perfbench/reference/<model>.py    the plain reference and the inputs
    perfbench/metrics/<reader>.py     read(layer) -> value or None: the
                                      reader of every per-layer metric
                                      whose name is <reader> or starts
                                      with <reader> and a dot

``BENCHMARK.json`` says which end-to-end and per-layer metrics a cell
reports. Every file is found by the name that names it there.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
# top-level module names no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's folders by its file, whose name may hold
    dots (a per-layer metric's)."""
    name = "perfbench_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                   .as_posix().replace(".", "_").split("/"))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or else the
    file of the longest part of the name before a dot (``mfu.train`` is
    read by ``mfu.py``)."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return load_module(path)
    raise FileNotFoundError(f"no reader in perfbench/metrics for {metric!r}")


class Run:
    """One run of a cell: what the driver is given, and the clock of its
    set-up."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float, cfg: dict | None = None,
                 workload: dict | None = None):
        self.name = name
        self.workload = workload or load_json(
            BENCH / "workloads" / f"{name}.json")
        self.cfg = cfg or load_json(
            BENCH / "configs" / f"{self.workload['config']}.json")
        self.params = self.workload["params"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.setup_s = None
        self.model = importlib.import_module(
            f"perfbench.models.{self.cfg['model']}")
        self.reference = importlib.import_module(
            f"perfbench.reference.{self.cfg['model']}")

    def window_starts(self):
        """Set-up ends here: the first timed operation follows."""
        self.setup_s = time.perf_counter() - self.t_start


def execute(run: Run) -> dict:
    """The cell's driver over ``run`` -> its outcome."""
    driver = importlib.import_module(
        f"perfbench.traffic.{run.workload['driver']}")
    return driver.run(run)


def judge(outcome: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    at most its limit (a missing or NaN number is not)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = outcome["checks"].get(name)
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if good or value is None
                        or not math.isnan(value) else None, "limit": limit}
    return ok, checks


def cell_metrics(manifest: dict, name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` gives the
    cell."""
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in names
                              else [])]
    return e2e, layer


def result(run: Run, outcome: dict, manifest: dict, device_info: dict) -> dict:
    e2e, layer = cell_metrics(manifest, run.name)
    values = dict(outcome["e2e"], setup_s=run.setup_s,
                  device_peak_gib=outcome["peak_bytes"] / GIB)
    if run.trace:
        metrics = {}
        for m in layer:
            v = reader(m["name"]).read(outcome["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    correct, checks = judge(outcome, run.workload["limits"])
    out = {"correct": correct,
           "attempted": outcome["attempted"], "failed": outcome["failed"],
           "metrics": metrics,
           "device": dict(device_info,
                          memory_peak_bytes=outcome["peak_bytes"])}
    trace = outcome["layer"].get("trace")
    if run.trace and trace is not None:
        out["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = trace.breakdown()
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              device, t_start)
    outcome = execute(run)
    held = forbidden_modules()
    if held:
        print(f"the process holds {held}: the benchmark and the program "
              f"must not load them", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"]}
    line = result(run, outcome, manifest, info)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
