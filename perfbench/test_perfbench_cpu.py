"""Whole runs of each cell of ``BENCHMARK.json`` on the CPU at a reduced
size (the port's plain kernels against the plain reference), and the same
runs with the timed path broken underneath: each fault a cell can have
must turn ``correct`` false. The harness's look for a card is skipped;
the rest of a run is driven. A cell's reduced size is what its model's
reference (``TINY``) and its traffic driver (``TINY``) declare; its faults
are the ones its driver names (``FAULTS``, files of ``faults/``)."""
import copy
import importlib
import time

import pytest
import torch

from perfbench import harness

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def workload(cell: str) -> dict:
    return harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")


def driver(cell: str):
    return importlib.import_module(
        f"perfbench.traffic.{workload(cell)['driver']}")


FAULTS = [(c, f) for c in CELLS for f in driver(c).FAULTS]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cell: str) -> tuple:
    """The cell's workload and configuration cut to a CPU's size."""
    w = copy.deepcopy(workload(cell))
    cfg = copy.deepcopy(harness.load_json(harness.BENCH / "configs" /
                                          f"{w['config']}.json"))
    ref = importlib.import_module(f"perfbench.reference.{cfg['model']}")
    cfg.update(copy.deepcopy(ref.TINY))
    w["params"].update(copy.deepcopy(driver(cell).TINY))
    return w, cfg


def run_cell(cell: str, trace: bool = False, seconds: float = 0.4) -> dict:
    w, cfg = tiny(cell)
    run = harness.Run(cell, 2**40 + 17, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), cfg=cfg, workload=w)
    out = harness.execute(run)
    return harness.result(run, out, MANIFEST, {"platform": "cpu"})


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    line = run_cell(cell, trace=workload(cell)["driver"] == "train_steps")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    importlib.import_module(f"perfbench.faults.{fault}").plant(monkeypatch)
    line = run_cell(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_every_limit(cell):
    """The control's readings name every number the cell's limits do (on
    the CPU, TF32 changes nothing: the card's test holds it not
    correct)."""
    from perfbench.tools import readings
    w, cfg = tiny(cell)
    run = harness.Run(cell, 2**40 + 29, 0.4, False, torch.device("cpu"),
                      time.perf_counter(), cfg=cfg, workload=w)
    out = readings.control(run, run.seed)
    assert set(w["limits"]) - {"unanswered"} <= set(out["readings"])
