"""The per-layer metrics read from the program's spans (``"source":
"program_span"`` in ``BENCHMARK.json``): a traced run of each cell at a
CPU test's size reads a number for every such metric the cell reports; a
reader finds nothing, and says so with None, where the program has no
spans (as before they were added) or the records lie outside the run's
traced window."""
import sys
import time
import types

import pytest
import torch

import repro_torch
from perfbench import harness
from perfbench.test_perfbench_cpu import run_cell, tiny

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
SPAN_METRICS = [m for m in MANIFEST["per_layer"]
                if m["source"] == "program_span"]
CELLS = sorted({c for m in SPAN_METRICS for c in m["workloads"]})


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced run, made once, and the layer its readers read."""
    runs = {}

    def get(cell):
        if cell not in runs:
            w, cfg = tiny(cell)
            run = harness.Run(cell, 2**40 + 41, 0.4, True,
                              torch.device("cpu"), time.perf_counter(),
                              cfg=cfg, workload=w)
            runs[cell] = harness.execute(run)
        return runs[cell]
    return get


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_span_metric(cell):
    line = run_cell(cell, trace=True)
    assert line["correct"], line["checks"]
    want = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    for name in want:
        value = line["metrics"].get(name, {}).get("value")
        assert value is not None and value >= 0, (name, line["metrics"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_a_reader_finds_nothing_without_spans(metric, traced, monkeypatch):
    entry = next(m for m in SPAN_METRICS if m["name"] == metric)
    layer = traced(entry["workloads"][0])["layer"]
    read = harness.reader(metric).read
    assert read(layer) is not None
    later = types.SimpleNamespace(_t0=time.perf_counter() + 60.0,
                                  window_s=layer["trace"].window_s)
    assert read(dict(layer, trace=later)) is None   # records of another run
    assert read(dict(layer, trace=None)) is None    # an untraced run
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(layer) is None                      # a program without spans
