"""On the card: the control (the plain reference in the program's place,
its float32 products in TF32) must come out not correct in every cell of
``BENCHMARK.json``, at the cell's own sizes, by the cell's own limits."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.tools import readings

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, card):
    run = harness.Run(cell, 2**35 + 7, 30.0, False, card, time.perf_counter())
    out = readings.control(run, run.seed)
    assert not out["correct"], out["readings"]
