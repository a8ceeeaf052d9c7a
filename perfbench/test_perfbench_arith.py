"""The yardstick's arithmetic: the byte counts reproduce what the card runs
printed, the inputs are a function of the seed, and the metrics are
whole-window arithmetic."""
import statistics
import types

import numpy as np
import pytest
import torch

from perfbench.lib import bounds
from perfbench.reference import common as C
from perfbench.traffic import open_loop


def test_lookup_bytes_of_the_bulk_request():
    # the DLRM bulk request's lookup as chip_smoke.py printed it (PR 29's
    # final run): 713,560,804 bytes for 10,223,616 ids, d 16, 1,081,059
    # distinct rows, 1,031,928 of them not width 0
    base = bounds.lookup_bytes(10_223_616, 16, 7, 1_081_059, 1_031_928, 0)
    words, rest = divmod(713_560_804 - base, 4)
    assert rest == 0 and 1_031_928 <= words <= 3 * 1_031_928
    assert bounds.packed_rows([5, 0, 0, 2, 0, 0, 1], 16, range(7)) == (3, 7)


def test_qat_bytes_of_the_search_step():
    # mpe_qat at the DLRM search step (65,536 x 39 lookups, d 16, 7 widths)
    assert bounds.qat_bytes(65_536 * 39, 16, 7) == {"fwd": 398_721_116,
                                                    "bwd": 633_864_376}


def test_adam_and_flash_bounds_as_the_card_runs_printed():
    # Adam over the DLRM table: 4.5767 ms; BST's flash at (65,536, 21, 8, 4):
    # forward with statistics 0.2235 ms, backward 0.4338 ms (PERF.md)
    assert bounds.bound_s(bounds.adam_bytes(34_223_104 * 16)) * 1e3 == \
        pytest.approx(4.5767, abs=1e-4)
    fwd = bounds.flash_work(65_536 * 8, 21, 4, "fwd_stats")
    bwd = bounds.flash_work(65_536 * 8, 21, 4, "bwd")
    assert bounds.bound_s(fwd["bytes"], fwd["flops"]) * 1e3 == \
        pytest.approx(0.2235, abs=1e-4)
    assert bounds.bound_s(bwd["bytes"], bwd["flops"]) * 1e3 == \
        pytest.approx(0.4338, abs=1e-4)


def test_dlrm_step_flops():
    # 509 GFLOP a search step of 65,536 rows: the MLP forward and backward
    assert 3 * bounds.dense_flops(65_536, [624, 1024, 512, 256, 1]) == \
        pytest.approx(509e9, rel=2e-3)


def test_zipf_draws_are_the_seeds_and_stay_in_their_fields():
    vocabs = [50, 7, 300]
    cdfs = C.zipf_cdfs(vocabs, 1.1, "cpu")
    a = C.draw_zipf(C.generator(2**40 + 3, 2, "cpu"), cdfs, vocabs, 4096)
    b = C.draw_zipf(C.generator(2**40 + 3, 2, "cpu"), cdfs, vocabs, 4096)
    c = C.draw_zipf(C.generator(2**40 + 4, 2, "cpu"), cdfs, vocabs, 4096)
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo = torch.tensor([0, 50, 57])
    assert a.shape == (4096, 3)
    assert bool(((a >= lo) & (a < lo + torch.tensor(vocabs))).all())
    # rank 1 is the most drawn in every field
    for f in range(3):
        assert int(torch.mode(a[:, f]).values) == int(lo[f])


def test_groups_keep_ties_in_id_order():
    freqs = torch.tensor([0.1, 0.3, 0.1, 0.3, 0.2], dtype=torch.float64)
    gof, sums = C.make_groups(freqs, 2)
    rank = np.empty(5, np.int64)
    rank[np.argsort(-freqs.numpy(), kind="stable")] = np.arange(5)
    assert gof.tolist() == (rank // 2).tolist() == [1, 0, 2, 0, 1]
    assert sums.tolist() == [1.0, 1.0, 1.0]


def test_arrivals_are_the_seeds_and_fill_the_window():
    p = {"rate_per_s": 2000.0, "rows_min": 100, "rows_max": 700}
    a = open_loop.arrivals(2**33 + 1, p, 10.0, 1_000_000)
    b = open_loop.arrivals(2**33 + 1, p, 10.0, 1_000_000)
    assert np.array_equal(a["due"], b["due"])
    assert np.array_equal(a["rows"], b["rows"])
    assert abs(a["due"].size - 20_000) < 600 and a["due"].max() < 10.0
    assert a["rows"].min() >= 100 and a["rows"].max() <= 700
    assert (a["start"] + a["rows"] <= 1_000_000).all()
    sample = open_loop.sample_of(a, 64)
    assert len(sample) > 40
    assert max(a["rows"][list(sample)]) == 700


class FakeEngine:
    """Completes each request at the next round, sheds every seventh."""

    class Stats:
        def occupancy(self):
            return {"c": {"valid_rows": 0, "padded_rows": 0}}

    def __init__(self):
        self.queue, self.done, self.next = [], {}, 0
        self.stats = self.Stats()
        self.scheduler = types.SimpleNamespace(busy=False)

    def summary(self):
        return {}

    def request_summary(self):
        return {}

    def registered_cells(self):
        return {}

    def submit(self, ids, now=None):
        self.next += 1
        if self.next % 7 == 0:
            return None
        self.queue.append((self.next, ids.shape[0]))
        self.scheduler.busy = True
        return self.next

    def sched_step(self):
        for t, n in self.queue:
            self.done[t] = np.zeros(n, np.float32)
        self.queue = []
        self.scheduler.busy = False

    def try_poll(self, t):
        if t in self.done:
            return {"status": "done", "result": self.done.pop(t)}
        return {"status": "pending"}


def test_open_loop_tail_counts_every_request_due():
    p = {"rate_per_s": 400.0, "rows_min": 1, "rows_max": 5,
         "trace_seconds": 0.1, "drain_s": 1.0}
    pool = np.zeros((1000, 3), np.int32)
    a = open_loop.arrivals(5, p, 0.5, pool.shape[0])
    out = open_loop.drive(FakeEngine(), pool, a, p, 0.5, set())
    n = a["due"].size
    assert out["lat_ms"].size == n and out["shed"] == n // 7
    # a shed request waits until the drain ended: it lies in the tail
    assert np.percentile(out["lat_ms"], 99) >= np.percentile(
        out["lat_ms"], 50)
    assert not np.isnan(out["lat_ms"]).any()


def test_whole_window_readers():
    from perfbench import harness
    trace = types.SimpleNamespace(window_s=2.0, busy_s=1.5,
                                  seconds=lambda *p: 0.5,
                                  launches=lambda *p: 10)
    layer = {"trace": trace, "steps": [{"flops": 67e12, "qat": [],
                                        "adam_elements": 10}] * 2,
             "model_flops": 2 * 67e12, "host_ms": [1.0, 2.0, 6.0]}
    read = {name: harness.reader(name).read
            for name in ("mfu.train", "device_idle.train",
                         "train.host_ms_per_step", "adam_roofline")}
    assert read["mfu.train"](layer) == pytest.approx(100.0)
    assert read["device_idle.train"](layer) == pytest.approx(25.0)
    assert read["train.host_ms_per_step"](layer) == statistics.fmean(
        [1.0, 2.0, 6.0])
    assert read["adam_roofline"](layer) == pytest.approx(
        100 * bounds.bound_s(2 * bounds.adam_bytes(10)) / 0.5)
