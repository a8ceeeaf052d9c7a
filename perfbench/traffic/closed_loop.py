"""Closed-loop bulk scoring: one caller sends a request, waits for its
scores, sends the next (offline batch scoring: every request is exactly
``rows`` rows, the largest bucket's, so it bypasses coalescing and the
bucket choice). Its ids are a slice of the pool made in set-up, at a start
drawn from the seed. The window counts the rows whose scores reached the
host. The answers of ``check_requests`` requests, drawn from the seed among
the first ``check_span``, are held against the reference once the engine
is gone. Traced, ``trace_requests`` more requests run under the profiler
after the window.

Parameters: ``rows``, ``pool_rows``, ``buckets``, ``queue_capacity``,
``coalesce_window_ms``, ``check_requests``, ``check_span``,
``trace_requests``.
"""
from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from perfbench.lib.trace import Trace
from perfbench.traffic import scoring


FAULTS = scoring.FAULTS
TINY = dict(scoring.TINY, rows=2048, trace_requests=2, check_span=3)


def plan(seed: int, p: dict, pool_rows: int) -> tuple:
    """Each request's start in the pool, and the requests checked."""
    rng = np.random.default_rng([seed % (1 << 63), 13])
    starts = rng.integers(0, pool_rows - p["rows"] + 1, 4096)
    sample = set(rng.choice(p["check_span"], p["check_requests"],
                            replace=False).tolist())
    return starts, sample


def control(run, seed: int) -> dict:
    p = run.params
    ref = run.reference.Model(run.cfg, run.device)
    pool = ref.request_pool(seed, p["pool_rows"]).cpu().numpy()
    starts, sample = plan(seed, p, pool.shape[0])
    return scoring.control(run, seed, [pool[starts[j]:][:p["rows"]]
                                       for j in sorted(sample)])


def run(run) -> dict:
    p, dev = run.params, run.device
    ref, engine, pool = scoring.setup(run)
    rows = p["rows"]
    starts, sample = plan(run.seed, p, pool.shape[0])
    answers, wrong = {}, 0

    def score(i: int):
        nonlocal wrong
        ids = pool[starts[i % starts.size]:][:rows]
        with record_function("bench.request"):
            t = engine.submit(ids)
            engine.sched_step()
            st = engine.try_poll(t) if t is not None else {"status": "shed"}
        if st["status"] != "done" or st["result"].shape[0] != rows:
            wrong += 1
        elif i in sample:
            answers[i] = st["result"]

    before = scoring.counters(engine)
    run.window_starts()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < run.seconds:
        score(n)
        n += 1
    window_s = time.perf_counter() - t0
    counts = scoring.delta(before, scoring.counters(engine))
    trace, record = None, scoring.DispatchRecord(engine)
    if run.trace:
        trace = Trace()
        trace.start()
        with record:
            for i in range(n, n + p["trace_requests"]):
                score(i)
        trace.stop()
    peak = scoring.peak_bytes(dev)
    del engine
    gap, nbytes = scoring.finish(
        run, ref, [(pool[starts[j]:][:rows], v)
                   for j, v in sorted(answers.items())], record.dispatches)
    layer = {"counts": counts, "trace": trace,
             "dispatches": len(record.dispatches), "lookup_bytes": nbytes,
             "model_flops": run.model.score_flops(
                 run.cfg, rows * len(record.dispatches))}
    return {"e2e": {"score_rows_per_s": (n - wrong) * rows / window_s},
            "attempted": n, "failed": wrong,
            "checks": {"score_gap": gap, "unanswered": float(wrong)},
            "peak_bytes": peak, "layer": layer}
