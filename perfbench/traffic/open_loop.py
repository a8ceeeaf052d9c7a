"""Open-loop ranking traffic: independent users' requests arrive on the wall
clock at a fixed rate, whatever the system's state, and each is timed from
when it was due.

The arrivals are drawn from the seed before the window: Poisson at
``rate_per_s`` (exponential gaps), each request ``rows_min`` to
``rows_max`` candidate rows (uniform), its ids a slice of the pool made in
set-up. One thread submits every request whose due time has passed
(stamping ``now=`` its due time), runs one scheduling round of the engine
and polls. When the window closes, what is due and not yet submitted is
submitted, and the engine is drained (up to ``drain_s``): a request's
latency runs from its due time to the moment its scores are on the host,
on the wall clock. A shed request counts as failed; one that never comes
back, or comes back with the wrong number of scores, as wrong. A sample of
the answers drawn from the seed, the longest requests among them, is held
against the reference once the engine is gone. Traced, the profiler
covers the window's last ``trace_seconds``.

Parameters: ``rate_per_s``, ``rows_min``, ``rows_max``, ``pool_rows``,
``buckets``, ``queue_capacity``, ``coalesce_window_ms``,
``check_requests``, ``drain_s``, ``trace_seconds``.
"""
from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from perfbench.lib.trace import Trace
from perfbench.traffic import scoring


FAULTS = scoring.FAULTS
TINY = dict(scoring.TINY, rate_per_s=40.0, rows_min=10, rows_max=70,
            check_requests=8, trace_seconds=0.2)


def arrivals(seed: int, p: dict, seconds: float, pool_rows: int) -> dict:
    """Due offsets (s) within the window, row counts and pool starts."""
    rng = np.random.default_rng([seed % (1 << 63), 11])
    rate = p["rate_per_s"]
    n = int(rate * seconds + 10 * np.sqrt(rate * seconds) + 10)
    due = np.cumsum(rng.exponential(1.0 / rate, n))
    due = due[due < seconds]
    rows = rng.integers(p["rows_min"], p["rows_max"] + 1, due.size)
    start = rng.integers(0, pool_rows - rows + 1)
    return {"due": due, "rows": rows, "start": start, "rng": rng}


def sample_of(a: dict, k: int) -> set:
    """``k`` request indices: the longest half, the rest drawn at random."""
    n = a["due"].size
    longest = np.argsort(-a["rows"], kind="stable")[:k // 2]
    rest = a["rng"].choice(n, size=min(k, n), replace=False)
    return set(longest.tolist()) | set(rest[:k - longest.size].tolist())


def drive(engine, pool, a: dict, p: dict, seconds: float, sample: set,
          trace=None, on_start=None) -> dict:
    """The open loop over the arrivals ``a`` for ``seconds``, then the
    drain; ``trace`` (started for the window's last ``trace_seconds``, with
    every dispatch's rows recorded) is stopped after the drain."""
    n = a["due"].size
    tickets: dict[int, int] = {}          # ticket -> request index
    done_t = np.full(n, np.nan)
    lag = np.full(n, np.nan)
    answers, backlog = {}, []
    tally = {"shed": 0, "wrong": 0}
    record = scoring.DispatchRecord(engine)
    tracing = False

    def poll_all():
        now = time.perf_counter()
        for t in list(tickets):
            st = engine.try_poll(t)
            if st["status"] == "pending":
                continue
            i = tickets.pop(t)
            if st["status"] == "done":
                done_t[i] = now
                if st["result"].shape[0] != a["rows"][i]:
                    tally["wrong"] += 1
                elif i in sample:
                    answers[i] = st["result"]
            elif st["status"] == "shed":
                tally["shed"] += 1
            else:
                tally["wrong"] += 1

    def submit(i: int, due_abs: float):
        rows, s = a["rows"][i], a["start"][i]
        with record_function("bench.submit"):
            t = engine.submit(pool[s:s + rows], now=due_abs)
        lag[i] = time.perf_counter() - due_abs
        if t is None:
            tally["shed"] += 1
        else:
            tickets[t] = i

    before = scoring.counters(engine)
    if on_start is not None:
        on_start()
    t0 = time.perf_counter() + 1e-3
    due = t0 + a["due"]
    t_end = t0 + seconds
    t_trace = t_end - p["trace_seconds"]
    i = 0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if trace is not None and not tracing and now >= t_trace:
            trace.start()
            record.__enter__()
            tracing = True
        while i < n and due[i] <= now:
            submit(i, due[i])
            i += 1
        if engine.scheduler.busy:
            backlog.append((now - t0, len(tickets)))
            with record_function("bench.sched_step"):
                engine.sched_step()
            poll_all()
        elif i < n:
            wait = due[i] - time.perf_counter()
            if wait > 1e-3:
                time.sleep(wait - 5e-4)
    while i < n:                        # due in the window, submitted late
        submit(i, due[i])
        i += 1
    t_drain = time.perf_counter()
    while tickets and time.perf_counter() - t_drain < p["drain_s"]:
        if engine.scheduler.busy:
            engine.sched_step()
        poll_all()
    t_final = time.perf_counter()
    if tracing:
        record.__exit__()
        trace.stop()
    tally["wrong"] += len(tickets)         # never came back
    # a request that was shed or never came back missed every limit: it
    # counts as waiting until the drain ended
    lat_ms = (np.where(np.isnan(done_t), t_final, done_t) - due) * 1e3
    return {"lat_ms": lat_ms, "lag_ms": lag * 1e3, "answers": answers,
            "shed": tally["shed"], "wrong": tally["wrong"],
            "backlog": backlog, "dispatches": record.dispatches,
            "counts": scoring.delta(before, scoring.counters(engine)),
            "drain_s": t_final - t_drain}


def control(run, seed: int) -> dict:
    p = run.params
    ref = run.reference.Model(run.cfg, run.device)
    pool = ref.request_pool(seed, p["pool_rows"]).cpu().numpy()
    a = arrivals(seed, p, run.seconds, pool.shape[0])
    return scoring.control(run, seed, [
        pool[a["start"][j]:a["start"][j] + a["rows"][j]]
        for j in sorted(sample_of(a, p["check_requests"]))])


def run(run) -> dict:
    p, dev = run.params, run.device
    ref, engine, pool = scoring.setup(run)
    a = arrivals(run.seed, p, run.seconds, pool.shape[0])
    n = a["due"].size
    trace = Trace() if run.trace else None
    if trace is not None:
        trace.warm()
    out = drive(engine, pool, a, p, run.seconds,
                sample_of(a, p["check_requests"]), trace, run.window_starts)
    peak = scoring.peak_bytes(dev)
    del engine
    gap, nbytes = scoring.finish(
        run, ref, [(pool[a["start"][j]:a["start"][j] + a["rows"][j]], v)
                   for j, v in sorted(out["answers"].items())],
        out["dispatches"])
    layer = {"counts": out["counts"], "lag_ms": out["lag_ms"],
             "trace": trace, "dispatches": len(out["dispatches"]),
             "lookup_bytes": nbytes,
             "model_flops": run.model.score_flops(
                 run.cfg, sum(r.shape[0] for r, _ in out["dispatches"]))}
    p99 = float(np.percentile(out["lat_ms"], 99)) if n else float("nan")
    return {"e2e": {"serve_p99_ms": p99}, "attempted": n,
            "failed": out["shed"] + out["wrong"],
            "checks": {"score_gap": gap, "unanswered": float(out["wrong"])},
            "peak_bytes": peak, "layer": layer}
