"""Port parity for the admission queue, the clocks and the per-request
stats: the same random submit/take/complete streams through the port's
and the reference's ``AdmissionQueue`` give identical traces (every
dispatched batch, every status, every counter), under seeded numpy sweeps
and under hypothesis; both clocks read the same sequences; ``RequestStats``
summarizes the same records into equal summaries."""
import math

import numpy as np
import pytest

import lifecycle_props as props
from repro.serve import clock as jclock
from repro.serve import queue as jqueue
from repro.serve.stats import RequestStats as JRequestStats
from repro_torch.serve import clock, queue
from repro_torch.serve.stats import RequestStats

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:   # hypothesis is a dev dependency
    given = None


def drive(specs, cfg, module, monkeypatch):
    """``lifecycle_props.drive_queue`` over ``module``'s queue."""
    monkeypatch.setattr(props, "AdmissionQueue", module.AdmissionQueue)
    return props.drive_queue(specs, cfg)


def trace(result) -> dict:
    """Everything a drive observed, as plain values."""
    fields = ("ticket", "kind", "payload", "n_rows", "arrival_t",
              "deadline_t", "status", "complete_t", "tenant", "priority")
    return {"batches": [(kind, [r.ticket for r in batch])
                        for kind, batch in result["batches"]],
            "admitted": [tuple(getattr(r, f) for f in fields)
                         for r in result["admitted"]],
            "shed_at_submit": result["shed_at_submit"],
            "peak_inflight": result["peak_inflight"],
            "counters": result["queue"].counters(),
            "depth": len(result["queue"])}


def port_quotas(cfg):
    """The same quotas as the port's ``TenantQuota``s."""
    quotas = {t: queue.TenantQuota(*q) for t, q in (cfg["quotas"] or {}).items()}
    return dict(cfg, quotas=quotas or None)


@pytest.mark.parametrize("seed", range(12))
def test_random_streams_trace_like_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    specs = props.random_stream(rng, int(rng.integers(10, 80)))
    cfg = props.random_config(rng)
    with monkeypatch.context() as m:
        want = trace(drive(specs, cfg, jqueue, m))
    with monkeypatch.context() as m:
        got = drive(specs, port_quotas(cfg), queue, m)
    props.check_no_drop_no_dup(got)
    props.check_edf_order(got)
    props.check_quota_ceilings(got, cfg.get("quotas"))
    props.check_counters_consistent(got)
    assert trace(got) == want


@pytest.mark.parametrize("seed", range(4))
def test_window_hold_and_release_like_reference(seed):
    """``take(min_rows=, max_wait_s=)``: the same holds, releases and
    deadline sheds at the same virtual times."""
    rng = np.random.default_rng(100 + seed)
    qs = [m.AdmissionQueue(capacity=32) for m in (queue, jqueue)]
    now, out = 0.0, [[], []]
    for _ in range(60):
        now += float(rng.random() * 0.02)
        n = int(rng.integers(1, 30))
        deadline = None if rng.random() < 0.6 else float(rng.integers(5, 60))
        for q, o in zip(qs, out):
            r = q.submit("score", None, n, now=now, deadline_ms=deadline)
            o.append(None if r is None else r.ticket)
        if rng.random() < 0.5:
            for q, o in zip(qs, out):
                ready, expired = q.take("score", now=now, min_rows=64,
                                        max_wait_s=0.03)
                o.append(([r.ticket for r in ready],
                          [(r.ticket, r.status, r.complete_t)
                           for r in expired]))
                for r in ready:
                    q.release(r)
    assert out[0] == out[1]
    assert qs[0].counters() == qs[1].counters()
    assert qs[0].pending_rows("score") == qs[1].pending_rows("score")
    assert qs[0].oldest_arrival("score") == qs[1].oldest_arrival("score")


def test_quota_and_validation_errors_like_reference():
    for m in (queue, jqueue):
        q = m.AdmissionQueue(capacity=4,
                             quotas={"a": m.TenantQuota(max_inflight_rows=10)})
        with pytest.raises(ValueError, match="max_inflight_rows"):
            q.submit("score", 0, 11, now=0.0, tenant="a")
        with pytest.raises(ValueError, match="priority"):
            q.submit("score", 0, 1, now=0.0, priority=-1)
        with pytest.raises(ValueError):
            m.AdmissionQueue(capacity=0)
        with pytest.raises(ValueError):
            m.AdmissionQueue(capacity=4, shed_watermark=0.0)
    assert (queue.QUEUED, queue.DISPATCHED, queue.DONE, queue.SHED,
            queue.FAILED) == (jqueue.QUEUED, jqueue.DISPATCHED, jqueue.DONE,
                              jqueue.SHED, jqueue.FAILED)
    assert issubclass(queue.RequestFailedError, RuntimeError)


def test_note_shed_and_request_fields_like_reference():
    reqs = []
    for m in (queue, jqueue):
        q = m.AdmissionQueue(capacity=4)
        r = q.submit("score", "x", 3, now=1.0, deadline_ms=20.0,
                     tenant="t", priority=2)
        ready, _ = q.take("score", now=1.001)
        q.note_shed(ready[0], now=1.5)
        reqs.append((r.lane, r.latency_ms, r.status, r.payload,
                     q.counters()))
    assert reqs[0] == reqs[1]


@pytest.mark.parametrize("dt", [1e-4, 3e-3, 0.5])
def test_clocks_read_like_reference(dt):
    tick, jtick = clock.TickClock(dt, start=2.0), jclock.TickClock(dt,
                                                                  start=2.0)
    assert [tick() for _ in range(1000)] == [jtick() for _ in range(1000)]
    man, jman = clock.ManualClock(1.0), jclock.ManualClock(1.0)
    for step in (0.0, dt, 7 * dt, 0.25):
        assert man.advance(step) == jman.advance(step)
        assert man() == jman()
    assert man.set(9.0) == jman.set(9.0)
    for m in (man, jman):
        with pytest.raises(ValueError):
            m.advance(-1.0)
        with pytest.raises(ValueError):
            m.set(0.0)
    with pytest.raises(ValueError):
        clock.TickClock(0.0)


@pytest.mark.parametrize("seed", range(3))
def test_request_stats_summaries_like_reference(seed):
    rng = np.random.default_rng(seed)
    stats, jstats = RequestStats(), JRequestStats()
    for _ in range(int(rng.integers(5, 60))):
        kind = str(rng.choice(["score", "tiered"]))
        tenant = str(rng.choice(["a", "b", "default"]))
        what = rng.random()
        for s in (stats, jstats):
            if what < 0.15:
                s.record_shed(kind, tenant=tenant)
            elif what < 0.25:
                s.record_failed(kind, tenant=tenant)
            else:
                s.record(kind, queue_ms=float(what * 3),
                         assembly_ms=float(what / 7), compute_ms=1.0 + what,
                         latency_ms=5.0 * what, tenant=tenant,
                         priority=int(what * 10) % 3)
    for skip in (0, 3):
        assert stats.summary(skip_warmup=skip) == \
            jstats.summary(skip_warmup=skip)
        assert stats.lane_summary(skip_warmup=skip) == \
            jstats.lane_summary(skip_warmup=skip)
        assert stats.tenant_summary(skip_warmup=skip) == \
            jstats.tenant_summary(skip_warmup=skip)
        for by in ("kind", "lane", "tenant"):
            assert stats.format_table(skip_warmup=skip, by=by) == \
                jstats.format_table(skip_warmup=skip, by=by)
    assert stats.lane_counts() == jstats.lane_counts()
    assert stats.tenant_counts() == jstats.tenant_counts()
    assert (stats.shed, stats.failed, stats.kinds()) == \
        (jstats.shed, jstats.failed, jstats.kinds())


def _hypothesis_case(specs, cfg, monkeypatch):
    cfg = dict(cfg, quotas={t: tuple(q) for t, q in
                            (cfg["quotas"] or {}).items()} or None)
    ref_cfg = dict(cfg, quotas={t: jqueue.TenantQuota(*q) for t, q in
                                (cfg["quotas"] or {}).items()} or None)
    with monkeypatch.context() as m:
        want = trace(drive(specs, ref_cfg, jqueue, m))
    with monkeypatch.context() as m:
        got = drive(specs, port_quotas(cfg), queue, m)
    props.check_edf_order(got)
    props.check_counters_consistent(got)
    assert trace(got) == want


if given is not None:
    spec_st = st.fixed_dictionaries({
        "kind": st.sampled_from(list(props.KINDS)),
        "n_rows": st.integers(1, 40),
        "tenant": st.sampled_from(["a", "b", "c"]),
        "priority": st.integers(0, 3),
        "deadline_ms": st.one_of(st.none(), st.floats(1.0, 500.0)),
        "dt": st.floats(0.0, 0.05),
    })
    quota_st = st.tuples(st.one_of(st.none(), st.integers(1, 6)),
                         st.one_of(st.none(), st.integers(40, 200)))
    cfg_st = st.fixed_dictionaries({
        "capacity": st.integers(4, 32),
        "quotas": st.one_of(st.none(), st.dictionaries(
            st.sampled_from(["a", "b"]), quota_st, max_size=2)),
        "shed_watermark": st.sampled_from([1.0, 0.75, 0.5]),
        "take_every": st.integers(1, 5),
        "complete_frac": st.floats(0.0, 1.0),
    })

    @settings(max_examples=40, deadline=None)
    @given(specs=st.lists(spec_st, min_size=1, max_size=60), cfg=cfg_st)
    def test_streams_trace_like_reference_hypothesis(specs, cfg):
        with pytest.MonkeyPatch.context() as m:
            _hypothesis_case(specs, cfg, m)
else:
    def test_streams_trace_like_reference_hypothesis():
        pytest.skip("hypothesis is not installed")


def test_fifo_identity_degenerate_stream(monkeypatch):
    """One tenant, priority 0, no deadlines: the port's queue drains in
    the single-lane FIFO order, as the reference's does."""
    monkeypatch.setattr(props, "AdmissionQueue", queue.AdmissionQueue)
    rng = np.random.default_rng(7)
    for _ in range(4):
        props.check_fifo_identity(
            [int(n) for n in rng.integers(1, 100, size=rng.integers(1, 30))])
    assert math.isinf(queue.AdmissionQueue._edf_key(
        queue.Request(0, "score", None, 1, 0.0, None))[1])
