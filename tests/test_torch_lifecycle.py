"""Port parity for the request lifecycle: the port's and the reference's
engines, each on its own ``TickClock(1e-4)``, driven by the same open-loop
replays (``run_open_loop`` and ``run_open_loop_mix``: same seed, rate,
deadline, capacity, window, quotas and watermark), give every ticket the
same status and the same queue / assembly / compute / latency ms, and the
same counters (completed, shed, failed, occupancy, queue, goodput, cache).
Every chunk the port dispatches equals the port's forward of that padded
block, sliced back, bit for bit, and so does a lone request's result; a
request's logits are within a few float32 ulps of its unbatched forward
(the CPU's BLAS picks its kernel by row count, so a product over other rows
may differ in the last bits) and within rtol = atol = 1e-4 of the
reference's. Also: coalescing, fault isolation, ticket consumption, the
max-wait window."""
import numpy as np
import pytest
import torch

from repro.dist.mesh import host_mesh
from repro.launch import serve as jlaunch
from repro.models.dlrm import DLRM as JDLRM
from repro.serve import CellCache as JCellCache
from repro.serve import Engine as JEngine
from repro.serve import TenantQuota as JTenantQuota
from repro.serve import TickClock as JTickClock
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.interop import model_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.models.dlrm import DLRM
from repro_torch.serve import (CellCache, Engine, ManualClock,
                               RequestFailedError, TenantQuota, TickClock)
from repro_torch.serve.batcher import RequestBatcher
from test_torch_dlrm import make_reference_dlrm

VOCABS = (600, 400, 500)
SHAPES = {"serve_p99": 64, "serve_bulk": 256}
TOL = dict(rtol=1e-4, atol=1e-4)
# the same rows in a block of another row count: at most eight float32 ulps
# of a logit (2**-23 ~ 1.2e-7 relative), and as much at the logits' scale
# (~0.1) for one near zero
ULPS = dict(rtol=1e-6, atol=1e-7)
REQ_FIELDS = ("status", "queue_ms", "assembly_ms", "compute_ms",
              "latency_ms", "arrival_t", "dispatch_t", "complete_t",
              "rows_done", "tenant", "priority")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps their small products from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """A reference packed DLRM and its port, with one warm cell cache for
    each package (engines built on them register by hits)."""
    jcfg, cfg, params, state, buffers = make_reference_dlrm(
        "dnn", seed=3, vocabs=VOCABS)
    port = model_from_numpy(params, state, buffers, cfg, "cpu")
    # the reference engine binds no Python scalars: its launcher serves
    # with the table's meta in the config alone
    buffers = dict(buffers, embedding={})
    return {"jcfg": jcfg, "cfg": cfg, "ref": (params, state, buffers),
            "port": port, "spec": CTRSpec(field_vocabs=VOCABS, seed=3),
            "cache": CellCache("cpu"), "jcache": JCellCache(host_mesh())}


def engines(model, *, fresh=False, quotas=None, **kw):
    """The port's and the reference's engine over the model with the same
    knobs, each on its own ``TickClock(1e-4)``."""
    port = Engine(cache=None if fresh else model["cache"], device="cpu",
                  clock=TickClock(1e-4),
                  quotas={t: TenantQuota(*q) for t, q in
                          (quotas or {}).items()} or None, **kw)
    port.register_packed_model("dlrm", DLRM, model["cfg"], *model["port"],
                               shapes=SHAPES)
    ref = JEngine(cache=None if fresh else model["jcache"],
                  clock=JTickClock(1e-4),
                  quotas={t: JTenantQuota(*q) for t, q in
                          (quotas or {}).items()} or None, **kw)
    ref.register_packed_model("dlrm", JDLRM, model["jcfg"], *model["ref"],
                              shapes=SHAPES)
    return port, ref


def request_ids(model, i, rows=None):
    n = rows if rows is not None else 1 + (i * 37) % 150
    return SyntheticCTR(model["spec"]._replace(batch_size=n)).batch(
        1000 + i)["ids"]


def port_forward(model, ids):
    """The port's eval forward of ``ids`` as one block of ``len(ids)`` rows."""
    params, state, buffers = model["port"]
    with torch.inference_mode():
        return DLRM.apply(params, buffers, state,
                          {"ids": torch.from_numpy(ids)}, model["cfg"])[0].numpy()


def port_padded(model, ids):
    """The port's forward of each chunk the batcher plans for ``ids``,
    zero-padded to its cell's rows and sliced back: what a lone request
    gets from the engine."""
    return np.concatenate([
        RequestBatcher.unpad(port_forward(model, RequestBatcher.pad(
            ids[c.start:c.start + c.n_valid], c.rows)[0]), c.n_valid)
        for c in RequestBatcher(SHAPES).plan(len(ids))])


def record_chunks(engine):
    """Log every score chunk the engine's scheduler scatters back: the
    requests of its spans, the chunk, and the cell's output rows."""
    log, scatter = [], engine.scheduler._scatter

    def recording(ready, chunk, y, *rest):
        log.append(([ready[s.req] for s in chunk.spans], chunk, np.array(y)))
        return scatter(ready, chunk, y, *rest)
    engine.scheduler._scatter = recording
    return log


def check_chunks(model, log, ids_by_req):
    """Each logged chunk's output is the port's forward of its padded block,
    sliced back, bit for bit -> each request's logits as those blocks give
    them, and whether the request rode every chunk alone."""
    want, lone = {}, {}
    for reqs, chunk, y in log:
        rows = np.concatenate([ids_by_req[id(r)][s.src_start:s.src_start + s.n]
                               for r, s in zip(reqs, chunk.spans)])
        block = RequestBatcher.unpad(port_forward(
            model, RequestBatcher.pad(rows, chunk.rows)[0]), chunk.n_valid)
        np.testing.assert_array_equal(
            RequestBatcher.unpad(y, chunk.n_valid), block)
        for r, s in zip(reqs, chunk.spans):
            out = want.setdefault(id(r), np.full(r.n_rows, np.nan, np.float32))
            out[s.src_start:s.src_start + s.n] = \
                block[s.dst_start:s.dst_start + s.n]
            lone[id(r)] = lone.get(id(r), True) and len(chunk.spans) == 1
    return want, lone


def check_tickets(model, port, ref, tickets, jtickets, ids_of, log):
    """Every ticket: the same lifecycle record in both engines; a finished
    request's logits are its chunks' padded forwards bit for bit (a lone
    request's: its own plan's), within ULPS of the port's unbatched
    forward and within TOL of the reference's."""
    assert [t is None for t in tickets] == [t is None for t in jtickets]
    ids_by_req = {id(port._requests[t]): ids_of(i)
                  for i, t in enumerate(tickets) if t is not None}
    want, lone = check_chunks(model, log, ids_by_req)
    done = 0
    for i, (t, jt) in enumerate(zip(tickets, jtickets)):
        if t is None:
            continue
        req, jreq = port._requests[t], ref._requests[jt]
        assert [getattr(req, f) for f in REQ_FIELDS] == \
            [getattr(jreq, f) for f in REQ_FIELDS], i
        if req.status == "done":
            ids = ids_of(i)
            np.testing.assert_array_equal(req.result, want[id(req)])
            if lone[id(req)]:
                np.testing.assert_array_equal(req.result,
                                              port_padded(model, ids))
            np.testing.assert_allclose(req.result, port_forward(model, ids),
                                       **ULPS)
            np.testing.assert_allclose(req.result, jreq.result, **TOL)
            done += 1
    return done


def check_counters(port, ref):
    c, jc = port.counters(), ref.counters()
    assert c == jc
    assert port.request_summary() == ref.request_summary()
    for by in ("lane", "tenant"):
        assert port.request_summary(by=by) == ref.request_summary(by=by)
    assert port.summary() == ref.summary()
    return c


# with a window, seeds whose expiries all round up (the reference's replay
# repeats a held round forever where one rounds down: seeds 0-2, 4-6 at
# 1 ms of this stream)
@pytest.mark.parametrize("case", [
    dict(seed=5, qps=20_000.0, n=60, deadline_ms=2.0, queue_capacity=12),
    dict(seed=3, qps=3_000.0, n=50, deadline_ms=None, queue_capacity=1024,
         coalesce_window_ms=1.0),
    dict(seed=5, qps=50_000.0, n=40, deadline_ms=1.5, queue_capacity=16,
         shed_watermark=0.5),
])
def test_open_loop_replay_equals_reference(model, case):
    case = dict(case)
    seed, qps, n = case.pop("seed"), case.pop("qps"), case.pop("n")
    deadline = case.pop("deadline_ms")
    port, ref = engines(model, fresh=True, **case)
    log = record_chunks(port)
    out = launch.run_open_loop(port, lambda i: request_ids(model, i), n, qps,
                               seed=seed, deadline_ms=deadline)
    jout = jlaunch.run_open_loop(ref, lambda i: request_ids(model, i), n, qps,
                                 seed=seed, deadline_ms=deadline)
    done = check_tickets(model, port, ref, out.pop("tickets"),
                         jout.pop("tickets"), lambda i: request_ids(model, i),
                         log)
    assert out == jout
    assert done == out["completed"] > 0
    c = check_counters(port, ref)
    assert (c["compiles"], c["hits"], c["cells"]) == (4, 0, 4)
    if deadline is not None:
        assert out["shed"] > 0        # the replay reaches the admission policy
    assert port.cache.replays() and sum(port.cache.replays().values()) > 0


def test_open_loop_mix_equals_reference(model):
    """A latency tenant (priority 0, deadline) and a quota-bounded bulk
    tenant (priority 1) behind a watermark and a window."""
    streams = [
        {"tenant": "latency", "qps": 8000.0, "n_requests": 30, "priority": 0,
         "deadline_ms": 2.5, "batch": 30},
        {"tenant": "bulk", "qps": 6000.0, "n_requests": 25, "priority": 1,
         "batch": 120},
    ]
    kw = dict(queue_capacity=20, shed_watermark=0.75, coalesce_window_ms=0.5,
              quotas={"bulk": (None, 300)})
    port, ref = engines(model, **kw)

    def make(i, batch):
        return request_ids(model, i, batch)
    out = launch.run_open_loop_mix(port, make, streams, seed=2)
    jout = jlaunch.run_open_loop_mix(ref, make, streams, seed=2)
    assert out == jout
    assert out["per_stream"]["latency"]["completed"] > 0
    assert out["per_stream"]["bulk"]["completed"] > 0
    tickets = sorted(port._requests)
    assert tickets == sorted(ref._requests)
    for t in tickets:
        req, jreq = port._requests[t], ref._requests[t]
        assert [getattr(req, f) for f in REQ_FIELDS] == \
            [getattr(jreq, f) for f in REQ_FIELDS]
        if req.status == "done":
            np.testing.assert_allclose(req.result, jreq.result, **TOL)
    c = check_counters(port, ref)
    assert set(c["goodput"]["by_lane"]) == {"score:p0", "score:p1"}


def test_coalescing_fewer_dispatches_higher_occupancy(model):
    reqs = [request_ids(model, i, 20) for i in range(8)]
    solo, _ = engines(model)
    per_request = [solo.score(r, return_logits=True) for r in reqs]
    co, jco = engines(model)
    compiles = co.compile_count
    tickets = [co.submit(r) for r in reqs]
    jtickets = [jco.submit(r) for r in reqs]
    co.drain()
    jco.drain()
    # one 256-row cell holds the eight: its padded forward, sliced per span
    block = port_padded(model, np.concatenate(reqs))
    for k, (r, t, jt, want) in enumerate(zip(reqs, tickets, jtickets,
                                             per_request)):
        got = co.poll(t)
        np.testing.assert_array_equal(got, block[20 * k:20 * (k + 1)])
        np.testing.assert_array_equal(want, port_padded(model, r))
        np.testing.assert_allclose(got, want, **ULPS)
        np.testing.assert_allclose(got, port_forward(model, r), **ULPS)
        np.testing.assert_allclose(got, jco.poll(jt), **TOL)

    def dispatches(engine):
        return sum(s["count"] for s in engine.summary().values())

    def total(engine):
        occ = engine.counters()["occupancy"].values()
        return (sum(v["valid_rows"] for v in occ),
                sum(v["padded_rows"] for v in occ))
    assert dispatches(co) == dispatches(jco) == 1 < dispatches(solo) == 8
    assert total(co)[0] == total(solo)[0] == 160
    assert total(co)[1] < total(solo)[1]
    assert co.counters()["occupancy"] == jco.counters()["occupancy"]
    assert co.compile_count == compiles        # the twins hit warm cells


def test_fault_fails_only_its_chunk(model):
    a, b = request_ids(model, 1, 256), request_ids(model, 2, 64)
    want_b = port_forward(model, b)
    port, ref = engines(model)
    for engine in (port, ref):
        orig = engine._timed_call
        calls = {"n": 0}

        def flaky(reg, *request, orig=orig, calls=calls):
            calls["n"] += 1
            if calls["n"] == 1:           # the first chunk's compute call
                raise RuntimeError("injected fault")
            return orig(reg, *request)
        engine._timed_call = flaky
        ta, tb = engine.submit(a), engine.submit(b)
        engine.drain()
        engine._timed_call = orig
        with pytest.raises(RuntimeError, match="injected fault") as err:
            engine.poll(ta)
        assert type(err.value).__name__ == RequestFailedError.__name__
        np.testing.assert_allclose(engine.poll(tb), want_b, **TOL)
        assert engine.rstats.failed == 1
        assert len(engine.queue) == 0 and not engine.scheduler.busy
        assert engine.queue.counters()["inflight_rows"] == {}
        np.testing.assert_allclose(engine.score(b, return_logits=True),
                                   want_b, **TOL)
    assert port.counters() == ref.counters()


def test_poll_and_try_poll_consume_tickets(model):
    port, _ = engines(model)
    ids = request_ids(model, 7, 5)
    t = port.submit(ids)
    assert port.poll(t) is None and port.try_poll(t) == {"status": "pending"}
    port.drain()
    got = port.poll(t)
    np.testing.assert_array_equal(got, port_padded(model, ids))
    np.testing.assert_allclose(got, port_forward(model, ids), **ULPS)
    with pytest.raises(KeyError):
        port.poll(t)
    assert port.try_poll(t) == {"status": "unknown"}
    t2 = port.submit(ids)
    port.drain()
    out = port.try_poll(t2)
    assert out["status"] == "done"
    np.testing.assert_array_equal(out["result"], port_padded(model, ids))
    np.testing.assert_allclose(out["result"], port_forward(model, ids),
                               **ULPS)
    assert port.try_poll(t2) == {"status": "unknown"}
    # a deadline shed, polled both ways
    t3 = port.submit(ids, now=0.0, deadline_ms=50.0)
    t4 = port.submit(ids, now=0.0, deadline_ms=50.0)
    port.sched_step(now=1.0)
    with pytest.raises(RuntimeError, match="shed"):
        port.poll(t3)
    assert port.try_poll(t4) == {"status": "shed"}
    assert port.counters()["queue"]["shed_deadline"] == 2


def test_window_holds_then_releases(model):
    """Exact virtual times under ``ManualClock``, as the reference's."""
    for engine_cls, clock in ((Engine, ManualClock()),):
        engine = engine_cls(cache=model["cache"], coalesce_window_ms=100.0,
                            clock=clock)
        engine.register_packed_model("dlrm", DLRM, model["cfg"],
                                     *model["port"], shapes=SHAPES)
        t1 = engine.submit(request_ids(model, 1, 5), now=0.0)   # < 64 rows
        engine.sched_step(now=0.01)
        assert engine._requests[t1].status == "queued"          # held
        t2 = engine.submit(request_ids(model, 2, 60), now=0.02)  # 65 rows
        engine.sched_step(now=0.03)
        assert engine._requests[t1].dispatch_t == 0.03          # released
        assert engine._requests[t2].dispatch_t == 0.03
        engine.drain(now=0.03)
        assert engine.poll(t1) is not None and engine.poll(t2) is not None
        # a lone light request dispatches exactly at arrival + window
        t3 = engine.submit(request_ids(model, 3, 5), now=1.0)
        cursor = engine.drain(now=1.0)
        assert engine._requests[t3].dispatch_t == pytest.approx(1.1)
        assert cursor >= 1.1
        # an arrival whose expiry rounds below the window still dispatches
        # (the reference's scheduler repeats this round forever)
        t4 = engine.submit(request_ids(model, 4, 5), now=0.0013006294340008305)
        engine.drain(now=0.0013006294340008305)
        assert engine.poll(t4) is not None


def test_unported_lanes_raise_naming_their_item(model):
    port, ref = engines(model)
    ids = request_ids(model, 1, 4)
    with pytest.raises(ValueError, match="unroutable"):
        port.submit(ids, kind="retrieve")
    # the decode lane is ported: with no slotted decode cell registered it
    # raises as the reference's engine does
    for engine in (port, ref):
        with pytest.raises(ValueError, match="no continuous-batching decode"):
            engine.submit_decode(ids[0], 2)
    # the retrieve lane is ported: with no retrieval cell registered it
    # raises as the reference's engine does
    with pytest.raises(ValueError, match="no retrieval cell registered"):
        port.retrieve(ids[:1], ids)
    # the mesh is ported: one process cannot hold a 2x2 mesh of ranks
    with pytest.raises(SystemExit, match="needs 4 ranks, 1 running"):
        launch.main(["--reduced", "--device", "cpu", "--mesh", "2,2"])


def test_serve_cli_open_loop_and_repack_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    engine = launch.main(["--reduced", "--device", "cpu", "--requests", "30",
                          "--batch", "40", "--p99-rows", "64",
                          "--bulk-rows", "256", "--qps", "3000",
                          "--deadline-ms", "5", "--coalesce-window-ms", "1",
                          "--queue-capacity", "64", "--repack-budget", "0.8",
                          "--repack-headroom", "0.5", "--json", str(out)])
    text = capsys.readouterr().out
    assert "open loop" in text and "repack" in text
    c = engine.counters()
    assert c["compiles"] == 4 and engine.swaps_applied == 1
    assert c["queue"]["admitted"] == 31            # + the warm request
    assert out.exists()
