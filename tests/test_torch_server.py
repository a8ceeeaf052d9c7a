"""The port's socket server: ``EngineServer`` over the port's engine on the
CPU, in this process. The framing is the reference's, so the reference's
``EngineClient`` talks to it and gets the port's scores; concurrent clients
coalesce onto shared cells; tickets, quotas and counters ride the wire."""
import socket
import threading

import numpy as np
import pytest
import torch

from repro.launch import server as jserver
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.interop import model_from_numpy
from repro_torch.launch import server
from repro_torch.launch.serve import build_engine
from repro_torch.models.dlrm import DLRM
from repro_torch.serve import Engine, TenantQuota
from test_torch_dlrm import make_reference_dlrm

VOCABS = (600, 400, 500)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    jcfg, cfg, params, state, buffers = make_reference_dlrm(
        "dnn", seed=3, vocabs=VOCABS)
    model = model_from_numpy(params, state, buffers, cfg, "cpu")
    engine = build_engine(cfg, *model, p99_rows=64, bulk_rows=256,
                          device="cpu",
                          quotas={"capped": TenantQuota(max_queued=1)})
    # the same cells, called in this thread: what the wire must return
    twin = Engine(cache=engine.cache)
    twin.register_packed_model("dlrm", DLRM, cfg, *model,
                               shapes={"serve_p99": 64, "serve_bulk": 256})
    srv = server.EngineServer(engine).start()
    yield {"server": srv, "engine": engine, "twin": twin, "cfg": cfg,
           "spec": CTRSpec(field_vocabs=VOCABS, seed=3)}
    srv.shutdown()
    for t in srv._threads[:2]:              # the accept loop and the pump
        t.join(timeout=10)
        assert not t.is_alive()


def ids_of(served, rows, step):
    return SyntheticCTR(served["spec"]._replace(batch_size=rows)).batch(
        step)["ids"]


def direct(served, ids):
    """The port's logits for ``ids`` from the same cells, in process."""
    return served["twin"].score(ids, return_logits=True)


@pytest.mark.parametrize("client", [server.EngineClient, jserver.EngineClient])
def test_ping_and_unknown_op(served, client):
    srv = served["server"]
    with client(srv.host, srv.port) as c:
        assert c.ping()
        assert "unknown op" in c.call("nope")["error"]


@pytest.mark.parametrize("client", [server.EngineClient, jserver.EngineClient])
@pytest.mark.parametrize("rows", [1, 50, 300])
def test_score_round_trip_equals_the_port(served, client, rows):
    """The reference's client gets the port's scores bit for bit: float32
    logits survive the JSON round trip exactly."""
    srv = served["server"]
    ids = ids_of(served, rows, 100 + rows)
    with client(srv.host, srv.port) as c:
        got = c.score(ids)
    assert got.dtype == np.float32 and got.shape == (rows,)
    np.testing.assert_array_equal(got, direct(served, ids))


def test_concurrent_clients_coalesce(served):
    srv, engine = served["server"], served["engine"]
    reqs = [ids_of(served, 20, 500 + i) for i in range(12)]
    out, errors = [None] * len(reqs), []

    def work(k):
        try:
            client = (server.EngineClient, jserver.EngineClient)[k % 2]
            with client(srv.host, srv.port) as c:
                for i in range(k, len(reqs), 4):
                    out[i] = c.score(reqs[i])
        except Exception as err:   # surfaced by the assert below
            errors.append(err)
    before = sum(s["count"] for s in engine.summary().values())
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    for ids, got in zip(reqs, out):
        np.testing.assert_array_equal(got, direct(served, ids))
    with server.EngineClient(srv.host, srv.port) as c:
        counters = c.counters()
    dispatches = sum(s["count"] for s in engine.summary().values()) - before
    assert 0 < dispatches <= len(reqs)
    assert counters["compiles"] == 4
    assert counters["goodput"]["by_lane"]["score:p0"] >= len(reqs)


def test_tickets_quotas_and_summaries_over_the_wire(served):
    srv = served["server"]
    ids = ids_of(served, 5, 9)
    with jserver.EngineClient(srv.host, srv.port) as c:
        assert c.poll(10**9) == {"status": "unknown"}
        t = c.submit(ids)
        while (reply := c.poll(t))["status"] == "pending":
            pass
        assert reply["status"] == "done"
        assert c.poll(t) == {"status": "unknown"}       # consumed
        summary = c.request_summary(by="tenant")
        assert "default" in summary
    with srv._lock:                  # hold the pump: the queue keeps one
        a = srv.engine.submit(ids, tenant="capped")
        assert srv.engine.submit(ids, tenant="capped") is None
    assert a is not None
    with server.EngineClient(srv.host, srv.port) as c:
        q = c.counters()["queue"]
    assert q["per_tenant"]["capped"]["shed_quota"] == 1


def test_frames_interoperate():
    a, b = socket.socketpair()
    with a, b:
        payload = {"op": "submit", "ids": [[1, 2, 3]], "tenant": "t"}
        server.send_frame(a, payload)
        assert jserver.recv_frame(b) == payload
        jserver.send_frame(b, {"ticket": 7})
        assert server.recv_frame(a) == {"ticket": 7}
        a.close()
        assert server.recv_frame(b) is None             # clean EOF
    assert server.MAX_FRAME_BYTES == jserver.MAX_FRAME_BYTES
