"""Black-box serving harness: the engine behind a real process boundary.

The port of the reference's ``repro.launch.server``, in the same framing,
so a client of either package talks to a server of either: a small TCP
server wrapping ``Engine.submit``/``poll`` so the request lifecycle is
exercised end-to-end — serialization, framing, concurrent clients, and the
multi-tenant admission policy — with latency measured over the wire. One
frame is 4 bytes of big-endian length followed by that many bytes of UTF-8
JSON; one connection carries any number of request/response frame pairs.

Operations (the ``op`` field of a request frame):

  ``ping``             → ``{"ok": true}`` — the readiness probe.
  ``submit``           ``{ids, kind?, deadline_ms?, tenant?, priority?}``
                       → ``{"ticket": int | null}`` (null = shed at
                       admission).
  ``poll``             ``{ticket}`` → ``{"status": "pending" | "done" |
                       "shed" | "failed" | "unknown", result?, error?}`` —
                       terminal polls consume the ticket.
  ``counters``         → ``engine.counters()`` (cache, occupancy, queue,
                       per-lane/per-tenant goodput).
  ``request_summary``  ``{by?}`` → ``engine.request_summary(by=...)``.
  ``shutdown``         → ``{"ok": true}``, then the server exits.

A background *pump* thread runs ``engine.sched_step`` whenever the
scheduler has work, so submits from one client coalesce with submits from
every other client onto shared padded cells. All engine access
(submit/poll/step) serializes through one lock; the socket layer is the
concurrent part. On the card the pump thread replays the cells' CUDA
graphs, all captured at registration, before the server starts.

The CLI trains a small packed DLRM (the recipe of ``repro_torch.launch.
serve``) on the card unless ``--device`` names another, registers the serve
cells, warms them, then prints ``READY host:port`` on stdout.

    python -m repro_torch.launch.server --port 0 --train-steps 25
    python -m repro_torch.launch.server --port 0 --device cpu
"""
from __future__ import annotations

import argparse
import json
import socket
import struct
import threading
import time

import numpy as np

_HEADER = struct.Struct(">I")
MAX_FRAME_BYTES = 64 << 20     # refuse absurd frames instead of OOMing


def send_frame(sock: socket.socket, obj) -> None:
    """Write one length-prefixed JSON frame."""
    data = json.dumps(obj).encode("utf-8")
    if len(data) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(data)} bytes exceeds "
                         f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_HEADER.pack(len(data)) + data)


def recv_frame(sock: socket.socket):
    """Read one frame -> decoded object, or None on clean EOF (the peer
    closed between frames). EOF mid-frame raises ConnectionError."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"peer announced a {length}-byte frame (max "
                         f"{MAX_FRAME_BYTES})")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ConnectionError("connection closed mid-frame")
    return json.loads(payload.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None if not buf else _raise_eof()
        buf.extend(part)
    return bytes(buf)


def _raise_eof():
    raise ConnectionError("connection closed mid-frame")


class EngineServer:
    """Serve one engine over TCP with length-prefixed JSON framing.

    ``port=0`` binds an ephemeral port (read it back from ``.port``). Every
    client connection gets a handler thread; one pump thread drives
    ``sched_step`` while the scheduler is busy, so concurrent clients'
    requests coalesce onto shared cells."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)   # so the accept loop sees _stop
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: list[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Run the accept loop and the scheduler pump in daemon threads."""
        for target, name in ((self._accept_loop, "accept"),
                             (self._pump, "pump")):
            t = threading.Thread(target=target, name=f"engine-server-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def serve_forever(self):
        self.start()
        while not self._stop.is_set():
            self._stop.wait(0.2)

    def shutdown(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # -- threads ------------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return      # listener closed during shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="engine-server-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _pump(self):
        """Drive the scheduler whenever it has work. Idle polling stays
        cheap (a short wait), and every step holds the engine lock so
        submits/polls from handler threads interleave safely between
        rounds."""
        while not self._stop.is_set():
            with self._lock:
                busy = self.engine.scheduler.busy
                if busy:
                    self.engine.sched_step()
            if not busy:
                self._stop.wait(0.002)

    def _serve_conn(self, conn: socket.socket):
        with conn:
            while not self._stop.is_set():
                try:
                    msg = recv_frame(conn)
                except (ConnectionError, ValueError, json.JSONDecodeError):
                    return
                if msg is None:
                    return
                try:
                    reply = self._handle(msg)
                except Exception as err:   # protocol errors ride back as JSON
                    reply = {"error": f"{type(err).__name__}: {err}"}
                try:
                    send_frame(conn, reply)
                except OSError:
                    return

    # -- request handling ---------------------------------------------------

    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "submit":
            ids = np.asarray(msg["ids"], np.int32)
            with self._lock:
                ticket = self.engine.submit(
                    ids, kind=msg.get("kind", "score"),
                    deadline_ms=msg.get("deadline_ms"),
                    tenant=msg.get("tenant", "default"),
                    priority=int(msg.get("priority", 0)))
            return {"ticket": ticket}
        if op == "poll":
            with self._lock:
                out = self.engine.try_poll(int(msg["ticket"]))
            if out["status"] == "done":
                out = dict(out, result=np.asarray(out["result"]).tolist())
            return out
        if op == "counters":
            with self._lock:
                return self.engine.counters()
        if op == "request_summary":
            with self._lock:
                return self.engine.request_summary(by=msg.get("by", "kind"))
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}
        return {"error": f"unknown op {op!r}"}


class EngineClient:
    """Blocking client for ``EngineServer``'s framed-JSON protocol.

    One instance = one connection; safe from one thread at a time (tests
    spawn one client per concurrent worker). ``score`` is the end-to-end
    convenience: submit, poll until terminal, return the result array —
    raising on shed/failed, so over-the-wire latency includes framing and
    serialization on both legs."""

    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def call(self, op: str, **fields) -> dict:
        send_frame(self._sock, {"op": op, **fields})
        reply = recv_frame(self._sock)
        if reply is None:
            raise ConnectionError("server closed the connection")
        return reply

    def ping(self) -> bool:
        return self.call("ping").get("ok", False)

    def submit(self, ids, *, kind: str = "score",
               deadline_ms: float | None = None, tenant: str = "default",
               priority: int = 0) -> int | None:
        reply = self.call("submit", ids=np.asarray(ids).tolist(), kind=kind,
                          deadline_ms=deadline_ms, tenant=tenant,
                          priority=priority)
        if "error" in reply:
            raise RuntimeError(reply["error"])
        return reply["ticket"]

    def poll(self, ticket: int) -> dict:
        return self.call("poll", ticket=ticket)

    def score(self, ids, *, poll_interval_s: float = 0.005,
              timeout_s: float = 60.0, **submit_kw) -> np.ndarray:
        ticket = self.submit(ids, **submit_kw)
        if ticket is None:
            raise RuntimeError("request shed at admission")
        deadline = time.monotonic() + timeout_s
        while True:
            out = self.poll(ticket)
            status = out.get("status")
            if status == "done":
                return np.asarray(out["result"], np.float32)
            if status == "shed":
                raise RuntimeError(f"request {ticket} shed")
            if status == "failed":
                raise RuntimeError(
                    f"request {ticket} failed: {out.get('error')}")
            if status not in ("pending",):
                raise RuntimeError(f"request {ticket}: {out}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"request {ticket} still pending after "
                                   f"{timeout_s}s")
            time.sleep(poll_interval_s)

    def counters(self) -> dict:
        return self.call("counters")

    def request_summary(self, *, by: str = "kind") -> dict:
        return self.call("request_summary", by=by)

    def shutdown(self):
        self.call("shutdown")


def main(argv=None):
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import build_engine, train_packed_dlrm
    from repro_torch.serve import TenantQuota

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on READY)")
    ap.add_argument("--train-steps", type=int, default=25)
    ap.add_argument("--p99-rows", type=int, default=64)
    ap.add_argument("--bulk-rows", type=int, default=256)
    ap.add_argument("--queue-capacity", type=int, default=1024)
    ap.add_argument("--coalesce-window-ms", type=float, default=0.0)
    ap.add_argument("--shed-watermark", type=float, default=1.0)
    ap.add_argument("--quota", action="append", default=[],
                    help="tenant quota as name=max_queued[:max_inflight_rows]"
                         " (repeatable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    quotas = {}
    for spec in args.quota:
        name, _, bound = spec.partition("=")
        queued, _, rows = bound.partition(":")
        quotas[name] = TenantQuota(
            max_queued=int(queued) if queued else None,
            max_inflight_rows=int(rows) if rows else None)

    print(f"[server] training packed DLRM ({args.train_steps} steps) on "
          f"{device}", flush=True)
    cfg, params, state, buffers, spec, _res = train_packed_dlrm(
        field_vocabs=(600, 400, 500), train_steps=args.train_steps,
        train_batch=256, seed=3, device=device)
    engine = build_engine(cfg, params, state, buffers,
                          p99_rows=args.p99_rows, bulk_rows=args.bulk_rows,
                          device=device, queue_capacity=args.queue_capacity,
                          quotas=quotas or None,
                          shed_watermark=args.shed_watermark,
                          coalesce_window_ms=args.coalesce_window_ms)
    # one request through every score cell before the first client's
    n_fields = len(cfg.fields)
    for rows in sorted(set(engine.registered_shapes.values())):
        engine.score(np.zeros((rows, n_fields), np.int32))
    server = EngineServer(engine, host=args.host, port=args.port)
    print(f"READY {server.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
