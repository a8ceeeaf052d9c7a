"""The port's spans (``repro_torch.spans``): free and unrecorded with no
profiler running, recorded once each under one (name, parent, and the name
on the profiler's own timeline), the cap that keeps the newest and counts
the dropped; the trees of a serving round and of a training step; and
an open-loop replay on an injected clock that reads it as often, and
dispatches and sheds at the same times, traced or not. The file imports no
JAX."""
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs.dlrm_criteo import make_config
from repro_torch.launch.serve import (build_engine, build_packed_dlrm,
                                      run_open_loop)
from repro_torch.serve import ManualClock, TickClock
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam

ROUND_PHASES = ("serve.gather", "serve.stage", "serve.replay", "serve.wait",
                "serve.readback", "serve.lookup_split", "serve.scatter")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps their small products from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_records():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def model():
    cfg = make_config(reduced=True)
    params, buffers, state, _ = build_packed_dlrm(cfg, device="cpu")
    return cfg, params, state, buffers


def engine_of(model, **kw):
    cfg, params, state, buffers = model
    return build_engine(cfg, params, state, buffers, p99_rows=64,
                        bulk_rows=256, device="cpu", **kw)


def requests(rows, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, (n, 8)).astype(np.int32) for n in rows]


def tiny_trainer():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 1, generator=gen), "b": torch.zeros(1)}

    def loss_fn(p, buffers, state, batch, *, step):
        logits = (batch["x"] @ p["w"] + p["b"])[:, 0]
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, batch["y"])
        return loss, (state, loss)
    batch = {"x": torch.randn(32, 4, generator=gen),
             "y": (torch.rand(32, generator=gen) > 0.5).float()}
    return Trainer(loss_fn, params, {}, {}, adam(1e-2)), batch


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_no_records(model):
    assert spans.span("serve.round") is spans.NO_SPAN
    assert spans.span("train.forward", device="cpu") is spans.NO_SPAN
    engine = engine_of(model)
    for ids in requests((30, 300)):
        engine.submit(ids)
    engine.sched_step()
    trainer, batch = tiny_trainer()
    trainer.train_step(batch, 0)
    recs = spans.records()
    assert len(recs) == 0 and recs.dropped == 0


def test_each_span_recorded_once_under_the_profiler():
    with profiled() as prof:
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with spans.span("other"):
                pass
        with spans.span("top"):
            pass
    recs = spans.records()
    assert [r.name for r in recs] == ["outer", "inner", "other", "top"]
    assert [r.parent for r in recs] == [None, recs[0], recs[0], None]
    for r in recs:
        assert r.start_ns <= r.end_ns and r.ms == r.host_ms >= 0
    assert recs[0].start_ns <= recs[1].start_ns <= recs[2].end_ns \
        <= recs[0].end_ns <= recs[3].start_ns
    names = [e.name for e in prof.events()]
    for name in ("outer", "inner", "other", "top"):
        assert names.count(name) == 1, name
    # the profiler is gone: the no-op again, nothing more recorded
    with spans.span("after"):
        pass
    assert len(spans.records()) == 4


def test_the_cap_drops_and_counts(monkeypatch):
    """Past the cap each span drops the oldest record: memory stays bounded
    across profiler sessions, and the newest stretch is the one kept."""
    monkeypatch.setattr(spans, "CAP", 3)
    spans.clear()
    with profiled():
        with spans.span("a"):
            for i in range(4):
                with spans.span(f"b{i}"):
                    pass
    recs = spans.records()
    assert [r.name for r in recs] == ["b1", "b2", "b3"]
    assert all(r.parent.name == "a" for r in recs)
    assert recs.dropped == 2
    with profiled():
        with spans.span("c"):
            pass
    recs = spans.records()
    assert [r.name for r in recs] == ["b2", "b3", "c"]
    assert recs.dropped == 3
    spans.clear()
    recs = spans.records()
    assert len(recs) == 0 and recs.dropped == 0


def test_serving_round_tree(model):
    engine = engine_of(model)
    rows = (30, 50, 300)       # 380 rows: a 256-row chunk and a 124-row one
    with profiled():
        for ids in requests(rows):
            engine.submit(ids)
        engine.sched_step()
    recs = spans.records()
    rnd = recs[0]        # a submit has no span
    assert rnd.name == "serve.round" and rnd.parent is None
    kids = [r for r in recs if r.parent is rnd]
    # the score lane's take, pack and two chunks, then the tiered lane's
    # take, which finds nothing
    assert [r.name for r in kids] == (["serve.take", "serve.pack"]
                                      + list(ROUND_PHASES) * 2
                                      + ["serve.take"])
    assert all(r.name == "serve.round" or r.parent is not None
               for r in recs)
    # the companion's call and its synchronize, inside the lookup split
    splits = [r for r in recs if r.name == "serve.lookup_split"]
    assert len(splits) == 2
    for split in splits:
        assert [r.name for r in recs if r.parent is split] == \
            ["serve.replay", "serve.wait"]
    for r in recs:
        if r.parent is not None:
            p = r.parent
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_training_step_tree():
    trainer, batch = tiny_trainer()
    trainer.train_step(batch, 0)
    with profiled():
        trainer.train_step(batch, 5)
    recs = spans.records()
    assert recs[0].name == "train.step" and recs[0].parent is None
    assert [r.name for r in recs[1:]] == [
        "train.forward", "train.backward", "train.clip", "train.update"]
    assert all(r.parent is recs[0] for r in recs[1:])
    ends = [r.end_ns for r in recs[1:]]
    starts = [r.start_ns for r in recs[1:]]
    assert all(e <= s for e, s in zip(ends, starts[1:]))
    assert all(r.ms == r.host_ms for r in recs)     # no card: host ms


class Counted:
    """An injected clock that counts its reads."""

    def __init__(self, clock):
        self.clock, self.reads = clock, 0

    def __call__(self):
        self.reads += 1
        return self.clock()


@pytest.mark.parametrize("clock,qps", [("tick", 20000.0), ("manual", 4000.0)])
def test_a_replay_on_an_injected_clock_is_the_same_traced(model, clock, qps):
    """The open loop's every ticket (status, dispatch, completion and its
    milliseconds), the counters and the count of clock reads, with the
    profiler on and off."""
    ids = requests(np.random.default_rng(1).integers(20, 200, 60), seed=2)

    def replay(traced: bool):
        counted = Counted(TickClock(1e-4) if clock == "tick"
                          else ManualClock())
        engine = engine_of(model, clock=counted, queue_capacity=16,
                           coalesce_window_ms=0.5)
        with profiled() if traced else nullcontext():
            out = run_open_loop(engine, lambda i: ids[i], len(ids), qps,
                                seed=3, deadline_ms=0.5)
        tickets = [(t, *(getattr(engine._requests[t], k) for k in (
            "status", "arrival_t", "dispatch_t", "complete_t", "queue_ms",
            "assembly_ms", "compute_ms"))) if t is not None else None
            for t in out["tickets"]]
        counters = engine.counters()
        return (tickets, out["shed"], out["completed"], counters["queue"],
                counters["occupancy"], counted.reads)

    untraced = replay(False)
    assert len(spans.records()) == 0
    traced = replay(True)
    assert len(spans.records()) > 0
    assert traced == untraced
    assert untraced[1] > 0 and untraced[2] > 0     # some shed, some served
