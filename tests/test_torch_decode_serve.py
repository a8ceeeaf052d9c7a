"""Port parity for the LM's decode lanes on the CPU: the port's engine and
the reference's, each on ``TickClock(1e-4)``, serve the same requests from
the same carried weights.

- the continuous-batching lane (``lm_decode_slotted_cell``,
  ``submit_decode``): every ticket's generated tokens equal the
  reference's, with int8 and bf16 caches, dense and MoE models, more
  requests than slots (slots recycled);
- the classic lane (``lm_decode_cell``, ``Engine.decode``): logits within
  1e-5 of the reference's, step after step, caches threaded through; the
  caches returned are the caches passed in (parted by design: the port
  writes them in place);
- waiting jobs shed past their deadline, a failed dispatch failing its
  active jobs and recycling their slots, and the ``max_len`` ValueError,
  each with the reference's counters and statuses.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.lm import LM as JLM
from repro.serve import Engine as JEngine
from repro.serve import lm_decode_cell as jdecode_cell
from repro.serve import lm_decode_slotted_cell as jslotted_cell
from repro.serve.clock import TickClock as JTickClock
from repro.serve.queue import RequestFailedError as JRequestFailedError
from repro_torch.configs.base import get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.serve import (DecodeSession, Engine, lm_decode_cell,
                               lm_decode_slotted_cell)
from repro_torch.serve.clock import TickClock
from repro_torch.serve.queue import RequestFailedError

TICK = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch: str, seed: int = 0):
    jcfg = jget_arch(arch).make_config(reduced=True)
    cfg = get_arch(arch).make_config(reduced=True)
    params, buffers = JLM.init(jax.random.PRNGKey(seed), jcfg)
    tp, _, tb = model_from_numpy(jax.tree.map(np.asarray, params), {},
                                 jax.tree.map(np.asarray, buffers), cfg,
                                 device="cpu")
    return jcfg, cfg, params, buffers, tp, tb


def engines(arch: str, *, batch: int, max_len: int, kv_int8: bool = True,
            slotted: bool = True):
    jcfg, cfg, params, buffers, tp, tb = models(arch)
    je = JEngine(clock=JTickClock(TICK))
    te = Engine(device="cpu", clock=TickClock(TICK))
    if slotted:
        je.register(jslotted_cell(jcfg, params, buffers, batch=batch,
                                  max_len=max_len, kv_int8=kv_int8,
                                  arch=arch))
        te.register(lm_decode_slotted_cell(cfg, tp, tb, batch=batch,
                                           max_len=max_len, kv_int8=kv_int8,
                                           arch=arch))
    else:
        je.register(jdecode_cell(jcfg, params, buffers, batch=batch,
                                 max_len=max_len, kv_int8=kv_int8, arch=arch))
        te.register(lm_decode_cell(cfg, tp, tb, batch=batch, max_len=max_len,
                                   kv_int8=kv_int8, arch=arch))
    return cfg, je, te


def prompts(rng, vocab: int, n: int, lo: int = 2, hi: int = 8):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch,kv_int8", [("internlm2-1.8b", True),
                                          ("internlm2-1.8b", False),
                                          ("qwen3-32b", True),
                                          ("deepseek-moe-16b", True)])
def test_slotted_lane_generates_the_references_tokens(rng, arch, kv_int8):
    cfg, je, te = engines(arch, batch=3, max_len=24, kv_int8=kv_int8)
    reqs = prompts(rng, cfg.vocab, 7)
    max_new = [int(m) for m in rng.integers(2, 7, len(reqs))]
    jt = [je.submit_decode(p, m) for p, m in zip(reqs, max_new)]
    tt = [te.submit_decode(p, m) for p, m in zip(reqs, max_new)]
    je.drain(now=0.0)
    te.drain(now=0.0)
    for a, b, m in zip(jt, tt, max_new):
        got, want = te.poll(b), je.poll(a)
        assert got.dtype == np.int32 and len(got) == m
        np.testing.assert_array_equal(got, want)
    session = te.scheduler.sessions[arch]
    assert isinstance(session, DecodeSession)
    assert sorted(session.free) == [0, 1, 2] and not session.busy
    assert session.steps == je.scheduler.sessions[arch].steps
    assert te.counters()["goodput"] == je.counters()["goodput"]
    assert te.compile_count == 1
    assert len(te.registered_cells()) == 1


@pytest.mark.parametrize("kv_int8", [True, False])
def test_classic_decode_lane_matches_reference(rng, kv_int8):
    cfg, je, te = engines("starcoder2-7b", batch=3, max_len=16,
                          kv_int8=kv_int8, slotted=False)
    jc = tc = None
    for _ in range(5):
        toks = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = je.decode(toks, jc)
        tl, new = te.decode(toks, tc)
        assert tl.shape == (2, cfg.vocab) and tl.dtype == np.float32
        np.testing.assert_allclose(tl, np.asarray(jl, np.float32),
                                   rtol=1e-5, atol=1e-5)
        if tc is not None:   # written in place: the caches passed in
            assert all(new[k] is tc[k] for k in tc if k != "len")
        tc = new
    assert int(tc["len"]) == int(jc["len"]) == 5
    fresh = te.fresh_caches()
    assert sorted(fresh) == sorted(jc) and int(fresh["len"]) == 0
    assert len(te.registered_cells()) == 1


def test_waiting_jobs_past_their_deadline_are_shed(rng):
    cfg, je, te = engines("internlm2-1.8b", batch=2, max_len=32)
    reqs = prompts(rng, cfg.vocab, 6, 4, 8)
    for i, p in enumerate(reqs):
        deadline = 0.5 if i >= 3 else None          # ms: shed while waiting
        je.submit_decode(p, 4, now=0.0, deadline_ms=deadline)
        te.submit_decode(p, 4, now=0.0, deadline_ms=deadline)
    je.drain(now=0.0)
    te.drain(now=0.0)
    assert te.counters()["queue"] == je.counters()["queue"]
    assert te.counters()["goodput"] == je.counters()["goodput"]
    assert te.counters()["queue"]["shed_deadline"] >= 1
    shed = te.request_summary(by="tenant")
    assert shed == je.request_summary(by="tenant")


def test_a_failed_dispatch_fails_its_jobs_and_recycles_their_slots(rng):
    cfg, je, te = engines("internlm2-1.8b", batch=2, max_len=32)
    reqs = prompts(rng, cfg.vocab, 3)
    for engine in (je, te):
        tickets = [engine.submit_decode(p, 3) for p in reqs]
        session = engine.scheduler.sessions["internlm2-1.8b"]
        real = engine._timed_call

        def broken(reg, *request):
            raise RuntimeError("injected fault")

        engine._timed_call = broken
        engine.sched_step(now=0.0)                  # two jobs fail, one waits
        engine._timed_call = real
        engine.drain(now=1.0)
        errors = (RequestFailedError if engine is te else JRequestFailedError)
        for ticket in tickets[:2]:
            with pytest.raises(errors, match="injected fault"):
                engine.poll(ticket)
        assert len(engine.poll(tickets[2])) == 3
        assert sorted(session.free) == [0, 1]
    assert te.counters()["goodput"] == je.counters()["goodput"]
    assert te.counters()["queue"] == je.counters()["queue"]


def test_a_sequence_longer_than_max_len_raises(rng):
    cfg, je, te = engines("internlm2-1.8b", batch=2, max_len=10)
    for engine in (je, te):
        with pytest.raises(ValueError, match="max_len=10"):
            engine.submit_decode(np.arange(8, dtype=np.int32), 3)
        assert engine.submit_decode(np.arange(8, dtype=np.int32), 2) is not None
    # a session admits nothing longer either
    from repro_torch.serve.scheduler import DecodeJob
    session = te.scheduler.sessions["internlm2-1.8b"]
    with pytest.raises(ValueError, match="exceeds"):
        session.admit(DecodeJob(None, np.arange(9), 2))


def test_decode_lanes_need_their_cells():
    engine = Engine(device="cpu")
    with pytest.raises(ValueError, match="no continuous-batching decode cell"):
        engine.submit_decode(np.arange(3), 2)
    with pytest.raises(ValueError, match="no decode cell registered"):
        engine.decode(np.zeros((1, 1), np.int32))
