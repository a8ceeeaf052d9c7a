"""Prefetch in the port, on the CPU:

- ``data.loader.Prefetcher`` yields ``(step, batch_fn(step))`` in order
  from its start step, holds at most ``depth`` batches, and ``close()``
  joins its thread;
- ``cache.PrefetchPipeline`` stages ``depth`` steps ahead, serves each step
  once made, and restarts after a jump (as the reference's test in
  ``tests/test_cache.py``), with batches equal to ``data_fn``'s; with a
  tiered store it stages each step's cold fill in step order and keeps at
  most ``depth + 1`` of them; with no device named it stages on the card,
  or raises where there is none;
- ``Trainer.run`` refuses a pre-built pipeline that stages on another
  device than the trainer's;
- ``Trainer.run(prefetch=True)`` (and a pre-built pipeline of depth 3)
  gives losses and final parameters bit-identical to the synchronous loop,
  and within rtol 1e-4 of the reference's prefetched run.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.dlrm import DLRM as JDLRM
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.cache.prefetch import PrefetchPipeline
from repro_torch.data.loader import Prefetcher
from repro_torch.models.dlrm import DLRM
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves
from test_torch_train import carried, reference_model

LAM = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_prefetcher_yields_steps_in_order_and_closes():
    made = []

    def batch_fn(step):
        made.append(step)
        return {"x": np.full((3,), step, np.int32)}

    pf = Prefetcher(batch_fn, start_step=5, depth=2)
    for want in range(5, 12):
        step, batch = next(pf)
        assert step == want and (batch["x"] == want).all()
    time.sleep(0.2)
    assert max(made) <= 11 + 2 + 1      # at most depth batches wait, one in hand
    pf.close()
    assert not pf._thread.is_alive()
    assert made == list(range(5, 5 + len(made)))


def test_pipeline_stages_ahead_and_restarts():
    seen, lock = [], threading.Lock()

    def data_fn(step):
        with lock:
            seen.append(step)
        return {"x": np.full((2,), step, np.int32)}

    pipe = PrefetchPipeline(data_fn, depth=2, device="cpu")
    try:
        b0 = pipe(0)
        assert b0["x"].dtype == torch.int32 and int(b0["x"][0]) == 0
        pipe._staged[2].result(timeout=30)
        assert sorted(seen) == [0, 1, 2]                  # staged two ahead
        b1 = pipe(1)
        assert int(b1["x"][0]) == 1
        pipe._staged[3].result(timeout=30)
        assert sorted(seen) == [0, 1, 2, 3]               # reused the staged batch
        # checkpoint-restore style jump: stale read-ahead is dropped, not served
        b7 = pipe(7)
        assert int(b7["x"][0]) == 7
        assert all(s > 7 for s in pipe._staged)
        assert int(pipe(8)["x"][0]) == 8 and 8 in seen
    finally:
        pipe.close()


def test_pipeline_cold_fills_bounded_and_in_step_order():
    """The reference's ``test_prefetch_pipeline_cold_fills_bounded`` on the
    port: staged cold fills never accumulate (unconsumed fills of past
    steps go at the next call), and the store sees the steps in order."""
    class FakeStore:
        def __init__(self):
            self.seen = []

        def prefetch_cold(self, ids, valid=None):
            self.seen.append(int(np.asarray(ids)[0, 0]))
            return ("fill", self.seen[-1])

    with pytest.raises(ValueError, match="depth"):
        PrefetchPipeline(lambda s: {}, depth=0, device="cpu")
    store = FakeStore()
    pipe = PrefetchPipeline(lambda s: {"ids": np.full((2, 2), s, np.int32)},
                            depth=3, store=store, device="cpu")
    try:
        for step in range(25):
            pipe(step)                         # never calls take_cold
            assert len(pipe._cold) <= pipe.depth + 1
        assert pipe.take_cold(25) == ("fill", 25)  # current read-ahead usable
        assert pipe.take_cold(0) is None           # long gone
        assert store.seen == list(range(28))       # each step once, in order
    finally:
        pipe.close()


def test_pipeline_stages_on_the_card_unless_told(monkeypatch):
    """No device named means the card, as at every entry point of the port:
    with no card the pipeline refuses rather than stage on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchPipeline(lambda s: {})


def test_trainer_refuses_a_pipeline_on_another_device():
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search", seed=4)
    tr = _trainer(jcfg, cfg, params, buffers, state)
    pipe = PrefetchPipeline(ds.batch, device="meta")
    try:
        with pytest.raises(ValueError, match="stages on meta"):
            tr.run(ds.batch, 1, log_every=0, prefetch=pipe)
    finally:
        pipe.close()
    assert tr.step == 0 and not tr.history


def _trainer(jcfg, cfg, params, buffers, state):
    def tloss(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)
    return Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3))


def test_prefetched_run_is_the_synchronous_run():
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search", seed=4)
    runs = {}
    for prefetch in ("sync", "default", "depth3"):
        tr = _trainer(jcfg, cfg, params, buffers, state)
        pipe = (PrefetchPipeline(ds.batch, depth=3, device="cpu")
                if prefetch == "depth3"
                else prefetch == "default")
        tr.run(ds.batch, 6, log_every=0, prefetch=pipe)
        if prefetch == "depth3":
            pipe.close()
        runs[prefetch] = ([h["loss"] for h in tr.history],
                          [x.clone() for x in leaves(tr.params)])
    for name in ("default", "depth3"):
        assert runs[name][0] == runs["sync"][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[name][1],
                                                     runs["sync"][1]))
    # within rtol 1e-4 of the reference's prefetched run
    def jloss(p, bu, st, batch, *, step=None):
        return JDLRM.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers),
                   jax.tree.map(jnp.asarray, state), jadam(1e-3), donate=False)
    want = []
    ref.run(lambda s: ds.batch(s), 6, log_every=1, prefetch=True,
            log_fn=lambda m: want.append(float(m.split()[3])))
    np.testing.assert_allclose(runs["default"][0], want, rtol=1e-4)
