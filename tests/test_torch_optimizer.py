"""The port's optimizers against the reference's on the CPU, from the same
numpy inputs:

- ``warmup_cosine`` over steps 0 … total+5 in float32, against the
  reference's schedule run op by op: bit for bit wherever the reference's
  float32 cosine is correctly rounded; where it is not (XLA's float32 cosine
  is one unit in the last place off for about 1% of arguments) the port
  takes the correctly rounded cosine, and the two are one float32 step
  apart;
- ``adam`` under a schedule (with weight decay), ``sgd`` with and without
  momentum and ``chain_weight_decay``: three clipped updates each against
  ``repro.train.optimizer`` run op by op, at rtol 1e-6 (and an atol of
  1e-6 times the tree's largest entry: the clip's norm is summed in
  another order);
- a skipped step (``ok`` false) leaves every bit of the parameters and the
  optimizer's state, its step included, for ``sgd`` and for ``adam`` under
  a schedule;
- the Adam pass's plain version with a schedule's value forms the decay's
  factor ``lr_t · wd`` in float32, as the reference forms it, and with a
  constant rate ``f32(lr · wd)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.interop import to_torch
from repro_torch.kernels.adam.ref import adam_step_ref_
from repro_torch.train.optimizer import (adam, chain_weight_decay, clip_scale,
                                         sgd, warmup_cosine)
from repro_torch.train.tree import leaves

SCHEDULES = [(1e-3, 10, 1000, 1e-5), (3e-3, 0, 50, 0.0), (1e-3, 100, 2000, 0.0),
             (2e-2, 7, 33, 1e-4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("base_lr,warmup,total,floor", SCHEDULES)
def test_warmup_cosine_matches_reference(base_lr, warmup, total, floor):
    steps = np.arange(0, total + 6, dtype=np.int32)
    want = np.asarray(jopt.warmup_cosine(base_lr, warmup, total, floor)(
        jnp.asarray(steps)))
    got = warmup_cosine(base_lr, warmup, total, floor)(
        torch.from_numpy(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    # where the reference's float32 cosine is not the correctly rounded one
    x = (np.float32(np.pi) * np.clip((steps.astype(np.float32) - warmup)
                                     / np.float32(max(total - warmup, 1)),
                                     0, 1)).astype(np.float32)
    c_xla = np.asarray(jnp.cos(jnp.asarray(x)))
    c_rounded = np.cos(x.astype(np.float64)).astype(np.float32)
    xla_off = (c_xla != c_rounded) & (steps >= warmup)
    np.testing.assert_array_equal(got[~xla_off], want[~xla_off])
    assert xla_off.mean() < 0.05 and _ulps(c_xla, c_rounded).max() <= 1
    # there, the reference's operations in float32 on the rounded cosine
    k = np.float32((base_lr - floor) * 0.5)
    with_rounded = np.float32(floor) + k * (np.float32(1) + c_rounded)
    np.testing.assert_array_equal(got[xla_off], with_rounded[xla_off])
    # one schedule value at a time, from a Python int or an int32 tensor
    for s in (0, warmup, total // 2, total + 5):
        v = warmup_cosine(base_lr, warmup, total, floor)(s)
        assert v.dtype == torch.float32 and v.ndim == 0
        assert float(v) == got[s]
        assert float(warmup_cosine(base_lr, warmup, total, floor)(
            torch.tensor(s, dtype=torch.int32))) == got[s]


def test_warmup_cosine_endpoints():
    """The reference test's endpoints: 0 at step 0, the base rate at the end
    of the warm-up, below 1e-5 at the end."""
    fn = warmup_cosine(1e-3, warmup=10, total=100)
    assert float(fn(torch.tensor(0))) == 0.0
    assert abs(float(fn(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(fn(torch.tensor(100))) < 1e-5


def _tree(rng):
    """Keys in sorted order, so both packages sum the clip's norm over the
    leaves in one order."""
    return {"b": rng.normal(0, 1, (8,)).astype(np.float32),
            "m": [rng.normal(0, 1, (5, 3)).astype(np.float32)],
            "w": rng.normal(0, 1, (20, 8)).astype(np.float32)}


def _like(tree, fn):
    """``fn`` over the leaves of ``tree``, keeping its keys' order (the
    port's trees list leaves in insertion order; ``jax.tree`` sorts keys)."""
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, fn) for v in tree]
    return fn(tree)


def _three_updates(rng, jtx, tx):
    """Three clipped updates of one small tree in both packages, the
    reference's run op by op; returns both params and states."""
    params = _tree(rng)
    grads = [_like(params, lambda v: rng.normal(0, 3, v.shape).astype(
        np.float32)) for _ in range(3)]
    jp, js = jax.tree.map(jnp.asarray, params), jtx.init(params)
    tp = to_torch(params, "cpu")
    ts = tx.init(tp)
    ok = torch.ones((), dtype=torch.bool)
    for g in grads:
        jg, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 10.0)
        u, js = jtx.update(jg, js, jp)
        jp = jopt.apply_updates(jp, u)
        tg = to_torch(g, "cpu")
        scale, tnorm = clip_scale(tg, 10.0)
        tx.update_(tp, tg, ts, scale, ok)
        assert float(tnorm) > 10.0                # the clip is active
    assert int(ts["step"]) == int(js["step"]) == 3
    return tp, ts, jp, js


def _assert_close(got, want, rtol):
    """Leaf by leaf at ``rtol``, and an atol of ``rtol`` times the tree's
    largest entry: the clip's norm is summed in another order, so a sum
    ``p + u`` may round to the neighbouring float of a leaf's scale."""
    got = jax.tree.leaves(_like(got, lambda x: x.numpy()))  # keys sorted
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    top = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * top)


@pytest.mark.parametrize("weight_decay", [0.0, 3e-6])
def test_adam_with_schedule_matches_reference(rng, weight_decay):
    sched = (2e-3, 2, 10, 1e-4)
    tp, ts, jp, js = _three_updates(
        rng, jopt.adam(jopt.warmup_cosine(*sched), weight_decay=weight_decay),
        adam(warmup_cosine(*sched), weight_decay=weight_decay))
    _assert_close(tp, jp, 1e-6)
    _assert_close(ts["mu"], js["mu"], 1e-6)
    _assert_close(ts["nu"], js["nu"], 1e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("scheduled", [False, True], ids=["const", "sched"])
def test_sgd_matches_reference(rng, momentum, scheduled):
    lr = (1e-2, 1, 5, 0.0) if scheduled else 1e-2
    jlr = jopt.warmup_cosine(*lr) if scheduled else lr
    tlr = warmup_cosine(*lr) if scheduled else lr
    tp, ts, jp, js = _three_updates(rng, jopt.sgd(jlr, momentum),
                                    sgd(tlr, momentum))
    _assert_close(tp, jp, 1e-6)
    assert ("mom" in ts) == bool(momentum)
    if momentum:
        _assert_close(ts["mom"], js["mom"], 1e-6)


def test_chain_weight_decay_matches_reference(rng):
    params, grads = _tree(rng), _tree(rng)
    want = jopt.chain_weight_decay(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, params), 3e-4)
    got = chain_weight_decay(to_torch(grads, "cpu"), to_torch(params, "cpu"),
                             3e-4)
    _assert_close(got, want, 1e-6)
    assert torch.equal(got["b"], to_torch(grads, "cpu")["b"])  # 1-D: no decay


@pytest.mark.parametrize("tx", [
    sgd(1e-2, 0.9), sgd(warmup_cosine(1e-2, 1, 5)),
    adam(warmup_cosine(1e-3, 2, 10), weight_decay=3e-6)],
    ids=["sgd-momentum", "sgd-sched", "adam-sched"])
def test_skipped_step_keeps_every_bit(rng, tx):
    params = to_torch(_tree(rng), "cpu")
    state = tx.init(params)
    ok = torch.ones((), dtype=torch.bool)
    tx.update_(params, to_torch(_tree(rng), "cpu"), state,
               torch.ones(()), ok)
    before = [x.clone() for x in leaves([params, state])]
    ptrs = [x.data_ptr() for x in leaves([params, state])]
    tx.update_(params, to_torch(_tree(rng), "cpu"), state, torch.ones(()),
               ~ok)
    after = leaves([params, state])
    assert [x.data_ptr() for x in after] == ptrs          # in place
    assert all(torch.equal(x, y) for x, y in zip(after, before))
    assert int(state["step"]) == 1


def test_adam_decay_factor_rounding(rng):
    """A schedule's value: the decay factor is f32(f32(lr_t)·f32(wd)), as
    the reference forms ``lr_t * weight_decay``; a constant rate:
    f32(lr·wd), the Python product rounded once. Chosen so that the two
    differ, each is held against the update written out."""
    lr, wd = 1e-3, 3e-6
    assert np.float32(np.float32(lr) * np.float32(wd)) != np.float32(lr * wd)
    p0 = torch.from_numpy(rng.normal(0, 1, (64, 4)).astype(np.float32))
    g = torch.zeros_like(p0)                  # the moments stay 0: u = -lr·wd·p
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    one, ok = torch.ones(()), torch.ones((), dtype=torch.bool)
    for rate, factor in ((lr, np.float32(lr * wd)),
                         (torch.tensor(lr, dtype=torch.float32),
                          np.float32(np.float32(lr) * np.float32(wd)))):
        p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        adam_step_ref_(p, g, m, v, one, ok, one, one, lr=rate, **hyper)
        want = p0.numpy() + (np.float32(0) - factor * p0.numpy())
        np.testing.assert_array_equal(p.numpy(), want.astype(np.float32))
