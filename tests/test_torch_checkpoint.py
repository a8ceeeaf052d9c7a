"""Checkpoints and error feedback in the port, on the CPU:

- ``train/checkpoint.py``: the save/restore round trip, keep-k,
  ``latest_step``, the temporary file renamed away, ``save_async`` copying
  before its thread runs; a checkpoint written by the reference's
  ``save`` is restored by the port and the reverse, with the same leaf
  names (``|``-joined paths, ``[i]`` for list items);
- the port's ``Trainer`` resumes bit-exactly (20 steps with a checkpoint
  every 10, a fresh trainer restored and run to 30, against 30 steps
  uninterrupted; every leaf restored in place), also with error feedback,
  whose residuals the checkpoint carries;
- a reference Trainer's checkpoint restored into the port's Trainer: its
  next loss within rtol 1e-4 of the reference's own next loss;
- ``train/compression.py``: ``int8_compress``/``int8_decompress`` and the
  error-feedback transform bit-identical to the reference's over 5 steps,
  the telescoping sum of the reference's test, the row-sparse round trip;
  ``Trainer(grad_compression=True)`` against the reference's at loss rtol
  1e-4 over 4 steps.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.dlrm import DLRM as JDLRM
from repro.train import checkpoint as jckpt
from repro.train.compression import int8_compress as j_int8_compress
from repro.train.compression import int8_decompress as j_int8_decompress
from repro.train.compression import \
    make_error_feedback_transform as j_make_ef
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.interop import to_torch
from repro_torch.models.dlrm import DLRM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import (int8_compress, int8_decompress,
                                           make_error_feedback_transform,
                                           rowsparse_compress,
                                           rowsparse_decompress)
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves
from test_torch_train import carried, np_tree, reference_model

LAM = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    return {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "s": np.int32(7),
            "l": [rng.integers(0, 9, (5,)).astype(np.int32),
                  {"x": rng.normal(0, 1, (2,)).astype(np.float32)}]}


def test_round_trip_keep_k_and_latest_step(tmp_path, rng):
    tree = to_torch(_tree(rng), "cpu")
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    assert ckpt.restore(d, tree) == (None, None)
    for step in (3, 10, 5, 12):
        ckpt.save(d, step, tree, keep=2)
    names = sorted(os.listdir(d))
    assert names == ["step_0000000010.npz", "step_0000000012.npz"]   # keep-k
    assert ckpt.latest_step(d) == 12
    back, step = ckpt.restore(d, tree)
    assert step == 12
    for x, y in zip(leaves(back), leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    back10, _ = ckpt.restore(d, tree, step=10)
    assert torch.equal(back10["a"], tree["a"])


def test_save_async_copies_before_its_thread(tmp_path, rng):
    tree = to_torch(_tree(rng), "cpu")
    want = tree["a"].clone()
    t = ckpt.save_async(str(tmp_path), 1, tree)
    tree["a"].add_(1.0)                   # the loop goes on updating in place
    t.join(timeout=30)
    assert not t.is_alive()
    back, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(back["a"], want)


def test_checkpoints_cross_between_packages(tmp_path, rng):
    tree = _tree(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = to_torch(tree, "cpu")
    jckpt.save(str(tmp_path / "ref"), 4, jtree)
    ckpt.save(str(tmp_path / "port"), 4, ttree)
    with np.load(tmp_path / "ref" / "step_0000000004.npz") as a, \
            np.load(tmp_path / "port" / "step_0000000004.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["a", "l|[0]", "l|[1]|x", "s"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    got, step = ckpt.restore(str(tmp_path / "ref"), ttree)
    assert step == 4
    for x, y in zip(leaves(got), leaves(ttree)):
        assert torch.equal(x, y)
    back, _ = jckpt.restore(str(tmp_path / "port"), jtree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _port_trainer(ckpt_dir=None, grad_compression=False, seed=1):
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search",
                                                            seed=seed)

    def loss_fn(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)
    trainer = Trainer(loss_fn, *carried(cfg, params, buffers, state),
                      adam(1e-3), ckpt_dir=ckpt_dir, ckpt_every=10,
                      grad_compression=grad_compression)
    return trainer, ds


@pytest.mark.parametrize("grad_compression", [False, True],
                         ids=["adam", "error-feedback"])
def test_checkpoint_resume_bit_exact(tmp_path, grad_compression):
    d = str(tmp_path)
    tr, ds = _port_trainer(d, grad_compression)
    tr.run(ds.batch, 20, log_every=0)
    tr2, _ = _port_trainer(d, grad_compression)
    ptrs = [x.data_ptr() for x in leaves([tr2.params, tr2.carry["opt"]])]
    assert tr2.restore() and tr2.step == 20
    assert [x.data_ptr() for x in leaves([tr2.params, tr2.carry["opt"]])] == ptrs
    tr2.run(ds.batch, 30, log_every=0)
    tr3, _ = _port_trainer(None, grad_compression)
    tr3.run(ds.batch, 30, log_every=0)
    assert [h["loss"] for h in tr2.history] == [h["loss"] for h in tr3.history[20:]]
    for key in ("params", "opt", "ef"):
        for a, c in zip(leaves(tr2.carry[key] or []), leaves(tr3.carry[key] or [])):
            assert torch.equal(a, c)
    assert sorted(os.listdir(d)) == ["step_0000000010.npz", "step_0000000020.npz",
                                     "step_0000000030.npz"]


def _ref_steps(ref, ds, start, stop):
    """The reference trainer's steps start..stop-1 through its jitted step
    (as its ``run`` takes them); returns their losses as floats."""
    losses = []
    for s in range(start, stop):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(s).items()}
        ref.carry, out = ref._train_step(ref.carry, batch, jnp.asarray(s))
        ref.step = s + 1
        losses.append(float(out["loss"]))
    return losses


def _both_loss_fns(jcfg, cfg):
    def jloss(p, bu, st, batch, *, step=None):
        return JDLRM.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)
    return jloss, tloss


def test_reference_checkpoint_restores_into_port_trainer(tmp_path):
    """The reference trains 3 steps and checkpoints; the port's trainer
    restores that checkpoint (in place) and takes step 3: its loss within
    rtol 1e-4 of the reference's own step 3."""
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search", seed=2)
    jloss, tloss = _both_loss_fns(jcfg, cfg)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers),
                   jax.tree.map(jnp.asarray, state), jadam(1e-3), donate=False,
                   ckpt_dir=str(tmp_path))
    ref.run(lambda s: ds.batch(s), 3, log_every=0)          # saves step 3
    want = _ref_steps(ref, ds, 3, 4)
    port = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3),
                   ckpt_dir=str(tmp_path))
    ptrs = [x.data_ptr() for x in leaves([port.params, port.carry["opt"]])]
    assert port.restore() and port.step == 3
    assert int(port.carry["opt"]["step"]) == 3
    assert [x.data_ptr() for x in leaves([port.params, port.carry["opt"]])] == ptrs
    port.ckpt_dir = None
    port.run(ds.batch, 4, log_every=0)
    np.testing.assert_allclose(port.history[0]["loss"], want[0], rtol=1e-4)


def test_int8_and_error_feedback_bit_identical_to_reference(rng):
    g = [{"w": rng.normal(0, 1, (30, 8)).astype(np.float32),
          "b": rng.normal(0, 1e-3, (8,)).astype(np.float32)} for _ in range(5)]
    x = g[0]["w"]
    q, s, e = int8_compress(torch.from_numpy(x), torch.zeros(8))
    jq, js, je = j_int8_compress(jnp.asarray(x), jnp.zeros((8,)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(int8_decompress(q, s).numpy(),
                                  np.asarray(j_int8_decompress(jq, js)))
    init, apply = make_error_feedback_transform()
    jinit, japply = j_make_ef()
    ef, jef = init(to_torch(g[0], "cpu")), jinit(jax.tree.map(jnp.asarray, g[0]))
    for step in g:
        out, ef = apply(to_torch(step, "cpu"), ef)
        jout, jef = japply(jax.tree.map(jnp.asarray, step), jef)
        for k in ("w", "b"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(jef[k]))


def test_int8_error_feedback_telescopes(rng):
    """Σ decompressed_t -> Σ g_t (the bias cancels through the residual)."""
    g_true = torch.from_numpy(rng.normal(0, 1, (50, 64)).astype(np.float32))
    err, total = torch.zeros(64), torch.zeros(64)
    for t in range(50):
        q, s, err = int8_compress(g_true[t], err)
        total = total + int8_decompress(q, s)
    np.testing.assert_allclose(total.numpy(), g_true.sum(0).numpy(), rtol=0,
                               atol=float(g_true.abs().max()) / 60)


def test_rowsparse_roundtrip():
    g = torch.zeros((100, 8))
    g[[3, 50, 99]] = 1.5
    idx, vals = rowsparse_compress(g, torch.tensor([3, 50, 99]))
    assert torch.equal(rowsparse_decompress(100, idx, vals), g)


def test_trainer_with_error_feedback_matches_reference():
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search", seed=3)
    jloss, tloss = _both_loss_fns(jcfg, cfg)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers),
                   jax.tree.map(jnp.asarray, state), jadam(1e-3), donate=False,
                   grad_compression=True)
    want = _ref_steps(ref, ds, 0, 4)
    port = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3),
                   grad_compression=True)
    ef_ptrs = [x.data_ptr() for x in leaves(port.carry["ef"])]
    port.run(ds.batch, 4, log_every=0)
    got = [h["loss"] for h in port.history]
    assert all(np.isfinite(got)) and not any(h["skipped"] for h in port.history)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert [x.data_ptr() for x in leaves(port.carry["ef"])] == ef_ptrs
    assert any(float(x.abs().max()) > 0 for x in leaves(port.carry["ef"]))
    ref_ef = np_tree(ref.carry["ef"])
    np.testing.assert_allclose(port.carry["ef"]["mlp"]["head"]["kernel"].numpy(),
                               ref_ef["mlp"]["head"]["kernel"], rtol=0, atol=1e-4)
