"""Port parity for the training path, on the CPU, from parameters made once
by the reference and carried into the port (``jax.random`` and
``torch.Generator`` never agree):

- BatchNorm in train mode and its new running statistics (rtol 1e-5,
  atol 1e-6: the batch variance is summed in another order);
- ``DLRM.loss_fn`` and its gradients for the ``mpe_search`` and
  ``mpe_retrain`` compressors (loss rtol 1e-5; gradients rtol 1e-4 and
  atol 1e-6 times the largest gradient of the tree: they are sums over the
  batch taken in another order, and the layer biases in front of
  BatchNorm, which BatchNorm cancels, get gradients of rounding size);
- ``adam``'s in-place ``update_`` after ``clip_scale`` against the
  reference's ``update`` after ``clip_by_global_norm`` (rtol 1e-5: the
  jitted reference may fuse its multiply-adds), also with bfloat16 moments;
- ``auc`` with ties and ``logloss``;
- a 5-step ``Trainer`` loss trajectory (loss rtol 1e-4) and a step with an
  injected NaN, which both trainers skip in the same way; the post-update
  hook, a projection in the trainer and the compressors' default identity,
  as in the reference. Adam turns the
  rounding-size gradients of the biases in front of BatchNorm into full
  steps, so those biases (and the running means they shift) are not
  compared after training; everything else is.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_compressor as jget_compressor
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro.nn.norms import BatchNorm as JBatchNorm
from repro.train import metrics as jmetrics
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro.train.optimizer import clip_by_global_norm as jclip
from repro_torch.core.api import get_compressor
from repro_torch.core.mpe import MPEConfig
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.nn.norms import BatchNorm
from repro_torch.train import metrics
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam, clip_scale
from repro_torch.train.tree import leaves, tree_map, unflatten

VOCABS = (300, 200, 150, 100)
LAM = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them, and its spinning threads
    then slow these many small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def mpe_comp_cfg():
    return JMPEConfig(group_size=16, lam=LAM)._asdict()


def configs(compressor, comp_cfg, vocabs=VOCABS, hidden=(32, 16)):
    """The same DLRM config in both packages."""
    kw = dict(d_embed=16, mlp_hidden=hidden, backbone="dnn",
              compressor=compressor, comp_cfg=comp_cfg)
    jcfg = JDLRMConfig(fields=tuple(JFieldSpec(f"f{i}", v)
                                    for i, v in enumerate(vocabs)), **kw)
    cfg = DLRMConfig(fields=tuple(FieldSpec(f"f{i}", v)
                                  for i, v in enumerate(vocabs)), **kw)
    return jcfg, cfg


def reference_model(compressor, seed=0, vocabs=VOCABS):
    """A reference DLRM of the search or retrain phase as numpy trees, with
    γ, α, β and the BatchNorm state made non-trivial, plus both configs and
    the data stream both packages read."""
    spec = JCTRSpec(field_vocabs=vocabs, batch_size=256, seed=seed)
    ds = JSyntheticCTR(spec)
    jcfg, _ = configs("mpe_search", mpe_comp_cfg(), vocabs)
    params, buffers, state = JDLRM.init(jax.random.PRNGKey(seed), jcfg,
                                        ds.expected_frequencies())
    params, buffers, state = np_tree(params), np_tree(buffers), np_tree(state)
    rng = np.random.default_rng(seed)
    emb = params["embedding"]
    emb["gamma"] = (0.01 * rng.normal(0, 1, emb["gamma"].shape)).astype(np.float32)
    emb["beta"] = rng.normal(0, 1e-4, emb["beta"].shape).astype(np.float32)
    for st in state["mlp"]["bn"]:
        st["mean"] = rng.normal(0, 0.05, st["mean"].shape).astype(np.float32)
    if compressor == "mpe_retrain":
        n = emb["emb"].shape[0]
        params["embedding"] = {k: emb[k] for k in ("emb", "alpha", "beta")}
        buffers["embedding"] = {
            "bits_idx": rng.integers(0, 7, n).astype(np.int32)}
    jcfg, cfg = configs(compressor, mpe_comp_cfg(), vocabs)
    return jcfg, cfg, params, buffers, state, ds


def carried(cfg, params, buffers, state):
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    return t_params, t_buffers, t_state


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pairs(got, want, path=""):
    """(path, port leaf, reference leaf), matched by key and position."""
    if isinstance(got, dict):
        assert set(got) == set(want), path
        return [x for k in got for x in _pairs(got[k], want[k], f"{path}/{k}")]
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        return [x for i, (g, w) in enumerate(zip(got, want))
                for x in _pairs(g, w, f"{path}/{i}")]
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return [(path, g, np.asarray(want))]


def assert_tree_close(got, want, rtol, atol, skip=()):
    """Leaf by leaf, matched by key; ``atol`` is scaled by the largest entry
    of the whole tree. Leaves whose path ends with one of ``skip`` are not
    compared."""
    pairs = [x for x in _pairs(got, want) if not x[0].endswith(tuple(skip))]
    top = max(np.abs(w).max() for _, _, w in pairs if w.size)
    for path, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * top,
                                   err_msg=path)


PRE_BN_BIASES = ("layers/0/bias", "layers/1/bias")


def test_batchnorm_train_mode_and_new_state(rng):
    x = rng.normal(0.3, 2.0, (64, 24)).astype(np.float32)
    params = {"scale": rng.normal(1, 0.2, 24).astype(np.float32),
              "bias": rng.normal(0, 0.1, 24).astype(np.float32)}
    state = {"mean": rng.normal(0, 0.1, 24).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 24).astype(np.float32)}
    want_y, want_state = jax.jit(
        lambda p, s, v: JBatchNorm.apply(p, s, v, train=True))(params, state, x)
    y, new_state = BatchNorm.apply(to_torch(params, "cpu"),
                                   to_torch(state, "cpu"),
                                   torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(),
                                   np.asarray(want_state[k]), rtol=1e-5, atol=1e-6)
    # the biased batch variance, as the reference (torch.var defaults to unbiased)
    np.testing.assert_allclose(
        new_state["var"].numpy(), 0.9 * state["var"] + 0.1 * x.var(0),
        rtol=1e-5)


@pytest.mark.parametrize("compressor", ["mpe_search", "mpe_retrain"])
def test_loss_and_grads_match_reference(compressor):
    jcfg, cfg, params, buffers, state, ds = reference_model(compressor)
    batch = ds.batch(3)

    def jloss(p, s, b):
        return JDLRM.loss_fn(p, buffers, s, b, jcfg, lam=LAM, train=True)
    (want_loss, (want_state, want_ce)), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})

    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, (new_state, ce) = DLRM.loss_fn(t_params, t_buffers, t_state,
                                         torch_batch(batch), cfg, lam=LAM)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    assert_tree_close(new_state, want_state, rtol=1e-5, atol=1e-6)
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-6)
    if compressor == "mpe_search":   # λ·reg reaches γ
        assert float(loss) > float(ce)
        assert np.abs(np.asarray(want_grads["embedding"]["gamma"])).max() > 0
    else:
        assert float(loss) == float(ce)


def _three_adam_steps(rng, jopt, opt):
    """Three clipped updates of one small tree in both packages; returns the
    port's and the reference's params and optimizer states."""
    params = {"w": rng.normal(0, 1, (20, 8)).astype(np.float32),
              "b": rng.normal(0, 1, (8,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 3, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jp, js = params, jopt.init(params)
    tp, ts = to_torch(params, "cpu"), opt.init(to_torch(params, "cpu"))

    @jax.jit
    def jstep(p, s, g):
        g, norm = jclip(g, 10.0)
        u, s = jopt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s, norm

    ok = torch.ones((), dtype=torch.bool)
    for g in grads:
        jp, js, jnorm = jstep(jp, js, g)
        tg = to_torch(g, "cpu")
        scale, tnorm = clip_scale(tg, 10.0)
        opt.update_(tp, tg, ts, scale, ok)           # in place
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
        assert float(tnorm) > 10.0            # the clip is active
    assert int(ts["step"]) == int(js["step"]) == 3
    return tp, ts, jp, js


def test_adam_update_and_clip_match_reference(rng):
    tp, ts, jp, js = _three_adam_steps(rng, jadam(1e-3, weight_decay=3e-6),
                                       adam(1e-3, weight_decay=3e-6))
    assert_tree_close(tp, jp, rtol=1e-5, atol=1e-7)
    assert_tree_close(ts["mu"], js["mu"], rtol=1e-5, atol=1e-7)
    assert_tree_close(ts["nu"], js["nu"], rtol=1e-5, atol=1e-7)


def test_adam_bfloat16_moments_match_reference(rng):
    """``moment_dtype``: μ and ν stored in bfloat16, the update in float32.
    Moments to one bfloat16 step (rtol 2^-8: a last-bit difference of the
    float32 value before the cast can round it the other way), parameters
    to rtol 1e-5."""
    tp, ts, jp, js = _three_adam_steps(
        rng, jadam(1e-3, moment_dtype=jnp.bfloat16),
        adam(1e-3, moment_dtype=torch.bfloat16))
    for k in ("mu", "nu"):
        assert all(x.dtype == torch.bfloat16 for x in leaves(ts[k]))
        assert_tree_close(tree_map(lambda x: x.float(), ts[k]),
                          jax.tree.map(lambda x: np.asarray(x, np.float32), js[k]),
                          rtol=2 ** -8, atol=0)
    assert_tree_close(tp, jp, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_auc_and_logloss_match_reference(ties, rng):
    n = 2000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 20) / 20                   # 21 levels
        scores[:200] = 0.5
    scores = np.clip(scores + 0.2 * labels, 0, 1).astype(np.float32)
    want_auc = float(jmetrics.auc(jnp.asarray(labels), jnp.asarray(scores)))
    want_ll = float(jmetrics.logloss(jnp.asarray(labels), jnp.asarray(scores)))
    got_auc = float(metrics.auc(torch.from_numpy(labels), torch.from_numpy(scores)))
    got_ll = float(metrics.logloss(torch.from_numpy(labels),
                                   torch.from_numpy(scores)))
    np.testing.assert_allclose(got_auc, want_auc, rtol=1e-6)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)
    assert float(metrics.auc(torch.ones(4), torch.rand(4))) == 0.5


def _loss_fns(jcfg, cfg, nan_step=None):
    def jloss(p, bu, st, batch, *, step=None):
        loss, aux = JDLRM.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)
        if nan_step is not None:
            loss = loss * jnp.where(step == nan_step, jnp.nan, 1.0)
        return loss, aux

    def tloss(p, bu, st, batch, *, step=None):
        loss, aux = DLRM.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)
        if nan_step is not None:
            loss = loss * torch.where(step == nan_step, torch.nan, 1.0)
        return loss, aux
    return jloss, tloss


class _BothTrainers:
    """The reference's and the port's Trainer on one carried model and one
    data stream, stepped together."""

    def __init__(self, compressor, nan_step=None, post_updates=(None, None)):
        jcfg, cfg, params, buffers, state, ds = reference_model(compressor,
                                                                seed=2)
        jloss, tloss = _loss_fns(jcfg, cfg, nan_step)
        self.ds = ds
        self.ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, buffers),
                            jax.tree.map(jnp.asarray, state), jadam(1e-3),
                            donate=False, post_update=post_updates[0])
        self.port = Trainer(tloss, *carried(cfg, params, buffers, state),
                            adam(1e-3), post_update=post_updates[1])
        self.want = []

    def run(self, n_steps):
        for s in range(self.ref_steps, n_steps):
            batch = {k: jnp.asarray(v) for k, v in self.ds.batch(s).items()}
            self.ref.carry, out = self.ref._train_step(self.ref.carry, batch,
                                                       jnp.asarray(s))
            if self.ref.post_update is not None:    # as the reference's run
                self.ref.carry["params"] = self.ref.post_update(
                    self.ref.carry["params"])
            self.want.append({k: float(v) for k, v in out.items()})
        self.port.run(self.ds.batch, n_steps, log_every=0)

    @property
    def ref_steps(self):
        return len(self.want)


@pytest.mark.parametrize("compressor", ["mpe_search", "mpe_retrain"])
def test_trainer_loss_trajectory_matches_reference(compressor):
    both = _BothTrainers(compressor)
    both.run(5)
    got, want = both.port.history, both.want
    assert [h["step"] for h in got] == list(range(5))
    np.testing.assert_allclose([h["loss"] for h in got],
                               [w["loss"] for w in want], rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in got],
                               [w["grad_norm"] for w in want], rtol=1e-3)
    assert not any(h["skipped"] for h in got)
    assert len({round(h["loss"], 6) for h in got}) == 5   # it trains
    assert_tree_close(both.port.params["mlp"], both.ref.params["mlp"],
                      rtol=1e-3, atol=1e-4, skip=PRE_BN_BIASES)


def test_trainer_post_update_matches_reference():
    """The post-update hook runs after every step in both trainers. Here it
    clamps the table to ±2e-3 (the init's std is 3e-3, so it bites); the
    trajectory at loss rtol 1e-4, the projected table at atol 1e-6."""
    c = 2e-3

    def jpost(p):
        return dict(p, embedding=dict(p["embedding"], emb=jnp.clip(
            p["embedding"]["emb"], -c, c)))

    def tpost(p):
        return dict(p, embedding=dict(p["embedding"], emb=torch.clamp(
            p["embedding"]["emb"], -c, c)))

    both = _BothTrainers("mpe_search", post_updates=(jpost, tpost))
    assert float(both.port.params["embedding"]["emb"].abs().max()) > c
    both.run(4)
    np.testing.assert_allclose([h["loss"] for h in both.port.history],
                               [w["loss"] for w in both.want], rtol=1e-4)
    table = both.port.params["embedding"]["emb"]
    assert float(table.abs().max()) == np.float32(c)
    np.testing.assert_allclose(table.numpy(),
                               np.asarray(both.ref.params["embedding"]["emb"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("compressor", ["mpe_search", "mpe_retrain", "plain"])
def test_compressor_post_update_hook_matches_reference(compressor):
    """The compressors ported so far keep the reference's default hook:
    ``post_update`` hands the parameters back untouched."""
    params = {"emb": np.ones((4, 2), np.float32)}
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params, "cpu")
    assert jget_compressor(compressor).post_update(
        jp, {}, {}, jax.random.PRNGKey(0)) is jp
    assert get_compressor(compressor).post_update(
        tp, {}, {}, torch.Generator()) is tp


def _copy(tree):
    return jax.tree.map(np.array, tree)


def test_injected_nan_step_is_skipped_as_in_reference():
    both = _BothTrainers("mpe_search", nan_step=2)
    both.run(2)
    port_ptrs = [x.data_ptr() for x in leaves([both.port.params,
                                               both.port.carry["opt"]])]
    port_before = _copy({k: both.port.carry[k] for k in ("params", "opt",
                                                         "state")})
    ref_before = _copy({k: both.ref.carry[k] for k in ("params", "opt",
                                                       "state")})
    both.run(3)                                     # step 2: the NaN
    got, want = both.port.history, both.want
    assert bool(got[2]["skipped"]) and bool(want[2]["skipped"])
    assert np.isnan(got[2]["loss"]) and np.isnan(want[2]["loss"])
    for trainer, before in ((both.port, port_before), (both.ref, ref_before)):
        after = _copy({k: trainer.carry[k] for k in ("params", "opt", "state")})
        # params and the whole optimizer state, Adam's step included, kept
        for x, y in zip(jax.tree.leaves(after["params"]) +
                        jax.tree.leaves(after["opt"]),
                        jax.tree.leaves(before["params"]) +
                        jax.tree.leaves(before["opt"])):
            np.testing.assert_array_equal(x, y)
        assert int(after["opt"]["step"]) == 2
        if trainer is both.port:   # each leaf kept in place, bit-unchanged
            assert [x.data_ptr() for x in leaves(
                [trainer.params, trainer.carry["opt"]])] == port_ptrs
        # the BatchNorm state still takes its new value
        assert not np.array_equal(after["state"]["mlp"]["bn"][0]["var"],
                                  before["state"]["mlp"]["bn"][0]["var"])
    both.run(4)
    assert not got[3]["skipped"] and not want[3]["skipped"]
    np.testing.assert_allclose([got[i]["loss"] for i in (0, 1, 3)],
                               [want[i]["loss"] for i in (0, 1, 3)], rtol=1e-4)
    assert int(both.port.carry["opt"]["step"]) == 3


def test_trainer_frees_each_steps_trees_without_the_collector():
    """A step's trees are freed as soon as nothing refers to them: a
    reference cycle would keep whole tables alive until the cyclic garbage
    collector ran (at full width that held 73 GB of device memory). The
    trainer updates its trees in place, so with the collector off, after
    each step exactly three tensors of the table's shape are alive: the
    table and its two Adam moments, the same objects step after step."""
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search")
    _, tloss = _loss_fns(jcfg, cfg)
    trainer = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3))
    shape = trainer.params["embedding"]["emb"].shape

    def tables():
        return sorted(id(x) for x in gc.get_objects()
                      if torch.is_tensor(x) and x.shape == shape)

    del params, buffers, state
    gc.collect()
    gc.disable()
    try:
        trainer.run(ds.batch, 1, log_every=0)
        held = [trainer.params["embedding"]["emb"],
                trainer.carry["opt"]["mu"]["embedding"]["emb"],
                trainer.carry["opt"]["nu"]["embedding"]["emb"]]
        assert tables() == sorted(id(x) for x in held)
        refs = [weakref.ref(x) for x in leaves(trainer.carry["opt"]["mu"])
                + leaves(trainer.params)]
        trainer.run(ds.batch, 2, log_every=0)
        assert tables() == sorted(id(x) for x in held)
        assert all(r() is not None for r in refs)       # updated in place
    finally:
        gc.enable()


def _step_by_hand(trainer, batch, step):
    """The step the trainer takes, by hand on copies of its trees: autograd
    on the copied parameters, ``clip_scale``, ``update_``. Returns the new
    params and optimizer state."""
    copy = tree_map(lambda x: x.detach().clone(), trainer.params)
    opt = tree_map(lambda x: x.clone(), trainer.carry["opt"])
    flat = [p.requires_grad_(True) for p in leaves(copy)]
    loss, _ = trainer.loss_fn(copy, trainer.buffers, trainer.state,
                              torch_batch(batch),
                              step=torch.full((), step, dtype=torch.int32))
    grads = unflatten(copy, list(torch.autograd.grad(loss, flat)))
    copy = tree_map(lambda x: x.detach(), copy)
    scale, gnorm = clip_scale(grads, 10.0)
    ok = torch.isfinite(gnorm) & torch.isfinite(loss.detach())
    trainer.optimizer.update_(copy, grads, opt, scale, ok)
    return copy, opt


def test_trainer_updates_every_leaf_in_place():
    """A step leaves every parameter leaf, both Adam moments and Adam's step
    at their tensors and ``data_ptr``s, holding the new values: bit for bit
    those of the same step taken by hand on copies of the trees (autograd,
    ``clip_scale``, ``update_``) from the same start."""
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search")
    _, tloss = _loss_fns(jcfg, cfg)
    trainer = Trainer(tloss, *carried(cfg, params, buffers, state),
                      adam(1e-3, weight_decay=3e-6))
    trainer.run(ds.batch, 1, log_every=0)
    want_params, want_opt = _step_by_hand(trainer, ds.batch(1), 1)
    carry = [trainer.params, trainer.carry["opt"]]
    ptrs = [x.data_ptr() for x in leaves(carry)]
    before = [x.clone() for x in leaves(carry)]
    trainer.run(ds.batch, 2, log_every=0)
    after = leaves([trainer.params, trainer.carry["opt"]])
    assert [x.data_ptr() for x in after] == ptrs
    for x, y in zip(after, leaves([want_params, want_opt])):
        assert torch.equal(x, y)
    assert int(trainer.carry["opt"]["step"]) == 2
    moved = [not torch.equal(x, y) for x, y in zip(after, before)]
    assert sum(moved) >= len(moved) - 2      # γ and β may take no gradient


def test_port_stream_is_the_reference_stream():
    spec = dict(field_vocabs=VOCABS, batch_size=64, seed=5)
    mine = SyntheticCTR(CTRSpec(**spec)).eval_set(2)
    ref = JSyntheticCTR(JCTRSpec(**spec)).eval_set(2)
    for a, b in zip(mine, ref):
        for k in ("ids", "label"):
            np.testing.assert_array_equal(a[k], b[k])


def test_mpe_config_carries_lam():
    assert MPEConfig().lam == JMPEConfig().lam == 1e-5
    assert MPEConfig._fields == JMPEConfig._fields
    assert DLRMConfig(fields=()).compressor == JDLRMConfig(fields=()).compressor \
        == "plain"
