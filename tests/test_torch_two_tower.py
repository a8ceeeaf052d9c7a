"""Port parity for two-tower retrieval on the CPU, from parameters made once
by the reference and carried into the port (``jax.random`` and
``torch.Generator`` never agree), on the same seeded numpy batches:

- both towers in eval and train mode (rtol 1e-5; atol 1e-6 of the unit
  vectors' entries in eval mode, 1e-5 in train mode, where BatchNorm
  divides by the spread of 12 rows), and ``loss_fn`` (rtol 1e-5);
- the gradient of every parameter against ``jax.value_and_grad`` (rtol
  1e-4, atol 1e-6 times the largest gradient of the tree);
- the in-batch softmax by blocks of ``LOSS_BLOCK_ROWS`` rows, set to a
  non-divisor of the batch, against the whole (B, B) matrix: the loss at
  rtol 1e-5 and every gradient at rtol 1e-5, atol 1e-7 times the largest;
- the BatchNorm state after a train-mode step (rtol 1e-5, atol 1e-6);
- four ``Trainer`` steps against the reference's Trainer (rtol 1e-4);
- the configurations equal the reference's.

Retrieval from a packed table and the engine's retrieve lane are held in
``tests/test_torch_two_tower_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.two_tower_retrieval import ARCH as JARCH
from repro.configs.two_tower_retrieval import make_config as jmake_config
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.models.two_tower import TwoTower as JTwoTower
from repro.models.two_tower import TwoTowerConfig as JTwoTowerConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
import repro_torch.models.two_tower as two_tower_module
from repro_torch.configs.base import get_arch
from repro_torch.configs.two_tower_retrieval import make_config
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy
from repro_torch.models.two_tower import (TwoTower, TwoTowerConfig,
                                          in_batch_softmax)
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten

USERS, ITEMS, D, B = (200, 150), (120, 90), 8, 12
HIDDEN = (32, 16)
LAM = 1e-5
N = sum(USERS) + sum(ITEMS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.array, tree)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def configs(compressor="mpe_search", comp_cfg=None, **kw):
    if compressor == "mpe_search" and comp_cfg is None:
        comp_cfg = JMPEConfig(group_size=16)._asdict()
    common = dict(d_embed=D, tower_hidden=HIDDEN, compressor=compressor,
                  comp_cfg=comp_cfg, **kw)
    jcfg = JTwoTowerConfig(
        user_fields=tuple(JFieldSpec(f"u{i}", v) for i, v in enumerate(USERS)),
        item_fields=tuple(JFieldSpec(f"i{i}", v) for i, v in enumerate(ITEMS)),
        **common)
    cfg = TwoTowerConfig(
        user_fields=tuple(FieldSpec(f"u{i}", v) for i, v in enumerate(USERS)),
        item_fields=tuple(FieldSpec(f"i{i}", v) for i, v in enumerate(ITEMS)),
        **common)
    return jcfg, cfg


def reference_two_tower(seed=0):
    """A reduced reference two-tower under ``mpe_search`` with every
    parameter and BatchNorm statistic made non-trivial, as numpy trees."""
    rng = np.random.default_rng(seed)
    jcfg, cfg = configs()
    freqs = rng.zipf(1.2, N).astype(np.float64)
    params, buffers, state = JTwoTower.init(jax.random.PRNGKey(seed), jcfg,
                                            freqs)
    params, buffers, state = np_tree(params), np_tree(buffers), np_tree(state)

    def rand(shape, scale=0.1, loc=0.0):
        return (loc + scale * rng.normal(0, 1, shape)).astype(np.float32)

    for tower in ("user_mlp", "item_mlp"):
        for layer in params[tower]["layers"]:
            layer["bias"] = rand(layer["bias"].shape)
        params[tower]["bn"] = [{"scale": rand((h,), 0.2, 1.0),
                                "bias": rand((h,))} for h in HIDDEN]
        state[tower]["bn"] = [{"mean": rand((h,)),
                               "var": np.abs(rand((h,), 0.2, 1.0))}
                              for h in HIDDEN]
    emb = params["embedding"]
    emb["emb"] = rand(emb["emb"].shape, 0.05)
    emb["gamma"] = rand(emb["gamma"].shape, 0.01)
    emb["beta"] = rand(emb["beta"].shape, 1e-4)
    return jcfg, cfg, params, buffers, state


def carried(cfg, params, buffers, state):
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    return t_params, t_buffers, t_state


def make_batch(rng, n=B):
    return {"user_ids": np.stack([rng.integers(0, v, n) for v in USERS],
                                 axis=1).astype(np.int32),
            "item_ids": np.stack([rng.integers(0, v, n) for v in ITEMS],
                                 axis=1).astype(np.int32),
            "item_logq": np.log(rng.uniform(1e-4, 1e-1, n)).astype(np.float32)}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pairs(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), path
        return [x for k in got for x in _pairs(got[k], want[k], f"{path}/{k}")]
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        return [x for i, (g, w) in enumerate(zip(got, want))
                for x in _pairs(g, w, f"{path}/{i}")]
    return [(path, got.detach().numpy(), np.asarray(want))]


def assert_tree_close(got, want, rtol, atol):
    """Leaf by leaf, matched by key; ``atol`` is scaled by the largest entry
    of the whole tree."""
    pairs = _pairs(got, want)
    top = max(np.abs(w).max() for _, _, w in pairs if w.size)
    for path, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * top,
                                   err_msg=path)


def test_carrier_takes_the_towers_and_their_offsets():
    _, cfg, params, buffers, state = reference_two_tower()
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    assert t_buffers["user_offsets"].tolist() == [0, USERS[0]]
    assert t_buffers["item_offsets"].tolist() == [sum(USERS),
                                                  sum(USERS) + ITEMS[0]]
    assert_tree_close(t_state, state, rtol=0, atol=0)
    fresh_params, fresh_buffers, fresh_state = TwoTower.init(cfg, seed=0,
                                                             device="cpu")
    for key in ("user_offsets", "item_offsets"):
        assert torch.equal(fresh_buffers[key], t_buffers[key])
    assert fresh_params["user_mlp"]["layers"][0]["kernel"].shape == (
        len(USERS) * D, HIDDEN[0])
    assert fresh_params["item_mlp"]["layers"][0]["kernel"].shape == (
        len(ITEMS) * D, HIDDEN[0])
    assert fresh_params["embedding"]["emb"].shape == (N, D)
    assert set(fresh_state) == {"user_mlp", "item_mlp"}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", ["user", "item"])
def test_towers_match_reference(which, train, rng):
    jcfg, cfg, params, buffers, state = reference_two_tower(seed=1)
    batch = make_batch(rng)
    ids = batch[f"{which}_ids"]
    jtower = getattr(JTwoTower, f"{which}_tower")
    want, want_state = jax.jit(lambda p, x: jtower(
        p, buffers, state, x, jcfg, train=train))(params, jnp.asarray(ids))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    with torch.no_grad():
        got, new_state = getattr(TwoTower, f"{which}_tower")(
            t_params, t_buffers, t_state, torch.from_numpy(ids), cfg,
            train=train)
    assert got.shape == (B, HIDDEN[-1])
    # unit vectors; in train mode BatchNorm divides by the standard
    # deviation of 12 rows, which the products' summation order moves by
    # a few 1e-6 of an entry
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 if train else 1e-6)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0,
                               rtol=1e-5)
    assert_tree_close(new_state, want_state, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("logq", [True, False])
def test_loss_and_grads_match_reference(logq, rng):
    jcfg, cfg, params, buffers, state = reference_two_tower(seed=2)
    batch = make_batch(rng)
    if not logq:
        del batch["item_logq"]
    (want_loss, (want_state, want_ce)), want_grads = jax.jit(
        jax.value_and_grad(lambda p, b: JTwoTower.loss_fn(
            p, buffers, state, b, jcfg, lam=LAM, train=True), has_aux=True))(
                params, jnp_tree(batch))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, (new_state, ce) = TwoTower.loss_fn(t_params, t_buffers, t_state,
                                             torch_batch(batch), cfg, lam=LAM)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    assert float(loss) > float(ce)                 # λ·reg reaches γ
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-6)
    assert_tree_close(new_state, want_state, rtol=1e-5, atol=1e-6)
    assert all(bool(g.abs().sum() > 0) for g in leaves(grads))


def whole_matrix_ce(u, v, logq, temperature):
    """The reference's formula: the whole (B, B) logits and log_softmax."""
    logits = (u @ v.T) / temperature
    if logq is not None:
        logits = logits - logq[None, :]
    return torch.mean(-torch.log_softmax(logits, dim=-1).diagonal())


@pytest.mark.parametrize("block", [5, 7, 12, 64])
@pytest.mark.parametrize("logq", [True, False])
def test_blocked_loss_equals_whole_matrix(block, logq, rng, monkeypatch):
    """Blocks of 5 and 7 rows divide no batch of 12 (three and two blocks,
    the last one short); 12 and 64 take the whole batch in one block. The
    logQ vector is batch data: the towers' outputs take the gradients."""
    monkeypatch.setattr(two_tower_module, "LOSS_BLOCK_ROWS", block)
    gen = np.random.default_rng(int(rng.integers(1 << 30)))
    u = torch.nn.functional.normalize(
        torch.from_numpy(gen.normal(0, 1, (B, 16)).astype(np.float32)), dim=1)
    v = torch.nn.functional.normalize(
        torch.from_numpy(gen.normal(0, 1, (B, 16)).astype(np.float32)), dim=1)
    q = (torch.from_numpy(np.log(gen.uniform(1e-4, 1e-1, B)).astype(np.float32))
         if logq else None)
    want_in = [x.clone().requires_grad_(True) for x in (u, v)]
    got_in = [x.clone().requires_grad_(True) for x in (u, v)]
    want = whole_matrix_ce(*want_in, q, 0.05)
    got = in_batch_softmax(*got_in, q, 0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_g = torch.autograd.grad(want, want_in)
    got_g = torch.autograd.grad(got, got_in)
    top = max(float(g.abs().max()) for g in want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7 * top)


def test_blocked_loss_in_the_model_equals_one_block(rng, monkeypatch):
    """The model's loss and every gradient with the batch cut into blocks
    of 5 rows equal those of one block (rtol 1e-5)."""
    _, cfg, params, buffers, state = reference_two_tower(seed=5)
    batch = torch_batch(make_batch(rng))

    def run():
        t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
        flat = [p.requires_grad_(True) for p in leaves(t_params)]
        loss, _ = TwoTower.loss_fn(t_params, t_buffers, t_state, batch, cfg,
                                   lam=LAM)
        return float(loss), torch.autograd.grad(loss, flat)

    one_loss, one_grads = run()
    monkeypatch.setattr(two_tower_module, "LOSS_BLOCK_ROWS", 5)
    loss, grads = run()
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
    top = max(float(g.abs().max()) for g in one_grads)
    for g, w in zip(grads, one_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * top)


def test_trainer_steps_match_reference(rng):
    jcfg, cfg, params, buffers, state = reference_two_tower(seed=4)
    batches = [make_batch(rng, 16) for _ in range(4)]

    def jloss(p, bu, st, batch, *, step=None):
        return JTwoTower.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return TwoTower.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)

    ref = JTrainer(jloss, jnp_tree(params), jnp_tree(buffers), jnp_tree(state),
                   jadam(1e-3), donate=False)
    want, want_state = [], None
    for s, batch in enumerate(batches):
        ref.carry, out = ref._train_step(ref.carry, jnp_tree(batch),
                                         jnp.asarray(s))
        want.append(float(out["loss"]))
        want_state = want_state or ref.carry["state"]
    port = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3))
    port.run(lambda s: batches[s], 1, log_every=0)
    # each tower's BatchNorm state after the first step, from the carried
    # parameters
    assert_tree_close(port.state, want_state, rtol=1e-5, atol=1e-6)
    port.run(lambda s: batches[s], 4, log_every=0)
    got = [h["loss"] for h in port.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(h["skipped"] for h in port.history)
    assert len({round(x, 6) for x in got}) == 4           # it trains


def test_configuration_matches_reference():
    for reduced in (False, True):
        got, want = make_config(reduced)._asdict(), jmake_config(reduced)._asdict()
        assert set(got) == set(want)
        for key, value in want.items():
            if key in ("user_fields", "item_fields"):
                assert [(f.name, f.vocab) for f in got[key]] == \
                    [(f.name, f.vocab) for f in value]
            else:
                assert got[key] == value, key
    spec = get_arch("two-tower-retrieval")
    assert spec.shapes == JARCH.shapes
    assert spec.family == JARCH.family and spec.citation == JARCH.citation
    full = make_config()
    rows = sum(f.vocab for f in (*full.user_fields, *full.item_fields))
    assert rows == 41_943_040 and full.d_embed == 64
