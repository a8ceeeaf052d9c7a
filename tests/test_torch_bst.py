"""Port parity for BST on the CPU, from parameters made once by the reference
and carried into the port (``jax.random`` and ``torch.Generator`` never
agree), on the same seeded numpy batches. The reduced configuration has
d = 16 and 8 heads, so each head is ``max(16 // 8, 4) = 4`` wide and the
attention 32 wide, wider than d:

- ``apply`` logits in eval mode under ``mpe_search`` and from a carried
  ``packed`` table (rtol = atol = 3e-5: the attention contract of the
  reference's tests, which SASRec's parity tests use);
- ``loss_fn`` in train mode (BatchNorm on the batch statistics): its value
  (rtol 1e-5) and the gradient of every parameter against
  ``jax.value_and_grad`` (rtol 1e-4, atol 1e-6 times the largest gradient
  of the tree: sums over the batch in another order);
- the BatchNorm state after a train-mode apply (rtol 1e-5, atol 1e-6: the
  batch means and variances are summed in another order);
- four ``Trainer`` steps against the reference's Trainer (losses rtol 1e-4);
- the configurations' numbers and the cells' shapes equal the reference's.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bst import ARCH as JARCH
from repro.configs.bst import make_config as jmake_config
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.launch import cells as jcells
from repro.models.bst import BST as JBST
from repro.models.bst import BSTConfig as JBSTConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.configs.base import get_arch
from repro_torch.configs.bst import make_config
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy
from repro_torch.models.bst import BST, BSTConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten

ITEMS, CTX, D, S, B = 2_000, (100, 50), 16, 8, 12
HIDDEN = (32, 16)
LAM = 1e-5                          # the reference's BST train cell
ATTN_TOL = dict(rtol=3e-5, atol=3e-5)
BITS = (0, 1, 2, 3, 4, 5, 6)
N = ITEMS + sum(CTX)
# leaves that reach the loss only as a shift of every row ahead of a
# train-mode BatchNorm: the block's last LayerNorm bias (through the MLP's
# first layer) and the biases of the MLP layers that BatchNorm follows
SHIFT_ONLY = (("blocks", 0, "ln2", "bias"), ("mlp", "layers", 0, "bias"),
              ("mlp", "layers", 1, "bias"))


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


def comp_cfg(compressor):
    if compressor == "mpe_search":
        return JMPEConfig(group_size=16)._asdict()
    if compressor == "packed":
        return {"bits": BITS, "d": D, "n": N, "group_size": 16}
    return None


def reference_bst(compressor, seed=0):
    """A reduced reference BST with every parameter and BatchNorm statistic
    made non-trivial, as numpy trees, with both configs."""
    rng = np.random.default_rng(seed)
    kw = dict(item_vocab=ITEMS, d_embed=D, seq_len=S, n_blocks=1, n_heads=8,
              mlp_hidden=HIDDEN, compressor=compressor,
              comp_cfg=comp_cfg(compressor))
    jcfg = JBSTConfig(ctx_fields=tuple(JFieldSpec(f"c{i}", v)
                                       for i, v in enumerate(CTX)), **kw)
    cfg = BSTConfig(ctx_fields=tuple(FieldSpec(f"c{i}", v)
                                     for i, v in enumerate(CTX)), **kw)
    freqs = rng.zipf(1.2, N).astype(np.float64)
    params, buffers, state = JBST.init(jax.random.PRNGKey(seed), jcfg, freqs)
    params, state = np_tree(params), np_tree(state)

    def rand(shape, scale=0.1, loc=0.0):
        return (loc + scale * rng.normal(0, 1, shape)).astype(np.float32)

    for blk in params["blocks"]:
        for name in ("ln1", "ln2"):
            blk[name] = {"scale": rand((D,), 0.2, 1.0), "bias": rand((D,))}
        for name in ("ff1", "ff2"):
            blk[name]["bias"] = rand(blk[name]["bias"].shape)
    for layer in params["mlp"]["layers"]:
        layer["bias"] = rand(layer["bias"].shape)
    params["mlp"]["bn"] = [{"scale": rand((h,), 0.2, 1.0), "bias": rand((h,))}
                           for h in HIDDEN]
    state["mlp"]["bn"] = [{"mean": rand((h,)),
                           "var": np.abs(rand((h,), 0.2, 1.0))}
                          for h in HIDDEN]
    if compressor == "mpe_search":
        emb = params["embedding"]
        emb["gamma"] = rand(emb["gamma"].shape, 0.01)
        emb["beta"] = rand(emb["beta"].shape, 1e-4)
    if compressor != "packed":
        buffers = np_tree(buffers)
    return jcfg, cfg, params, buffers, state


def carried(cfg, params, buffers, state):
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    return t_params, t_buffers, t_state


def make_batch(rng, n=B):
    return {"seq_ids": rng.integers(0, ITEMS, (n, S)).astype(np.int32),
            "target_id": rng.integers(0, ITEMS, (n,)).astype(np.int32),
            "ctx_ids": np.stack([rng.integers(0, v, n) for v in CTX],
                                axis=1).astype(np.int32),
            "label": rng.integers(0, 2, (n,)).astype(np.int32)}


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


def test_carrier_takes_bst_buffers():
    _, cfg, params, buffers, state = reference_bst("mpe_search")
    _, t_buffers, t_state = carried(cfg, params, buffers, state)
    assert t_buffers["item_offset"].shape == ()
    assert int(t_buffers["item_offset"]) == 0
    assert t_buffers["ctx_offsets"].tolist() == [ITEMS, ITEMS + CTX[0]]
    assert t_buffers["ctx_offsets"].dtype == torch.int32
    assert_tree_close(t_state, state, rtol=0, atol=0)
    fresh_params, fresh_buffers, fresh_state = BST.init(cfg, seed=0,
                                                        device="cpu")
    assert torch.equal(fresh_buffers["ctx_offsets"], t_buffers["ctx_offsets"])
    assert fresh_params["pos"].shape == (S + 1, D)
    # 8 heads of max(16 // 8, 4) = 4: the attention is 32 wide, not 16
    assert fresh_params["blocks"][0]["attn"]["wq"]["kernel"].shape == (D, 32)
    assert fresh_params["blocks"][0]["attn"]["wo"]["kernel"].shape == (32, D)
    assert fresh_params["mlp"]["layers"][0]["kernel"].shape == (
        (S + 1) * D + len(CTX) * D, HIDDEN[0])
    assert [s["mean"].shape[0] for s in fresh_state["mlp"]["bn"]] == list(HIDDEN)


@pytest.mark.parametrize("compressor", ["mpe_search", "packed"])
def test_apply_logits_match_reference(compressor, rng):
    jcfg, cfg, params, buffers, state = reference_bst(compressor, seed=1)
    batch = make_batch(rng)
    want, want_state, want_reg = jax.jit(lambda p, b: JBST.apply(
        p, buffers, state, b, jcfg, train=False))(params, jnp_tree(batch))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    got, new_state, reg = BST.apply(t_params, t_buffers, t_state,
                                    torch_batch(batch), cfg, train=False)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ATTN_TOL)
    np.testing.assert_allclose(float(reg), float(want_reg), rtol=1e-5)
    assert_tree_close(new_state, want_state, rtol=0, atol=0)  # eval: unchanged


def test_loss_and_grads_match_reference(rng):
    jcfg, cfg, params, buffers, state = reference_bst("mpe_search", seed=2)
    batch = make_batch(rng)
    (want_loss, (want_state, want_ce)), want_grads = jax.jit(
        jax.value_and_grad(lambda p, b: JBST.loss_fn(
            p, buffers, state, b, jcfg, lam=LAM, train=True), has_aux=True))(
                params, jnp_tree(batch))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, (new_state, ce) = BST.loss_fn(t_params, t_buffers, t_state,
                                        torch_batch(batch), cfg, lam=LAM)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    loss, ce = loss.detach(), ce.detach()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    assert float(loss) > float(ce)                 # λ·reg reaches γ
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-6)
    # the gradient reaches every part: positions, attention, MLP, table
    assert all(bool(g.abs().sum() > 0) for g in leaves(grads))


def test_batchnorm_state_after_train_apply_matches_reference(rng):
    jcfg, cfg, params, buffers, state = reference_bst("mpe_search", seed=3)
    batch = make_batch(rng, 32)
    _, want_state, _ = jax.jit(lambda p, b: JBST.apply(
        p, buffers, state, b, jcfg, train=True))(params, jnp_tree(batch))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    with torch.no_grad():
        _, new_state, _ = BST.apply(t_params, t_buffers, t_state,
                                    torch_batch(batch), cfg, train=True)
    assert_tree_close(new_state, want_state, rtol=1e-5, atol=1e-6)
    moved = new_state["mlp"]["bn"][0]["mean"] - t_state["mlp"]["bn"][0]["mean"]
    assert bool(moved.abs().max() > 0)


def test_trainer_steps_match_reference(rng):
    jcfg, cfg, params, buffers, state = reference_bst("mpe_search", seed=4)
    batches = [make_batch(rng, 16) for _ in range(4)]

    def jloss(p, bu, st, batch, *, step=None):
        return JBST.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return BST.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)

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
    # the first step's BatchNorm state comes from the carried parameters;
    # later ones from parameters that Adam has moved, where the rounding-size
    # gradients of the ``SHIFT_ONLY`` leaves become full steps in one package
    # and not the other (the next test holds them fixed)
    assert_tree_close(port.state, want_state, rtol=1e-5, atol=1e-6)
    port.run(lambda s: batches[s], 4, log_every=0)
    got = [h["loss"] for h in port.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(h["skipped"] for h in port.history)
    assert len({round(x, 6) for x in got}) == 4           # it trains


def hold(tree, stop, path=()):
    """``tree`` with its ``SHIFT_ONLY`` leaves passed through ``stop``."""
    if isinstance(tree, dict):
        return {k: hold(v, stop, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [hold(v, stop, path + (i,)) for i, v in enumerate(tree)]
    return stop(tree) if path in SHIFT_ONLY else tree


def test_batchnorm_state_after_four_steps_matches_reference(rng):
    """The ``SHIFT_ONLY`` leaves reach the loss only as a shift of every
    row that train-mode BatchNorm takes out again, so the reference's
    gradient of each is rounding: below 1e-6 times the largest gradient.
    Adam turns such a gradient into a full step of its sign, which the two
    packages draw differently. Held fixed in both, the BatchNorm state
    after four steps matches the reference's."""
    jcfg, cfg, params, buffers, state = reference_bst("mpe_search", seed=4)
    batches = [make_batch(rng, 16) for _ in range(4)]
    grads = jax.grad(lambda p, b: JBST.loss_fn(
        p, buffers, state, b, jcfg, lam=LAM, train=True)[0])(
            params, jnp_tree(batches[0]))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    top = max(float(jnp.abs(g).max()) for _, g in flat)
    shift_only = {tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path): float(jnp.abs(g).max())
                  for path, g in flat}
    for path in SHIFT_ONLY:
        assert shift_only[path] < 1e-6 * top, (path, shift_only[path], top)

    def jloss(p, bu, st, batch, *, step=None):
        return JBST.loss_fn(hold(p, jax.lax.stop_gradient), bu, st, batch,
                            jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        # zero gradient, the leaf still in the graph the Trainer differentiates
        return BST.loss_fn(hold(p, lambda x: x.detach() + 0.0 * x), bu, st,
                           batch, cfg, lam=LAM, step=step)

    ref = JTrainer(jloss, jnp_tree(params), jnp_tree(buffers), jnp_tree(state),
                   jadam(1e-3), donate=False)
    for s, batch in enumerate(batches):
        ref.carry, _ = ref._train_step(ref.carry, jnp_tree(batch),
                                       jnp.asarray(s))
    port = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3))
    port.run(lambda s: batches[s], 4, log_every=0)
    assert_tree_close(port.state, ref.carry["state"], rtol=1e-5, atol=1e-6)
    for path in SHIFT_ONLY:                    # held: Adam never moved them
        leaf = port.params
        for k in path:
            leaf = leaf[k]
        want = params
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf.numpy(), want)
    moved = port.state["mlp"]["bn"][0]["mean"] - torch.from_numpy(
        state["mlp"]["bn"][0]["mean"])
    assert bool(moved.abs().max() > 0)


def test_configuration_and_cells_match_reference():
    for reduced in (False, True):
        got, want = make_config(reduced)._asdict(), jmake_config(reduced)._asdict()
        assert set(got) == set(want)
        for key, value in want.items():
            if key == "ctx_fields":             # the fields' names and vocabs
                value = [(f.name, f.vocab) for f in value]
                assert [(f.name, f.vocab) for f in got[key]] == value
            else:
                assert got[key] == value, key
    full = make_config()
    assert (full.item_vocab, full.d_embed, full.seq_len, full.n_blocks,
            full.n_heads, full.mlp_hidden, full.compressor) == (
                16_777_216, 32, 20, 1, 8, (1024, 512, 256), "mpe_search")
    assert [f.vocab for f in full.ctx_fields] == [65_536] * 4
    arch = get_arch("bst")
    assert arch.shapes == JARCH.shapes
    assert arch.citation == JARCH.citation
    # the BST cells that chip_smoke.py drives
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TRAIN_ROWS == jcells.RECSYS_BATCH["train_batch"]
    assert smoke.N_CANDIDATES == jcells.N_CANDIDATES
    assert smoke.BST_LAM == LAM
