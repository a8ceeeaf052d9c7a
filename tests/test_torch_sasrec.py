"""Port parity for SASRec and its layers on the CPU, from parameters made
once by the reference and carried into the port (``jax.random`` and
``torch.Generator`` never agree), on the same seeded numpy batches:

- ``LayerNorm`` (rtol 1e-5, atol 1e-6: the mean and variance are summed in
  another order) and the bias-free ``Dense`` (rtol 1e-6: one product);
- ``MHA.apply`` causal and not, with one head, two heads and grouped kv
  heads (rtol = atol = 3e-5, the attention contract of the reference's
  tests); the options of the LM slice raise;
- the reduced SASRec under ``mpe_search`` and ``plain``: ``encode``
  (rtol = atol = 3e-5), ``loss_fn`` (rtol 1e-5) and the gradient of every
  parameter against ``jax.value_and_grad`` (rtol 1e-4, atol 1e-6 times the
  largest gradient of the tree: sums over the batch in another order);
- ``score_candidates`` from a carried ``packed`` table: the top-k scores
  (rtol 1e-5, atol 1e-6), and the indices wherever neighbouring scores
  differ by more than that (the two top-k order ties differently);
- four ``Trainer`` steps against the reference's Trainer (losses rtol 1e-4);
- the full configuration's numbers and the cells' shapes equal the
  reference's.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sasrec import ARCH as JARCH
from repro.configs.sasrec import make_config as jmake_config
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.launch import cells as jcells
from repro.models.sasrec import SASRec as JSASRec
from repro.models.sasrec import SASRecConfig as JSASRecConfig
from repro.nn.attention import MHA as JMHA
from repro.nn.linear import Dense as JDense
from repro.nn.norms import LayerNorm as JLayerNorm
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.configs import base as config_base
from repro_torch.configs.base import get_arch
from repro_torch.configs.sasrec import make_config
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.models.sasrec import SASRec, SASRecConfig
from repro_torch.nn.attention import MHA
from repro_torch.nn.linear import Dense
from repro_torch.nn.norms import LayerNorm
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten

VOCAB, D, S, B = 2_000, 16, 10, 6
LAM = 1e-5                          # the reference's SASRec train cell
ATTN_TOL = dict(rtol=3e-5, atol=3e-5)
BITS = (0, 1, 2, 3, 4, 5, 6)


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
        return {"bits": BITS, "d": D, "n": VOCAB, "group_size": 16}
    return None


def zipf_freqs(rng):
    return rng.zipf(1.2, VOCAB).astype(np.float64)


def reference_sasrec(compressor, seed=0):
    """A reduced reference SASRec with every parameter made non-trivial
    (norm scales and biases, feed-forward biases, γ and β of the search
    table), as numpy trees, with both configs."""
    rng = np.random.default_rng(seed)
    kw = dict(item_vocab=VOCAB, d_embed=D, seq_len=S, n_blocks=2, n_heads=1,
              compressor=compressor, comp_cfg=comp_cfg(compressor))
    jcfg, cfg = JSASRecConfig(**kw), SASRecConfig(**kw)
    params, buffers, state = JSASRec.init(jax.random.PRNGKey(seed), jcfg,
                                          zipf_freqs(rng))
    params = np_tree(params)

    def rand(shape, scale=0.1, loc=0.0):
        return (loc + scale * rng.normal(0, 1, shape)).astype(np.float32)

    for p in [*params["blocks"], {"ln_f": params["ln_f"]}]:
        for name in ("ln1", "ln2", "ln_f"):
            if name in p:
                p[name] = {"scale": rand((D,), 0.2, 1.0), "bias": rand((D,))}
        for name in ("ff1", "ff2"):
            if name in p:
                p[name]["bias"] = rand((D,))
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
    """Seeded item sequences: positives are the sequence shifted by one,
    negatives uniform; the first positions of two rows are padding."""
    seq = rng.integers(0, VOCAB, (n, S + 1)).astype(np.int32)
    mask = np.ones((n, S), np.float32)
    mask[0, :3] = mask[1, :1] = 0.0
    return {"seq_ids": seq[:, :-1], "pos_ids": seq[:, 1:],
            "neg_ids": rng.integers(0, VOCAB, (n, S)).astype(np.int32),
            "mask": mask}


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


def test_layernorm_matches_reference(rng):
    x = rng.normal(0.3, 2.0, (64, 24)).astype(np.float32)
    params = {"scale": rng.normal(1, 0.2, 24).astype(np.float32),
              "bias": rng.normal(0, 0.1, 24).astype(np.float32)}
    want = jax.jit(JLayerNorm.apply)(params, x)
    got = LayerNorm.apply(to_torch(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    fresh = LayerNorm.init(24)
    assert torch.equal(fresh["scale"], torch.ones(24))
    assert torch.equal(fresh["bias"], torch.zeros(24))


def test_dense_without_bias_matches_reference(rng):
    jparams = np_tree(JDense.init(jax.random.PRNGKey(0), 8, 4, use_bias=False))
    gen = torch.Generator().manual_seed(0)
    assert set(jparams) == set(Dense.init(gen, 8, 4, use_bias=False)) == {"kernel"}
    assert set(Dense.init(gen, 8, 4)) == {"kernel", "bias"}
    x = rng.normal(0, 1, (5, 8)).astype(np.float32)
    got = Dense.apply(to_torch(jparams, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JDense.apply(jparams, x)), rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_heads,n_kv", [(1, 1), (2, 2), (2, 1)],
                         ids=["1head", "2heads", "gqa"])
def test_mha_matches_reference(n_heads, n_kv, causal, rng):
    d, hd = 16, 16 // n_heads
    params = np_tree(JMHA.init(jax.random.PRNGKey(3), d, n_heads, n_kv,
                               head_dim=hd))
    x = rng.normal(0, 1, (3, 12, d)).astype(np.float32)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, causal=causal,
              rope_theta=None)
    want, _ = JMHA.apply(params, x, **kw)
    got, cache = MHA.apply(to_torch(params, "cpu"), torch.from_numpy(x), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_mha_options_of_the_lm_slice_raise(rng):
    """The options the LM slice brought no longer raise: qk-norm, RoPE at
    given positions, a KV cache written at its length and an extra mask
    each match the reference's ``MHA``."""
    d, nh, nkv, hd = 16, 4, 2, 4
    params = np_tree(JMHA.init(jax.random.PRNGKey(5), d, nh, nkv, head_dim=hd,
                               qk_norm=True))
    mine = MHA.init(torch.Generator().manual_seed(0), d, nh, nkv, hd,
                    qk_norm=True)
    assert sorted(mine) == sorted(params)
    assert all(tuple(mine[k]["scale"].shape) == (hd,)
               for k in ("q_norm", "k_norm"))
    tparams = to_torch(params, "cpu")
    x = rng.normal(0, 1, (2, 5, d)).astype(np.float32)
    kw = dict(n_heads=nh, n_kv_heads=nkv, head_dim=hd)
    pos = np.arange(3, 8, dtype=np.int32)[None]
    mask = rng.random((2, 5, 5)) < 0.7
    mask[:, :, 0] = True
    for extra in ({}, {"positions": pos}, {"attn_mask": mask}):
        want, _ = JMHA.apply(params, x, **kw, **extra)
        got, cache = MHA.apply(tparams, torch.from_numpy(x), **kw,
                               **{k: torch.from_numpy(v)
                                  for k, v in extra.items()})
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    jcache = {"k": jnp.zeros((2, 9, nkv, hd)), "v": jnp.zeros((2, 9, nkv, hd)),
              "len": jnp.asarray(0, jnp.int32)}
    tcache = {"k": torch.zeros((2, 9, nkv, hd)),
              "v": torch.zeros((2, 9, nkv, hd)),
              "len": torch.tensor(0, dtype=torch.int32)}
    for chunk in (x[:, :3], x[:, 3:4], x[:, 4:]):
        want, jcache = JMHA.apply(params, chunk, **kw, kv_cache=jcache)
        got, tcache = MHA.apply(tparams, torch.from_numpy(chunk), **kw,
                                kv_cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
        assert int(tcache["len"]) == int(jcache["len"])
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **ATTN_TOL)


@pytest.mark.parametrize("compressor", ["mpe_search", "plain"])
def test_encode_loss_and_grads_match_reference(compressor, rng):
    jcfg, cfg, params, buffers, state = reference_sasrec(compressor)
    batch = make_batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_h = jax.jit(lambda p, s: JSASRec.encode(p, buffers, s, jcfg))(
        params, jbatch["seq_ids"])
    (want_loss, (_, want_ce)), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: JSASRec.loss_fn(p, buffers, state, b, jcfg, lam=LAM),
        has_aux=True))(params, jbatch)

    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    assert t_state == {}
    h = SASRec.encode(t_params, t_buffers, torch.from_numpy(batch["seq_ids"]),
                      cfg)
    assert h.shape == (B, S, D)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **ATTN_TOL)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, (new_state, ce) = SASRec.loss_fn(t_params, t_buffers, t_state,
                                           torch_batch(batch), cfg, lam=LAM)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    loss, ce = loss.detach(), ce.detach()
    assert new_state == {}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-6)
    if compressor == "mpe_search":      # λ·reg reaches γ
        assert float(loss) > float(ce)
    else:
        assert float(loss) == float(ce)


def test_score_candidates_from_carried_packed_table(rng):
    jcfg, cfg, params, buffers, state = reference_sasrec("packed", seed=1)
    seq = rng.integers(0, VOCAB, (4, S)).astype(np.int32)
    cand = rng.permutation(VOCAB)[:500].astype(np.int32)
    want_vals, want_idx = jax.jit(lambda p, s, c: JSASRec.score_candidates(
        p, buffers, s, c, jcfg, top_k=50))(params, seq, cand)
    t_params, t_buffers, _ = carried(cfg, params, buffers, state)
    vals, idx = SASRec.score_candidates(t_params, t_buffers,
                                        torch.from_numpy(seq),
                                        torch.from_numpy(cand), cfg, top_k=50)
    want_vals, want_idx = np.asarray(want_vals), np.asarray(want_idx)
    assert vals.shape == idx.shape == (4, 50)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=1e-5, atol=1e-6)
    tol = 1e-6 + 1e-5 * np.abs(want_vals)
    gap = np.diff(want_vals, axis=1)                       # <= 0
    distinct = np.ones_like(want_vals, bool)
    distinct[:, 1:] &= -gap > tol[:, 1:]
    distinct[:, :-1] &= -gap > tol[:, :-1]
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[distinct], want_idx[distinct])


def test_trainer_steps_match_reference(rng):
    jcfg, cfg, params, buffers, state = reference_sasrec("mpe_search", seed=2)
    batches = [make_batch(rng, 8) for _ in range(4)]

    def jloss(p, bu, st, batch, *, step=None):
        return JSASRec.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return SASRec.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)

    ref = JTrainer(jloss, jnp_tree(params), jnp_tree(buffers), {}, jadam(1e-3),
                   donate=False)
    want = []
    for s, batch in enumerate(batches):
        ref.carry, out = ref._train_step(ref.carry, jnp_tree(batch),
                                         jnp.asarray(s))
        want.append(float(out["loss"]))
    port = Trainer(tloss, *carried(cfg, params, buffers, state), adam(1e-3))
    port.run(lambda s: batches[s], 4, log_every=0)
    got = [h["loss"] for h in port.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(h["skipped"] for h in port.history)
    assert len({round(x, 6) for x in got}) == 4           # it trains


def test_configuration_and_cells_match_reference():
    for reduced in (False, True):
        assert make_config(reduced)._asdict() == jmake_config(reduced)._asdict()
    full = make_config()
    assert (full.item_vocab, full.d_embed, full.seq_len, full.n_blocks,
            full.n_heads, full.compressor) == (8_388_608, 50, 50, 2, 1,
                                               "mpe_search")
    arch = get_arch("sasrec")
    assert arch.shapes == JARCH.shapes
    assert arch.citation == JARCH.citation
    assert config_base.SERVE_ROWS == {k: jcells.RECSYS_BATCH[k]
                                      for k in ("serve_p99", "serve_bulk")}
    # the SASRec cells that chip_smoke.py drives
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TRAIN_ROWS == jcells.RECSYS_BATCH["train_batch"]
    assert smoke.SERVE_CANDS == jcells.SERVE_CANDS
    assert smoke.N_CANDIDATES == jcells.N_CANDIDATES
