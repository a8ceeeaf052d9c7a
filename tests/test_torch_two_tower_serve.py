"""Port parity for two-tower retrieval's serving on the CPU, from models
made by the reference (their dense tables packed at random widths, as the
reference's own serving tests make them) and carried into the port:

- ``TwoTower.retrieval_score`` (rtol 1e-4, atol 1e-5; indices equal where
  the scores are apart by more);
- ``Engine.retrieve`` through ``two_tower_retrieval_cell`` against the
  reference's ``TwoTower.retrieval_score`` (rtol 1e-4, atol 1e-5), the
  corpus padded into one cell and chunked over three, as the reference's
  ``tests/test_serve.py`` holds its engine; another temperature is another
  executable; cells are routed by arch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.inference import build_packed_table as jbuild_packed_table
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.models.two_tower import TwoTower as JTwoTower
from repro.models.two_tower import TwoTowerConfig as JTwoTowerConfig
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.two_tower import TwoTower, TwoTowerConfig
from repro_torch.serve import Engine, two_tower_retrieval_cell
from test_torch_two_tower import (D, HIDDEN, ITEMS, USERS, carried, jnp_tree,
                                  np_tree)

SCORE_TOL = dict(rtol=1e-4, atol=1e-5)      # the reference's serve tests


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def packed_two_tower(rng, *, user_fields=USERS, item_fields=ITEMS, d=D,
                     hidden=HIDDEN, seed=0, widest=False):
    """A reference two-tower whose dense table is packed at random widths
    (all at the widest with ``widest``), as the reference's serving tests
    make one, with both configs under ``packed``."""
    jcfg = JTwoTowerConfig(
        user_fields=tuple(JFieldSpec(f"u{i}", v)
                          for i, v in enumerate(user_fields)),
        item_fields=tuple(JFieldSpec(f"i{i}", v)
                          for i, v in enumerate(item_fields)),
        d_embed=d, tower_hidden=hidden)
    params, buffers, state = JTwoTower.init(jax.random.PRNGKey(seed), jcfg)
    params, buffers, state = np_tree(params), np_tree(buffers), np_tree(state)
    emb = params["embedding"]["emb"]
    mpe = JMPEConfig()
    fbits = (np.full((emb.shape[0],), 6, np.int32) if widest else
             rng.integers(0, len(mpe.bits), emb.shape[0]).astype(np.int32))
    table, meta = jbuild_packed_table(
        emb, fbits, np.full((len(mpe.bits),), 0.02, np.float32),
        np.zeros((d,), np.float32), mpe)
    jcfg = jcfg._replace(compressor="packed", comp_cfg=meta)
    cfg = TwoTowerConfig(
        user_fields=tuple(FieldSpec(f.name, f.vocab)
                          for f in jcfg.user_fields),
        item_fields=tuple(FieldSpec(f.name, f.vocab)
                          for f in jcfg.item_fields),
        d_embed=d, tower_hidden=hidden, compressor="packed", comp_cfg=meta)
    sparams = dict(params, embedding=np_tree(table))
    sbuffers = dict(buffers, embedding={})
    return jcfg, cfg, sparams, sbuffers, state


def reference_scores(jcfg, params, buffers, state, user, cands, top_k):
    scores, idx = jax.jit(lambda p, st, u, c: JTwoTower.retrieval_score(
        p, buffers, st, u, c, jcfg, top_k=top_k))(
            jnp_tree(params), jnp_tree(state), jnp.asarray(user),
            jnp.asarray(cands))
    return np.asarray(scores), np.asarray(idx)


def assert_same_topk(scores, idx, want_scores, want_idx):
    """Scores within the serving contract; indices equal wherever the
    neighbouring scores differ by more than it (ties may order
    differently)."""
    np.testing.assert_allclose(scores, want_scores, **SCORE_TOL)
    gaps = np.abs(np.diff(want_scores))
    apart = np.ones_like(want_scores, bool)
    apart[:-1] &= gaps > 1e-4
    apart[1:] &= gaps > 1e-4
    np.testing.assert_array_equal(idx[apart], want_idx[apart])


def test_retrieval_score_matches_reference(rng):
    jcfg, cfg, params, buffers, state = packed_two_tower(rng, seed=2)
    user = np.stack([rng.integers(0, v, 1) for v in USERS], 1).astype(np.int32)
    cands = np.stack([rng.integers(0, v, 300) for v in ITEMS],
                     1).astype(np.int32)
    want = reference_scores(jcfg, params, buffers, state, user, cands, 20)
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    with torch.no_grad():
        scores, idx = TwoTower.retrieval_score(
            t_params, t_buffers, t_state, torch.from_numpy(user),
            torch.from_numpy(cands), cfg, top_k=20)
    assert_same_topk(scores.numpy(), idx.numpy(), *want)


def test_retrieve_matches_reference(rng):
    """One padded cell: 100 candidates in a cell of 128."""
    jcfg, cfg, params, buffers, state = packed_two_tower(
        rng, user_fields=(50, 40), item_fields=(80,), d=8, hidden=(16, 8))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    engine = Engine(device="cpu")
    engine.register(two_tower_retrieval_cell(
        TwoTower, cfg, t_params, t_state, t_buffers, n_cands=128, top_k=10,
        arch="tt"))
    user = rng.integers(0, 40, size=(1, 2)).astype(np.int32)
    cands = rng.integers(0, 80, size=(100, 1)).astype(np.int32)
    scores, idx = engine.retrieve(user, cands)
    want = reference_scores(jcfg, params, buffers, state, user, cands, 10)
    assert scores.shape == (10,) and idx.shape == (10,)
    assert_same_topk(scores, idx, *want)
    assert (idx < 100).all()             # padded candidates never surface
    assert engine.summary()["tt/retrieval_cand"]["count"] == 1


def test_retrieve_chunks_oversized_corpus(rng):
    """150 candidates over a cell of 64: three chunks, the last padded;
    another temperature is another executable."""
    jcfg, cfg, params, buffers, state = packed_two_tower(
        rng, user_fields=(30,), item_fields=(60,), d=4, hidden=(8, 4),
        seed=1, widest=True)
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    engine = Engine(device="cpu")
    engine.register(two_tower_retrieval_cell(
        TwoTower, cfg, t_params, t_state, t_buffers, n_cands=64, top_k=5,
        arch="tt"))
    user = np.zeros((1, 1), np.int32)
    cands = rng.integers(0, 60, size=(150, 1)).astype(np.int32)
    scores, idx = engine.retrieve(user, cands)
    assert scores.shape == (5,) and idx.shape == (5,)
    assert (np.diff(scores) <= 1e-9).all()          # sorted, best first
    want = reference_scores(jcfg, params, buffers, state, user, cands, 5)
    assert_same_topk(scores, idx, *want)
    assert engine.summary()["tt/retrieval_cand"]["count"] == 3

    compiles = engine.compile_count
    hot_cfg = cfg._replace(temperature=1.0)
    engine.register(two_tower_retrieval_cell(
        TwoTower, hot_cfg, t_params, t_state, t_buffers, n_cands=64, top_k=5,
        arch="tt"))
    assert engine.compile_count == compiles + 1
    hot_scores, _ = engine.retrieve(user, cands[:64])
    want_hot = reference_scores(jcfg._replace(temperature=1.0), params,
                                buffers, state, user, cands[:64], 5)
    np.testing.assert_allclose(hot_scores, want_hot[0], **SCORE_TOL)


def test_engine_routes_retrieve_cells_by_arch(rng):
    _, cfg, params, buffers, state = packed_two_tower(
        rng, user_fields=(30,), item_fields=(60,), d=4, hidden=(8, 4))
    t_params, t_buffers, t_state = carried(cfg, params, buffers, state)
    engine = Engine(device="cpu")
    with pytest.raises(ValueError, match="no retrieval cell"):
        engine.retrieve(np.zeros((1, 1), np.int32), np.zeros((3, 1), np.int32))
    for arch in ("a", "b"):
        engine.register(two_tower_retrieval_cell(
            TwoTower, cfg, t_params, t_state, t_buffers, n_cands=16, top_k=3,
            arch=arch))
    assert len(engine.registered_cells()) == 2
    cands = rng.integers(0, 60, size=(10, 1)).astype(np.int32)
    with pytest.raises(ValueError, match="pass arch="):
        engine.retrieve(np.zeros((1, 1), np.int32), cands)
    a = engine.retrieve(np.zeros((1, 1), np.int32), cands, arch="a")
    b = engine.retrieve(np.zeros((1, 1), np.int32), cands, arch="b")
    np.testing.assert_array_equal(a[0], b[0])
