"""Port parity for the tiered hot/cold cache (``repro_torch.cache.tiers``),
case by case against the reference's ``tests/test_cache.py``, on the CPU
with both packages fed the same numpy tables:

- tiered lookups at hot fractions {0, 0.1, 1.0} bit-exact against the
  jitted reference ``packed_lookup`` (and the port's own), and within one
  float32 ulp (rtol 1e-6, the lookup kernel's contract) of the reference's
  eager ``store.lookup``. That difference is by design: the port
  dequantizes with one FMA everywhere (the rule of its lookup), the
  reference's eager cold path with two roundings;
- ``hot_feature_mask``/``zipf_frequencies``/``count_frequencies`` equal;
- the hit counters of a hand trace, and every counter equal to the
  reference store's on the same lookups;
- routing vectors, hot subtables, free slots and ``storage()`` equal to the
  reference store's after construction, after ``apply_moves`` and after
  ``refresh`` — with every device tensor written in place;
- the cold fill's plain version against the reference's ``cold_part``;
- ``DriftingCTR`` batches equal;
- ``PrefetchPipeline(store=)`` counters equal to the reference pipeline's
  over 25 steps at depth 3, its fills bounded;
- the engine's tiered lane: scores equal the port's monolithic cells
  within 1e-6 and the reference's tiered cell within 3e-5, overlap on and
  off bit-identical, zero recompiles when warm, counters equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PrefetchPipeline as JPrefetchPipeline
from repro.cache import TieredTableStore as JStore
from repro.core.inference import build_packed_table as jbuild
from repro.core.inference import packed_lookup as jpacked_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.data.synthetic import DriftingCTR as JDriftingCTR
from repro.embeddings import frequency as jfrequency
from repro.models.dlrm import DLRM as JDLRM
from repro.serve import Engine as JEngine
from repro_torch.cache import PrefetchPipeline, TieredTableStore
from repro_torch.cache.tiers import cold_buffer_words
from repro_torch.core.inference import packed_lookup
from repro_torch.core.packing import row_bytes
from repro_torch.data.synthetic import CTRSpec, DriftingCTR, SyntheticCTR
from repro_torch.embeddings import frequency
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.kernels.tiered_cold.ops import cold_fill
from repro_torch.kernels.tiered_cold.ref import cold_fill_ref
from repro_torch.models.dlrm import DLRM
from repro_torch.serve import Engine
from test_torch_dlrm import make_reference_dlrm

HOT_FRACTIONS = (0.0, 0.1, 1.0)
ULP = dict(rtol=1e-6, atol=0.0)     # the lookup kernel's contract


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_table(n=160, d=12, seed=0, bits=None):
    """The reference's ``_random_packed_table``: its table (jax arrays),
    the same as numpy, the same carried to the port, and the meta."""
    rng = np.random.default_rng(seed)
    cfg = JMPEConfig() if bits is None else JMPEConfig(bits=bits)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    fbits = rng.integers(0, len(cfg.bits), size=n).astype(np.int32)
    alpha = (np.abs(rng.normal(size=len(cfg.bits))) * 0.1
             + 0.01).astype(np.float32)
    beta = (rng.normal(size=d) * 0.01).astype(np.float32)
    table, meta = jbuild(emb, fbits, alpha, beta, cfg)
    table_np = jax.tree.map(np.asarray, table)
    return table, table_np, to_torch(table_np, "cpu"), meta


def stores(hot_fraction, seed=0, freqs_seed=1, **kw):
    table, table_np, ttable, meta = random_table(seed=seed, **kw)
    freqs = jfrequency.zipf_frequencies(meta["n"], seed=freqs_seed)
    return (TieredTableStore(ttable, meta, freqs, hot_fraction, device="cpu"),
            JStore(table, meta, freqs, hot_fraction), table, meta)


@functools.lru_cache(maxsize=None)
def _jitted(bits, d, n):
    meta = {"bits": bits, "d": d, "n": n}
    return jax.jit(lambda t, i: jpacked_lookup(t, meta, i))


def jitted_lookup(table, meta, ids):
    fn = _jitted(tuple(meta["bits"]), meta["d"], meta["n"])
    return np.asarray(fn(table, jnp.asarray(ids)))


def same_store(port, ref):
    """Routing vectors, hot subtables, free slots, mirror, storage and
    counters equal between the two stores."""
    np.testing.assert_array_equal(port._is_hot_np, ref._is_hot_np)
    np.testing.assert_array_equal(port._tier_local_np, ref._tier_local_np)
    np.testing.assert_array_equal(port._width_idx_np, ref._width_idx_np)
    for key in ("is_hot", "tier_local", "width_idx", "alpha", "beta"):
        np.testing.assert_array_equal(port.hot[key].numpy(),
                                      np.asarray(ref.hot[key]), err_msg=key)
    np.testing.assert_array_equal(
        port.hot["lookup_width_idx"].numpy(),
        np.where(ref._is_hot_np, np.asarray(ref.hot["width_idx"]), -1))
    assert port.hot["subtables"].keys() == ref.hot["subtables"].keys()
    for key, sub in ref.hot["subtables"].items():
        np.testing.assert_array_equal(
            port.hot["subtables"][key].numpy(),
            np.asarray(sub).view(np.int32), err_msg=key)
        np.testing.assert_array_equal(port._mirror[key],
                                      ref._mirror[key].view(np.int32))
    assert port._free_slots == ref._free_slots
    assert port.storage() == ref.storage()
    assert port.counters() == ref.counters()


@pytest.mark.parametrize("hot_fraction", HOT_FRACTIONS)
def test_tiered_lookup_bit_exact(hot_fraction):
    port, ref, table, meta = stores(hot_fraction)
    same_store(port, ref)
    ids = np.random.default_rng(2).integers(0, meta["n"], size=(41, 3)) \
        .astype(np.int32)
    want = jitted_lookup(table, meta, ids)
    got = port.lookup(ids).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    mono = packed_lookup(to_torch(jax.tree.map(np.asarray, table), "cpu"),
                         meta, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, mono)
    # the reference's eager lookup rounds twice: within one ulp of the FMA
    np.testing.assert_allclose(got, np.asarray(ref.lookup(ids)), **ULP)
    # the prefetch-handle path is the same bytes, staged earlier
    fill = port.prefetch_cold(ids)
    jfill = ref.prefetch_cold(ids)
    assert (fill.n, fill.bytes_moved) == (jfill.n, jfill.bytes_moved)
    np.testing.assert_array_equal(port.lookup(ids, fill).numpy(), want)
    ref.lookup(ids, jfill)
    assert port.counters() == ref.counters()


def test_cold_part_is_the_reference_cold_part():
    """The cold fill's dense part: the reference's ``cold_part`` (zeros off
    the cold rows), within one ulp; its words and positions the
    reference's fill's."""
    port, ref, _, meta = stores(0.25, seed=5)
    ids = np.random.default_rng(3).integers(0, meta["n"], (64, 4)) \
        .astype(np.int32)
    fill, jfill = port.prefetch_cold(ids), ref.prefetch_cold(ids)
    got = port.cold_part(fill).numpy()
    want = np.asarray(ref.cold_part(jfill))
    np.testing.assert_allclose(got, want, **ULP)
    np.testing.assert_array_equal(got == 0, want == 0)
    nb = len(meta["bits"])
    buf = fill.buffer.numpy()
    start, k = nb, sum(fill.counts)
    word = nb + k
    for i, pos, words in jfill.parts:          # the reference's, by width
        c = fill.counts[i]
        w = words.shape[1]
        np.testing.assert_array_equal(buf[start:start + c],
                                      np.asarray(pos)[:c])
        np.testing.assert_array_equal(
            buf[word:word + c * w].reshape(c, w),
            np.asarray(words)[:c].view(np.int32))
        start, word = start + c, word + c * w
    assert fill.counts == tuple(
        next((int((np.asarray(p) < ids.size).sum())
              for j, p, _ in jfill.parts if j == i), 0)
        for i in range(nb))
    # the wrapper on CPU tensors is its plain version, in place
    out = torch.full((ids.size, meta["d"]), 7.0)
    again = cold_fill_ref(out.clone(), fill.buffer, meta["bits"], meta["d"],
                          port.hot["alpha"], port.hot["beta"])
    assert cold_fill(out, fill.buffer, meta, port.hot["alpha"],
                     port.hot["beta"]) is out
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert cold_fill.launches == 0              # the CPU launches no kernel
    assert cold_buffer_words(ids.size, meta) >= buf.size


def test_frequency_helpers_equal_reference():
    rng = np.random.default_rng(4)
    freqs = np.array([5.0, 1.0, 9.0, 9.0, 2.0])
    mask = frequency.hot_feature_mask(freqs, 0.4)  # ceil(0.4*5) = 2 hottest
    assert mask.tolist() == [False, False, True, True, False]
    assert frequency.hot_feature_mask(freqs, 0.0).sum() == 0
    assert frequency.hot_feature_mask(freqs, 1.0).all()
    with pytest.raises(ValueError):
        frequency.hot_feature_mask(freqs, 1.5)
    ties = rng.integers(0, 5, 300).astype(np.float64)   # many ties
    for frac in (0.0, 0.01, 0.1, 0.37, 0.5, 1.0):
        np.testing.assert_array_equal(frequency.hot_feature_mask(ties, frac),
                                      jfrequency.hot_feature_mask(ties, frac))
    for seed in (None, 3):
        np.testing.assert_array_equal(
            frequency.zipf_frequencies(500, 1.05, seed),
            jfrequency.zipf_frequencies(500, 1.05, seed))
    batches = [rng.integers(0, 50, (7, 3)) for _ in range(4)]
    np.testing.assert_array_equal(frequency.count_frequencies(batches, 50),
                                  jfrequency.count_frequencies(batches, 50))


def test_hit_counters_match_hand_trace():
    # 4 features, all at one non-zero width; freqs make features {0, 1} hot
    rng = np.random.default_rng(3)
    n, d = 4, 4
    emb = rng.normal(size=(n, d)).astype(np.float32)
    fbits = np.full((n,), 1, np.int32)      # every feature at 8 bits
    alpha = np.array([0.0, 0.05], np.float32)
    beta = np.zeros((d,), np.float32)
    table, meta = jbuild(emb, fbits, alpha, beta, JMPEConfig(bits=(0, 8)))
    ttable = to_torch(jax.tree.map(np.asarray, table), "cpu")
    store = TieredTableStore(ttable, meta, [40, 30, 2, 1], 0.5, device="cpu")
    ref = JStore(table, meta, [40, 30, 2, 1], 0.5)

    ids = np.array([[0, 2], [1, 3], [0, 0]], np.int32)
    store.lookup(ids)
    ref.lookup(ids)
    c = store.counters()
    # hand trace: flat ids = 0,2,1,3,0,0 -> hot: 0,1,0,0 (4), cold: 2,3 (2)
    assert c["hot_lookups"] == 4
    assert c["cold_lookups"] == 2
    assert c["bytes_moved"] == 2 * row_bytes(d, 8)
    assert c["hit_rate"] == pytest.approx(4 / 6)
    assert c["hot_bytes"] == 2 * row_bytes(d, 8)
    assert c["cold_bytes"] == 2 * row_bytes(d, 8)
    assert c == ref.counters()

    store.reset_counters()
    store.lookup(np.array([2, 3], np.int32))             # all cold
    assert store.counters()["hot_lookups"] == 0
    assert store.counters()["bytes_moved"] == 2 * row_bytes(d, 8)

    # batcher padding (valid mask) fetches nothing and skips the counters
    store.reset_counters()
    padded = np.array([[2, 3], [0, 0], [0, 0]], np.int32)
    fill = store.prefetch_cold(padded, valid=np.array([True, False, False]))
    assert fill.bytes_moved == 2 * row_bytes(d, 8)       # row 0 only
    assert fill.counts == (0, 2)
    c = store.counters()
    assert c["hot_lookups"] == 0 and c["cold_lookups"] == 2


def refreshed_table(table_np, meta, seed):
    """A repack of the same features: new widths drawn within the table's
    subtable capacities (the repack path's contract)."""
    from repro.core.inference import build_packed_table
    rng = np.random.default_rng(seed)
    n, d = meta["n"], meta["d"]
    caps = {k: int(v.shape[0]) for k, v in table_np["subtables"].items()}
    bits = meta["bits"]
    while True:
        fb = rng.integers(0, len(bits), n).astype(np.int32)
        if all((fb == i).sum() <= caps[f"b{b}"]
               for i, b in enumerate(bits) if b):
            break
    emb = rng.normal(size=(n, d)).astype(np.float32)
    table, _ = build_packed_table(emb, fb, table_np["alpha"],
                                  table_np["beta"], JMPEConfig(bits=bits),
                                  row_capacities=caps)
    return table


@pytest.mark.parametrize("hot_fraction", [0.1, 0.3])
def test_routing_and_storage_equal_reference_through_moves_and_refresh(
        hot_fraction):
    from repro.cache import DecayAdmissionPolicy as JDecay
    port, ref, table, meta = stores(hot_fraction, seed=2)
    ptrs = {k: t.data_ptr() for k, t in _leaves(port.hot)}
    pol = ref.attach_policy(JDecay(meta["n"], halflife=4.0, max_moves=12))
    rng = np.random.default_rng(6)
    for round_ in range(5):
        ids = ((rng.integers(0, meta["n"], (48, 3)) + round_ * 20)
               % meta["n"]).astype(np.int32)
        port.lookup(ids)
        ref.lookup(ids)
        plan = pol.plan(ref)
        assert port.apply_moves(plan.promote, plan.demote) == \
            ref.apply_moves(plan.promote, plan.demote)
        same_store(port, ref)
        np.testing.assert_array_equal(port.lookup(ids).numpy(),
                                      jitted_lookup(table, meta, ids))
        ref.lookup(ids)
    new = refreshed_table(jax.tree.map(np.asarray, table), meta, seed=9)
    ref.attach_policy(None)
    port.refresh(to_torch(jax.tree.map(np.asarray, new), "cpu"), meta)
    ref.refresh(new, meta)
    same_store(port, ref)
    probe = np.arange(meta["n"], dtype=np.int32).reshape(-1, 4)
    np.testing.assert_array_equal(port.lookup(probe).numpy(),
                                  jitted_lookup(new, meta, probe))
    # every device tensor was written in place
    assert {k: t.data_ptr() for k, t in _leaves(port.hot)} == ptrs
    with pytest.raises(ValueError, match="metadata"):
        port.refresh(to_torch(jax.tree.map(np.asarray, new), "cpu"),
                     dict(meta, n=meta["n"] + 1))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("drift,shift_at", [(0.0, 3), (1.7, None),
                                            (0.5, 5)])
def test_drifting_ctr_batches_equal_reference(drift, shift_at):
    spec = CTRSpec(field_vocabs=(60, 40, 50), batch_size=33, seed=2)
    from repro.data.synthetic import CTRSpec as JCTRSpec
    kw = dict(drift_rate=drift, shift_at=shift_at, shift_frac=0.4, step0=100)
    port = DriftingCTR(spec, **kw)
    ref = JDriftingCTR(JCTRSpec(*spec), **kw)
    for step in (0, 99, 100, 102, 104, 105, 250):
        a, b = port.batch(step), ref.batch(step)
        for key in ("ids", "label"):
            np.testing.assert_array_equal(a[key], b[key])
        assert [port.field_offset(f, step) for f in range(3)] == \
            [ref.field_offset(f, step) for f in range(3)]
    np.testing.assert_array_equal(port.expected_frequencies(),
                                  ref.expected_frequencies())


def test_prefetch_pipeline_counters_equal_reference():
    """``PrefetchPipeline(store=)`` at depth 3 over 25 steps: the fills'
    counters and decayed scores are the reference pipeline's (each step
    observed once, in step order), every fill held is at most depth + 1,
    and a taken fill serves the jitted reference's lookup bit for bit."""
    from repro.cache import DecayAdmissionPolicy as JDecay
    from repro_torch.cache import DecayAdmissionPolicy
    port, ref, table, meta = stores(0.2, seed=7)
    port.attach_policy(DecayAdmissionPolicy(meta["n"], halflife=3.0))
    ref.attach_policy(JDecay(meta["n"], halflife=3.0))
    offsets = np.array([0, 40, 100], np.int64)

    def data_fn(step):
        rng = np.random.default_rng(step)
        ids = np.stack([rng.integers(0, v, 16) for v in (40, 60, 60)], 1)
        return {"ids": ids.astype(np.int32), "x": np.full((2,), step)}

    pipe = PrefetchPipeline(data_fn, depth=3, device="cpu", store=port,
                            offsets=offsets)
    jpipe = JPrefetchPipeline(data_fn, depth=3, store=ref, offsets=offsets)
    try:
        for step in range(25):
            batch, jbatch = pipe(step), jpipe(step)
            np.testing.assert_array_equal(batch["ids"].numpy(),
                                          np.asarray(jbatch["ids"]))
            assert len(pipe._cold) <= pipe.depth + 1
            assert sorted(pipe._cold) == sorted(jpipe._cold)
            if step % 4 == 0:
                fill = pipe.take_cold(step)
                jfill = jpipe.take_cold(step)
                gids = data_fn(step)["ids"] + offsets[None, :]
                np.testing.assert_array_equal(
                    port.lookup(gids, fill).numpy(),
                    jitted_lookup(table, meta, gids.astype(np.int32)))
                assert fill.bytes_moved == jfill.bytes_moved
            assert port.counters() == ref.counters()
            np.testing.assert_array_equal(port.policy.scores(),
                                          ref.policy.scores())
    finally:
        pipe.close()
    assert port.counters()["prefetches"] == 25 + 3     # steps 0..27


# -- the engine's tiered lane ------------------------------------------------

VOCABS = (150, 100, 120)
SHAPES = {"p99": 64, "bulk": 256}


@pytest.fixture(scope="module")
def served():
    """A reference packed DLRM carried to the port; one store each at hot
    fraction 0.3 on the same frequencies; both engines with the score and
    tiered cells."""
    jcfg, cfg, params, state, buffers = make_reference_dlrm(
        "dnn", seed=4, vocabs=VOCABS)
    spec = CTRSpec(field_vocabs=VOCABS, seed=4)
    freqs = SyntheticCTR(spec).expected_frequencies()
    meta = {k: cfg.comp_cfg[k] for k in ("bits", "d", "n")}
    table = params["embedding"]
    port_model = model_from_numpy(params, state, buffers, cfg, "cpu")
    store = TieredTableStore(port_model[0]["embedding"], meta, freqs, 0.3,
                             device="cpu")
    jstore = JStore(jax.tree.map(jnp.asarray, table), meta, freqs, 0.3)
    engine = Engine(device="cpu")
    engine.register_packed_model("dlrm", DLRM, cfg, *port_model,
                                 shapes={"serve_" + k: v
                                         for k, v in SHAPES.items()})
    engine.register_tiered_model("dlrm", DLRM, cfg, *port_model, store,
                                 shapes={"tiered_" + k: v
                                         for k, v in SHAPES.items()})
    jengine = JEngine()
    jengine.register_tiered_model(
        "dlrm", JDLRM, jcfg, params, state, dict(buffers, embedding={}),
        jstore, shapes={"tiered_" + k: v for k, v in SHAPES.items()})
    ids = SyntheticCTR(spec._replace(batch_size=300)).batch(50_000)["ids"]
    return engine, jengine, store, jstore, ids


def test_engine_tiered_matches_monolithic_and_reference(served):
    engine, jengine, store, jstore, ids = served
    mono = engine.score(ids, return_logits=True)
    tiered = engine.score_tiered(ids, return_logits=True)
    np.testing.assert_allclose(tiered, mono, rtol=0, atol=1e-6)
    jtiered = jengine.score_tiered(ids, return_logits=True)
    np.testing.assert_allclose(tiered, jtiered, rtol=3e-5, atol=3e-5)
    assert store.counters() == jstore.counters()


def test_engine_tiered_overlap_invariant_and_warm(served):
    engine, jengine, store, jstore, ids = served
    a = engine.score_tiered(ids, overlap=True)
    b = engine.score_tiered(ids, overlap=False)
    np.testing.assert_array_equal(a, b)             # overlap only moves bytes
    n_compiles = engine.compile_count
    engine.score_tiered(ids)
    assert engine.compile_count == n_compiles       # zero recompiles when warm
    c = engine.tier_counters()
    assert set(c) == {"tiered_bulk", "tiered_p99"}
    assert all(v["hot_lookups"] + v["cold_lookups"] > 0 for v in c.values())
    assert len(engine._tier_stores()) == 1
    keys = [k.shape.split("@")[0] for k in engine.registered_cells()]
    assert sorted(keys) == sorted(["serve_p99", "serve_p99.lookup",
                                   "serve_bulk", "serve_bulk.lookup",
                                   "tiered_p99", "tiered_bulk"])


def test_engine_tiered_cells_bind_the_stores_tensors(served):
    engine, _, store, _, _ = served
    for tc in engine._tiered.values():
        hot = tc.reg.bound[-1]
        assert {k: t.data_ptr() for k, t in _leaves(hot)} == \
            {k: t.data_ptr() for k, t in _leaves(store.hot)}
    with pytest.raises(ValueError, match="unroutable"):
        engine.register(next(iter(engine._tiered.values())).reg.celldef)
