"""Port parity for the traffic-adaptive tier policy
(``repro_torch.cache.policy``) and what it drives, case by case against the
reference's ``tests/test_policy.py``, on the CPU with both packages fed the
same numpy inputs:

- decay scores of a hand trace, and scores and plans equal to the
  reference's on the same trace (bounded, feasible, hysteresis);
- lookups bit-exact against the jitted reference through move rounds, with
  routing vectors equal to the reference store's after each;
- writebacks: the packed words the reference's, round trips, last write
  wins, a demotion loses nothing;
- the popularity shift: the port's counters are the reference's, the
  adaptive policy recovers and the static one does not;
- the engine's ``TickClock`` drift replay with writebacks on the
  reference's exported table: its counters equal the reference's key for
  key, with zero captures; two runs equal;
- ``PressureAdapter``: the assignments the reference's, the swap lands
  with zero recaptures and the tiered cells score the swapped table.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DecayAdmissionPolicy as JDecay
from repro.cache import StaticTierPolicy as JStatic
from repro.cache import TieredTableStore as JStore
from repro.core.inference import build_packed_table as jbuild
from repro.core.inference import packed_lookup as jpacked_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.core.quantizer import dequantize_codes as jdequantize
from repro.core.quantizer import quantize_codes as jquantize
from repro.embeddings.frequency import zipf_frequencies
from repro_torch.cache import (DecayAdmissionPolicy, StaticTierPolicy,
                               TieredTableStore)
from repro_torch.core.quantizer import dequantize_codes, quantize_codes
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.embeddings.table import FieldSpec
from repro_torch.serve import Engine, PressureAdapter, TickClock

ULP = dict(rtol=1e-6, atol=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_table(n=160, d=12, seed=0):
    rng = np.random.default_rng(seed)
    cfg = JMPEConfig()
    emb = rng.normal(size=(n, d)).astype(np.float32)
    fbits = rng.integers(0, len(cfg.bits), size=n).astype(np.int32)
    alpha = (np.abs(rng.normal(size=len(cfg.bits))) * 0.1
             + 0.01).astype(np.float32)
    beta = (rng.normal(size=d) * 0.01).astype(np.float32)
    table, meta = jbuild(emb, fbits, alpha, beta, cfg)
    return table, to_torch(jax.tree.map(np.asarray, table), "cpu"), meta


def stores(hot_fraction, seed=0, freqs=None):
    table, ttable, meta = random_table(seed=seed)
    if freqs is None:
        freqs = zipf_frequencies(meta["n"], seed=1)
    return (TieredTableStore(ttable, meta, freqs, hot_fraction, device="cpu"),
            JStore(table, meta, freqs, hot_fraction), table, meta)


@functools.lru_cache(maxsize=None)
def _jitted(bits, d, n):
    meta = {"bits": bits, "d": d, "n": n}
    return jax.jit(lambda t, i: jpacked_lookup(t, meta, i))


def jitted_lookup(table, meta, ids):
    fn = _jitted(tuple(meta["bits"]), meta["d"], meta["n"])
    return np.asarray(fn(table, jnp.asarray(ids)))


def same_routing(port, ref):
    np.testing.assert_array_equal(port._is_hot_np, ref._is_hot_np)
    np.testing.assert_array_equal(port._tier_local_np, ref._tier_local_np)
    for key in ("is_hot", "tier_local"):
        np.testing.assert_array_equal(port.hot[key].numpy(),
                                      np.asarray(ref.hot[key]))
    for key, sub in ref.hot["subtables"].items():
        np.testing.assert_array_equal(port.hot["subtables"][key].numpy(),
                                      np.asarray(sub).view(np.int32))
        np.testing.assert_array_equal(port._mirror[key],
                                      ref._mirror[key].view(np.int32))
    assert port._free_slots == ref._free_slots
    assert port.counters() == ref.counters()


def same_plan(a, b):
    for key in ("promote", "demote", "promote_score", "demote_score"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


# -- score math ---------------------------------------------------------------

def test_decay_scores_match_hand_trace():
    p = DecayAdmissionPolicy(4, halflife=1.0)       # decay = 0.5 per tick
    j = JDecay(4, halflife=1.0)
    for ids in ([0, 0, 1], [1]):
        p.observe(ids)
        j.observe(ids)
    s = p.scores()                                  # decayed to t=2
    assert s[0] == pytest.approx(1.0)               # 2 * 0.5
    assert s[1] == pytest.approx(1.5)
    assert s[2] == 0.0 and s[3] == 0.0
    p.observe([])                                   # empty chunk still ticks
    j.observe([])
    assert p.scores()[0] == pytest.approx(0.5)
    assert p.observations == 3
    np.testing.assert_array_equal(p.scores(), j.scores())


def test_policy_validates_knobs():
    with pytest.raises(ValueError):
        DecayAdmissionPolicy(8, halflife=0.0)
    with pytest.raises(ValueError):
        DecayAdmissionPolicy(8, margin=0.9)


def test_static_policy_never_moves():
    port, _, _, meta = stores(0.3)
    pol = port.attach_policy(StaticTierPolicy())
    port.lookup(np.arange(meta["n"], dtype=np.int32).reshape(-1, 4))
    plan = pol.plan(port)
    assert plan.n_moves == 0
    same_plan(plan, JStatic().plan(port))


# -- plan feasibility + incremental moves ------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_equals_reference_bounded_and_feasible(seed):
    port, ref, _, meta = stores(0.25, seed=seed)
    pol = port.attach_policy(
        DecayAdmissionPolicy(meta["n"], halflife=4.0, max_moves=10))
    jpol = ref.attach_policy(JDecay(meta["n"], halflife=4.0, max_moves=10))
    rng = np.random.default_rng(5 + seed)
    cold_ids = np.nonzero(~port._is_hot_np)[0]
    for _ in range(6):                              # hammer the cold tier
        ids = rng.choice(cold_ids, size=(32, 4)).astype(np.int32)
        port.lookup(ids)
        ref.lookup(ids)
    np.testing.assert_array_equal(pol.scores(), jpol.scores())
    plan = pol.plan(port)
    same_plan(plan, jpol.plan(ref))
    assert 0 < plan.n_moves <= 10
    assert not port._is_hot_np[plan.promote].any()
    assert port._is_hot_np[plan.demote].all()
    widx = port._width_idx_np
    free = port.free_slot_counts()
    for i, b in enumerate(meta["bits"]):            # per-width slot budget
        n_pro = int((widx[plan.promote] == i).sum())
        n_dem = int((widx[plan.demote] == i).sum())
        assert b != 0 or (n_pro == 0 and n_dem == 0)
        if b != 0:
            assert n_pro <= free.get(f"b{b}", 0) + n_dem
    s = port.apply_moves(plan.promote, plan.demote)
    assert s == ref.apply_moves(plan.promote, plan.demote)
    assert s["promotions"] == plan.promote.size
    same_routing(port, ref)
    # infeasible plans are rejected loudly, not applied
    with pytest.raises(ValueError):
        port.apply_moves(plan.promote, np.zeros(0, np.int64))  # already hot


def test_lookups_bit_exact_through_move_rounds():
    port, ref, table, meta = stores(0.3, seed=2)
    n = meta["n"]
    port.attach_policy(DecayAdmissionPolicy(n, halflife=4.0, max_moves=64))
    ref.attach_policy(JDecay(n, halflife=4.0, max_moves=64))
    probe = np.arange(n, dtype=np.int32).reshape(-1, 4)
    want = jitted_lookup(table, meta, probe)
    rng = np.random.default_rng(6)
    for round_ in range(8):
        ids = ((rng.integers(0, n, size=(48, 3)) + round_ * 20) % n) \
            .astype(np.int32)
        port.lookup(ids)
        ref.lookup(ids)
        plan = port.policy.plan(port)
        same_plan(plan, ref.policy.plan(ref))
        port.apply_moves(plan.promote, plan.demote)
        ref.apply_moves(plan.promote, plan.demote)
        same_routing(port, ref)
        got = port.lookup(probe).numpy()
        ref.lookup(probe)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"values drifted at round {round_}")


# -- writeback ----------------------------------------------------------------

def test_writeback_round_trip_bit_exact_per_width():
    port, ref, _, meta = stores(0.4, seed=3)
    d, bits = meta["d"], meta["bits"]
    rng = np.random.default_rng(7)
    widx = port._width_idx_np
    picks = []      # one hot + one cold feature per non-zero width bucket
    for i, b in enumerate(bits):
        if b == 0:
            continue
        feats = np.nonzero(widx == i)[0]
        for hot in (True, False):
            sub = feats[port._is_hot_np[feats] == hot]
            if sub.size:
                picks.append(int(sub[0]))
    ids = np.asarray(picks, np.int64)
    vecs = rng.normal(size=(ids.size, d)).astype(np.float32)
    s = port.writeback(ids, vecs)
    assert s == ref.writeback(ids, vecs)
    assert s["written"] == ids.size and s["bytes"] > 0
    same_routing(port, ref)                 # the packed words the reference's
    got = port.lookup(ids.astype(np.int32)[:, None]).numpy()[:, 0]
    jgot = np.asarray(ref.lookup(ids.astype(np.int32)[:, None]))[:, 0]
    for k, f in enumerate(ids):
        i, b = int(widx[f]), int(bits[int(widx[f])])
        alpha = torch.tensor(port._alpha_np[i])
        beta = torch.from_numpy(port._beta_np)
        codes = quantize_codes(torch.from_numpy(vecs[k][None]), alpha, beta, b)
        want = dequantize_codes(codes, alpha, beta).numpy()[0]   # one FMA
        np.testing.assert_array_equal(got[k], want, err_msg=f"feature {f}")
        jcodes = jquantize(jnp.asarray(vecs[k][None]), port._alpha_np[i],
                           port._beta_np, b)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        jwant = np.asarray(jdequantize(jcodes, port._alpha_np[i],
                                       port._beta_np))[0]
        np.testing.assert_allclose(got[k], jwant, **ULP)
    np.testing.assert_allclose(got, jgot, **ULP)
    assert port.counters()["writebacks"] == ids.size


def test_writeback_survives_demotion_and_dedupes():
    """The ordering contract: mirror written first, so demoting a feature
    right after a writeback re-exposes the *updated* row — no lost update.
    Duplicate ids in one writeback resolve last-write-wins."""
    port, ref, _, meta = stores(0.4, seed=4)
    widx, bits, d = port._width_idx_np, meta["bits"], meta["d"]
    hot_nz = np.nonzero(port._is_hot_np & (np.asarray(bits)[widx] != 0))[0]
    f = int(hot_nz[0])
    rng = np.random.default_rng(8)
    v1, v2 = rng.normal(size=(2, d)).astype(np.float32)
    for store in (port, ref):
        store.writeback(np.array([f, f]), np.stack([v1, v2]))   # last wins
    same_routing(port, ref)
    hot_read = port.lookup(np.array([[f]], np.int32)).numpy()[0, 0]
    ref.lookup(np.array([[f]], np.int32))
    for store in (port, ref):
        store.apply_moves(np.zeros(0, np.int64), np.array([f]))  # demote
    same_routing(port, ref)
    cold_read = port.lookup(np.array([[f]], np.int32)).numpy()[0, 0]
    ref.lookup(np.array([[f]], np.int32))
    assert port.counters() == ref.counters()
    np.testing.assert_array_equal(hot_read, cold_read)           # nothing lost
    i = int(widx[f])
    alpha = torch.tensor(port._alpha_np[i])
    beta = torch.from_numpy(port._beta_np)
    codes = quantize_codes(torch.from_numpy(v2[None]), alpha, beta,
                           int(bits[i]))
    np.testing.assert_array_equal(
        cold_read, dequantize_codes(codes, alpha, beta).numpy()[0])  # v2


# -- popularity shift: adaptive recovers, static doesn't ---------------------

def _shift_run(store, policy, n_chunks=60, shift_chunk=20, steady_chunk=40,
               seed=9):
    """Seeded zipf traffic whose identity rotates by n/2 at ``shift_chunk``;
    returns (pre-shift hit rate, steady-state hit rate after the shift,
    the final counters)."""
    n = store.meta["n"]
    freqs = zipf_frequencies(n)
    store.attach_policy(policy)
    rng = np.random.default_rng(seed)
    snaps = {}
    for chunk in range(n_chunks):
        ids = rng.choice(n, size=(64, 4), p=freqs)
        if chunk >= shift_chunk:
            ids = (ids + n // 2) % n
        store.lookup(ids.astype(np.int32))
        plan = store.policy.plan(store)
        store.apply_moves(plan.promote, plan.demote)
        if chunk + 1 in (shift_chunk, steady_chunk):
            snaps[chunk + 1] = store.counters()
    c = store.counters()
    hot_d = c["hot_lookups"] - snaps[steady_chunk]["hot_lookups"]
    cold_d = c["cold_lookups"] - snaps[steady_chunk]["cold_lookups"]
    return snaps[shift_chunk]["hit_rate"], hot_d / (hot_d + cold_d), c


def test_popularity_shift_adaptive_recovers_static_does_not():
    freqs = zipf_frequencies(160)                  # rank == id: 0 hottest
    runs = {}
    for name, make in (("static", lambda: (StaticTierPolicy(), JStatic())),
                       ("decay", lambda: (
                           DecayAdmissionPolicy(160, halflife=8.0,
                                                max_moves=64),
                           JDecay(160, halflife=8.0, max_moves=64)))):
        port, ref, _, _ = stores(0.2, seed=1, freqs=freqs)
        pol, jpol = make()
        runs[name] = _shift_run(port, pol)
        assert runs[name] == _shift_run(ref, jpol)   # the reference's numbers
    (pre_s, steady_static, _), (pre_a, steady_adaptive, _) = \
        runs["static"], runs["decay"]
    assert pre_s > 0.5 and pre_a > 0.5          # both fine before the shift
    assert steady_adaptive > steady_static + 0.25
    assert steady_adaptive > 0.5                # recovered
    assert steady_static < 0.3                  # stale split stays broken


# -- engine integration: zero recaptures + deterministic replay ---------------

@pytest.fixture(scope="module")
def pipeline():
    """The reference's exported table and MLP (``train_packed_dlrm``, as its
    own test trains them), as numpy, with the port's config."""
    from repro.launch.serve import train_packed_dlrm
    jcfg, params, state, buffers, spec, res = train_packed_dlrm(
        field_vocabs=(150, 100, 120), train_steps=10, train_batch=128,
        d_embed=8, mlp_hidden=(16,), seed=4)
    cfg = DLRMConfig(fields=tuple(FieldSpec(f.name, f.vocab)
                                  for f in jcfg.fields),
                     d_embed=jcfg.d_embed, mlp_hidden=tuple(jcfg.mlp_hidden),
                     backbone=jcfg.backbone, compressor="packed",
                     comp_cfg=dict(jcfg.comp_cfg))
    tree = jax.tree.map(np.asarray, (params, state, buffers))
    return {"jcfg": jcfg, "cfg": cfg, "ref": (params, state, buffers),
            "np": tree, "port": model_from_numpy(*tree, cfg, "cpu"),
            "spec": spec, "res": res,
            "table_np": jax.tree.map(np.asarray, res["packed_table"])}


def _drift_engine_run(pipeline, policy_name, port: bool):
    """A small TickClock open-loop drift replay with writebacks in the port
    (``port=True``) or the reference; returns (counters dict, engine)."""
    from repro.data.synthetic import DriftingCTR, SyntheticCTR
    from repro.launch import serve as jlaunch
    from repro.models.dlrm import DLRM as JDLRM
    from repro.serve import Engine as JEngine
    from repro.serve import TickClock as JTickClock
    from repro_torch.launch import serve as launch

    spec, res = pipeline["spec"], pipeline["res"]
    freqs = SyntheticCTR(spec).expected_frequencies()
    master = np.asarray(res["final_params"]["embedding"]["emb"])
    offs = np.asarray(pipeline["np"][2]["offsets"], np.int64)
    meta = res["packed_meta"]
    if port:
        store = TieredTableStore(to_torch(pipeline["table_np"], "cpu"), meta,
                                 freqs, 0.2, device="cpu")
        engine = Engine(device="cpu", clock=TickClock())
        engine.register_tiered_model("dlrm", DLRM, pipeline["cfg"],
                                     *pipeline["port"], store,
                                     shapes={"tiered": 64})
        decay, static, run = DecayAdmissionPolicy, StaticTierPolicy, launch
    else:
        store = JStore(res["packed_table"], meta, freqs, 0.2)
        engine = JEngine(clock=JTickClock())
        engine.register_tiered_model("dlrm", JDLRM, pipeline["jcfg"],
                                     *pipeline["ref"], store,
                                     shapes={"tiered": 64})
        decay, static, run = JDecay, JStatic, jlaunch
    policy = (decay(store.meta["n"], halflife=8.0, max_moves=128)
              if policy_name == "decay" else static())
    engine.attach_tier_policy(policy, every=1)
    ds = DriftingCTR(spec._replace(batch_size=48), shift_at=8,
                     shift_frac=0.4, step0=10_000)

    def on_submit(i, ids):
        if i and i % 6 == 0:
            gids = np.unique(np.asarray(ids, np.int64) + offs[None, :])
            engine.writeback_embeddings(gids, master[gids])

    compiles0 = engine.compile_count
    ol = run.run_open_loop(engine, lambda i: ds.batch(10_000 + i)["ids"], 24,
                           500.0, kind="tiered", on_submit=on_submit)
    c = store.counters()
    det = {k: c[k] for k in ("hot_lookups", "cold_lookups", "bytes_moved",
                             "promotions", "demotions", "writebacks",
                             "writeback_bytes")}
    det["completed"], det["shed"] = ol["completed"], ol["shed"]
    det["recompiles"] = engine.compile_count - compiles0
    return det, engine


@pytest.mark.parametrize("policy_name", ["decay", "static"])
def test_engine_drift_replay_equals_reference(pipeline, policy_name):
    det, engine = _drift_engine_run(pipeline, policy_name, port=True)
    jdet, jengine = _drift_engine_run(pipeline, policy_name, port=False)
    assert det == jdet                          # key for key
    assert det["recompiles"] == 0
    assert engine.tier_moves == jengine.tier_moves
    assert engine.counters() == jengine.counters()
    assert engine.request_summary() == jengine.request_summary()
    assert engine.tier_counters() == jengine.tier_counters()
    if policy_name == "decay":
        assert det["promotions"] > 0 and det["writebacks"] > 0
        assert engine.tier_moves["promotions"] == det["promotions"]
    else:
        assert det["promotions"] == 0


def test_engine_drift_replay_deterministic_and_adaptive_wins(pipeline):
    a, _ = _drift_engine_run(pipeline, "decay", port=True)
    b, _ = _drift_engine_run(pipeline, "decay", port=True)
    assert a == b
    s, _ = _drift_engine_run(pipeline, "static", port=True)
    hr = lambda d: d["hot_lookups"] / (d["hot_lookups"] + d["cold_lookups"])  # noqa: E731
    assert hr(a) > hr(s)


# -- pressure adapter: live counters -> precision repack ----------------------

def test_pressure_adapter_assignments_equal_reference(pipeline):
    from repro.data.synthetic import SyntheticCTR
    from repro.launch import serve as jlaunch
    from repro.serve import PressureAdapter as JPressureAdapter
    from repro_torch.launch import serve as launch

    spec, res = pipeline["spec"], pipeline["res"]
    freqs = SyntheticCTR(spec).expected_frequencies()
    meta = res["packed_meta"]
    store = TieredTableStore(to_torch(pipeline["table_np"], "cpu"), meta,
                             freqs, 0.1, device="cpu")
    jstore = JStore(res["packed_table"], meta, freqs, 0.1)
    params, state, buffers = pipeline["port"]
    engine = launch.build_engine(pipeline["cfg"], params, state, buffers,
                                 p99_rows=64, bulk_rows=128, store=store,
                                 device="cpu")
    jengine = jlaunch.build_engine(pipeline["jcfg"], *pipeline["ref"],
                                   p99_rows=64, bulk_rows=128, store=jstore)
    port_res = {"packed_meta": meta, "group_bits": np.asarray(
        res["group_bits"]), "final_params": {"embedding": {
            k: np.array(v) for k, v in
            res["final_params"]["embedding"].items()}}}
    planner, swapper = launch.repack_tools(engine, port_res, freqs)
    jplanner, jswapper = jlaunch.repack_tools(jengine, res, freqs)
    adapter = engine.attach_adapter(PressureAdapter(
        planner, swapper, res["group_bits"], every=1, promote_below=0.02,
        min_moved=1))
    jadapter = jengine.attach_adapter(JPressureAdapter(
        jplanner, jswapper, res["group_bits"], every=1, promote_below=0.02,
        min_moved=1))
    # cold-heavy traffic: a tiny hot tier makes the miss share dominate
    ids = SyntheticCTR(spec._replace(batch_size=128)).batch(77_777)["ids"]
    engine.score_tiered(ids)
    jengine.score_tiered(ids)
    compiles0 = engine.compile_count
    engine.sched_step()                 # adapter plans from the live window
    jengine.sched_step()
    assert adapter.repacks == jadapter.repacks == 1
    np.testing.assert_array_equal(adapter.assignment, jadapter.assignment)
    assert adapter.base_bytes == jadapter.base_bytes
    assert planner.bytes_packed(adapter.assignment) < adapter.base_bytes
    engine.sched_step()                 # queued swap lands atomically
    jengine.sched_step()
    assert engine.swaps_applied == jengine.swaps_applied >= 1
    assert engine.compile_count == compiles0
    same_routing(store, jstore)
    # the tiered cells score the swapped table: the monolithic cells' scores
    # (swapped in place too) and the reference's tiered ones
    probe = SyntheticCTR(spec._replace(batch_size=200)).batch(88_888)["ids"]
    tiered = engine.score_tiered(probe, return_logits=True)
    np.testing.assert_allclose(tiered, engine.score(probe, return_logits=True),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tiered, jengine.score_tiered(probe, return_logits=True),
        rtol=3e-5, atol=3e-5)
