"""Port parity for serving-time precision adaptation: the planner's
assignments and byte math equal the reference's; the swapper's table is
bit-equal to the reference's ``build_packed_table`` at the same pinned
capacities; a swap lands at the round boundary with zero recompiles,
in place, and scores after it equal a fresh engine's on the new table; a
swap writes the engine's copy of the table, never the caller's, and is
refused while a twin engine shares that copy; a swap that would change
the layout, or that targets no cell, raises."""
import numpy as np
import pytest
import torch

from repro.core.inference import build_packed_table as jbuild_packed_table
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.serve import repack as jrepack
from repro_torch.configs.dlrm_criteo import make_config
from repro_torch.core.inference import build_packed_table
from repro_torch.core.mpe import MPEConfig
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.models.dlrm import DLRM
from repro_torch.launch.serve import (build_engine, build_packed_dlrm,
                                      packed_master, repack_tools)
from repro_torch.serve import Engine, repack
from repro_torch.train.tree import leaves

BITS = MPEConfig().bits


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread a test worker: the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planners(rng, n_groups=24, group_size=5, d=8):
    gof = np.repeat(np.arange(n_groups, dtype=np.int32), group_size)
    rng.shuffle(gof)
    n = gof.size
    meta = {"bits": BITS, "d": d, "n": n}
    caps = {f"b{b}": int(rng.integers(n // 6, n)) for b in BITS if b}
    freqs = rng.zipf(1.3, n).astype(np.float64) if rng.random() < 0.7 \
        else None
    return (repack.RepackPlanner(meta, gof, caps, frequencies=freqs),
            jrepack.RepackPlanner(meta, gof, caps, frequencies=freqs))


def same_plan(a, b):
    np.testing.assert_array_equal(a.group_bits_idx, b.group_bits_idx)
    np.testing.assert_array_equal(a.feature_bits_idx, b.feature_bits_idx)
    assert a.feature_bits_idx.dtype == b.feature_bits_idx.dtype
    assert (a.bytes_packed, a.bytes_before, a.n_features_moved) == \
        (b.bytes_packed, b.bytes_before, b.n_features_moved)


@pytest.mark.parametrize("seed", range(8))
def test_planner_assignments_equal_reference(seed):
    rng = np.random.default_rng(seed)
    port, ref = planners(rng)
    for _ in range(4):
        assign = rng.integers(0, len(BITS), port.n_groups).astype(np.int32)
        assert port.bytes_packed(assign) == ref.bytes_packed(assign)
        np.testing.assert_array_equal(port.bucket_counts(assign),
                                      ref.bucket_counts(assign))
        assert port.capacity_ok(assign) == ref.capacity_ok(assign)
        budget = int(port.bytes_packed(assign) * rng.uniform(0.0, 1.2))
        same_plan(port.plan_budget(assign, budget),
                  ref.plan_budget(assign, budget))
        counters = {"hot_lookups": int(rng.integers(0, 100)),
                    "cold_lookups": int(rng.integers(0, 100))}
        shrink = float(rng.uniform(0.1, 0.9))
        same_plan(port.plan_pressure(assign, counters, max_shrink=shrink),
                  ref.plan_pressure(assign, counters, max_shrink=shrink))
        same_plan(port.plan_promote(assign, bytes_budget=budget),
                  ref.plan_promote(assign, bytes_budget=budget))


@pytest.mark.parametrize("n,fraction,multiple", [(100, 0.5, 8), (8000, 0.3, 8),
                                                 (37, 0.9, 16)])
def test_headroom_capacities_equal_reference(n, fraction, multiple):
    meta = {"bits": BITS, "d": 16, "n": n}
    assert repack.headroom_capacities(meta, fraction=fraction,
                                      multiple=multiple) == \
        jrepack.headroom_capacities(meta, fraction=fraction,
                                    multiple=multiple)


def master(rng, n=900, d=16):
    emb = rng.normal(0, 3e-3, (n, d)).astype(np.float32)
    alpha = rng.uniform(5e-4, 2e-3, len(BITS)).astype(np.float32)
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    fb = rng.integers(0, len(BITS), n).astype(np.int32)
    return emb, alpha, beta, fb


@pytest.mark.parametrize("fraction", [0.3, 0.5, 1.0])
def test_swapper_table_equals_reference_build(fraction, rng):
    emb, alpha, beta, fb = master(rng)
    caps = repack.headroom_capacities({"bits": BITS, "d": 16, "n": 900},
                                      fraction=fraction)
    fits = all((fb == i).sum() <= caps[f"b{b}"] for i, b in enumerate(BITS)
               if b)
    swapper = repack.TableSwapper(None, emb, alpha, beta, MPEConfig(),
                                  capacities=caps)
    if not fits:
        with pytest.raises(ValueError, match="pinned capacity"):
            swapper.build(fb)
        return
    table, meta = swapper.build(fb)
    want, jmeta = jbuild_packed_table(emb, fb, alpha, beta, JMPEConfig(),
                                      row_capacities=caps)
    assert meta == {**jmeta, "bits": tuple(jmeta["bits"])}
    assert repack.subtable_capacities(table) == \
        jrepack.subtable_capacities(want) == caps
    for k, sub in want["subtables"].items():
        np.testing.assert_array_equal(table["subtables"][k].numpy(),
                                      np.asarray(sub).view(np.int32))
    for k in ("local_idx", "width_idx", "alpha", "beta"):
        np.testing.assert_array_equal(table[k].numpy(), np.asarray(want[k]))


def served(headroom=0.5):
    """The reduced DLRM's random packed table, repacked with headroom
    from its master, behind a CPU engine with 64/256-row cells."""
    cfg = make_config(reduced=True)
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=2,
                                                     device="cpu")
    res = packed_master(cfg, seed=2, device="cpu")
    emb = res["final_params"]["embedding"]
    fb = torch.from_numpy(res["feature_bits_idx"])
    rebuilt, _ = build_packed_table(emb["emb"], fb, emb["alpha"],
                                    emb["beta"], MPEConfig())
    for a, b in zip(leaves(rebuilt), leaves(params["embedding"])):
        assert torch.equal(a, b)     # the master is the table's own
    params["embedding"], _ = build_packed_table(
        emb["emb"], fb, emb["alpha"], emb["beta"], MPEConfig(),
        row_capacities=repack.headroom_capacities(res["packed_meta"],
                                                  fraction=headroom))
    engine = build_engine(cfg, params, state, buffers, p99_rows=64,
                          bulk_rows=256, device="cpu")
    freqs = SyntheticCTR(spec).expected_frequencies()
    planner, swapper = repack_tools(engine, res, freqs)
    ids = SyntheticCTR(spec._replace(batch_size=40)).batch(50_000)["ids"]
    return {"cfg": cfg, "model": (params, state, buffers), "res": res,
            "engine": engine, "planner": planner, "swapper": swapper,
            "ids": ids}


def budget_plan(s, fraction=0.6):
    gbits = np.asarray(s["res"]["group_bits"])
    return s["planner"].plan_budget(
        gbits, int(s["planner"].bytes_packed(gbits) * fraction))


def test_swap_lands_at_the_round_boundary_with_zero_recompiles():
    s = served()
    engine, ids = s["engine"], s["ids"]
    old = engine.score(ids, return_logits=True)
    live = engine.live_packed_table()
    ptrs = [t.data_ptr() for t in leaves(live)]
    compiles = engine.compile_count
    plan = budget_plan(s)
    assert plan.n_features_moved > 0
    t_a = engine.submit(ids)
    engine.sched_step()                          # dispatches A: old table
    summary = s["swapper"].repack(plan)          # queued, not applied
    assert engine.swaps_applied == 0
    t_b = engine.submit(ids)
    engine.drain()                               # the swap, then B
    a, b = engine.poll(t_a), engine.poll(t_b)
    np.testing.assert_array_equal(a, old)
    assert not np.array_equal(a, b)
    assert engine.compile_count == compiles and engine.swaps_applied == 1
    assert summary["bytes_packed"] < summary["bytes_before"]
    assert [t.data_ptr() for t in leaves(live)] == ptrs    # in place

    # a fresh engine on the new table scores the same bits
    new_table, _ = s["swapper"].build(plan.feature_bits_idx)
    params, state, buffers = s["model"]
    fresh = build_engine(s["cfg"], dict(params, embedding=new_table), state,
                         buffers, p99_rows=64, bulk_rows=256, device="cpu")
    np.testing.assert_array_equal(fresh.score(ids, return_logits=True), b)

    # and the identical assignment swaps the original table back, bit-exact
    s["swapper"].repack(np.asarray(s["res"]["feature_bits_idx"]))
    engine.sched_step()
    np.testing.assert_array_equal(engine.score(ids, return_logits=True), old)


def test_swap_keeps_the_callers_table_and_refuses_a_twin():
    s = served()
    engine, ids = s["engine"], s["ids"]
    params, state, buffers = s["model"]
    caller = [t.clone() for t in leaves(params["embedding"])]
    live = engine.live_packed_table()
    assert not any(a.data_ptr() == b.data_ptr() for a, b in
                   zip(leaves(live), leaves(params["embedding"])))
    old = engine.score(ids, return_logits=True)
    twin = Engine(cache=engine.cache, device="cpu")
    twin.register_packed_model("dlrm", DLRM, s["cfg"], params, state,
                               buffers, shapes={"serve_p99": 64,
                                                "serve_bulk": 256})
    assert engine.compile_count == 4            # the twin's cells are hits
    assert all(a is b for a, b in zip(leaves(twin.live_packed_table()),
                                      leaves(live)))
    plan = budget_plan(s)
    s["swapper"].repack(plan)
    with pytest.raises(ValueError, match="1 other engine"):
        engine.sched_step()
    assert engine.swaps_applied == 0
    np.testing.assert_array_equal(twin.score(ids, return_logits=True), old)
    del twin                                    # alone now: the swap lands
    s["swapper"].repack(plan)
    engine.sched_step()
    assert engine.swaps_applied == 1
    assert not np.array_equal(engine.score(ids, return_logits=True), old)
    for a, b in zip(leaves(params["embedding"]), caller):
        assert torch.equal(a, b)                # the caller's table as it was
    fresh = build_engine(s["cfg"], params, state, buffers, p99_rows=64,
                         bulk_rows=256, device="cpu")
    np.testing.assert_array_equal(fresh.score(ids, return_logits=True), old)


def test_swap_rejects_a_layout_change():
    s = served()
    emb = s["res"]["final_params"]["embedding"]
    fat = repack.headroom_capacities(s["res"]["packed_meta"], fraction=0.9)
    table, meta = build_packed_table(
        emb["emb"], torch.from_numpy(s["res"]["feature_bits_idx"]),
        emb["alpha"], emb["beta"], MPEConfig(), row_capacities=fat)
    before = [t.clone() for t in leaves(s["engine"].live_packed_table())]
    s["engine"].request_swap(table, meta)
    with pytest.raises(ValueError, match="compiled .* layout"):
        s["engine"].sched_step()
    for a, b in zip(leaves(s["engine"].live_packed_table()), before):
        assert torch.equal(a, b)          # nothing was written


def test_swap_without_target_cell_raises():
    engine = Engine(device="cpu")
    engine.request_swap({"subtables": {}}, {"bits": (0, 8), "d": 4, "n": 4})
    with pytest.raises(ValueError, match="no registered cell"):
        engine.sched_step()
