"""The port's distribution layer in one process: the mesh, the placement
contract, the integer routing plans and the local bodies.

  - ``repro_torch.dist.sharding``: every spec family gives the reference's
    specs for the same shapes, entry for entry (``lm_batch_pspecs`` and
    ``lm_cache_pspecs`` are ported as the contract only and not tested
    here: the reference's own test of them fails);
  - ``repro_torch.dist.mesh``: the host mesh of one process is 1×1,
    ``parse_mesh_flag`` rejects garbage and meshes larger than the world,
    ``init_distributed`` is a no-op without a coordinator;
  - the a2a plans (``plan_buckets``, ``spill_capacity``, ``_cap_slice``,
    ``lookup_route_stats``) are bit-identical to ``repro``'s over a seeded
    property sweep, at all-one-owner overflow and at the spill bound (the
    sweep of the reference's ``tests/test_shard_a2a.py``);
  - the lookups on a ``LocalMesh`` (every rank's body in turn, the
    collectives replaced by what they compute) and the bag's local bodies
    (``bag_partial``/``bag_grad_local``), against the reference's jitted
    single-device functions: the lookups bit for bit, the bag within atol
    1e-6 (forward) and 2e-5 (gradient);
  - ALPT's projection of row shards: bit-identical to the whole table's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import TieredTableStore as JStore
from repro.cache.tiers import tiered_hot_lookup as j_tiered_hot_lookup
from repro.core.inference import build_packed_table as j_build
from repro.core.inference import packed_lookup as j_packed_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.dist import shard as jshard
from repro.dist import sharding as jsharding
from repro.embeddings.frequency import zipf_frequencies
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag
from repro_torch.cache.tiers import TieredTableStore
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import shard, sharding
from repro_torch.interop import to_torch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serve.cache import mesh_signature

SDS = jax.ShapeDtypeStruct


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(shape):
    return torch.empty(shape, device="meta")


def _spec_pairs(got, want, path=""):
    """(path, port spec, reference spec), matched by key."""
    if isinstance(got, dict):
        assert set(got) == set(want), path
        return [x for k in got
                for x in _spec_pairs(got[k], want[k], f"{path}/{k}")]
    return [(path, got, want)]


def _norm(spec) -> tuple:
    """A spec's entries normalized (the reference's spec type folds a
    one-axis tuple into the axis name)."""
    return tuple(sharding.normalize_entry(e) for e in spec)


def assert_same_specs(got, want):
    for path, g, w in _spec_pairs(got, want):
        assert isinstance(g, sharding.P), path
        assert _norm(g) == _norm(w), (path, g, w)


# ---------------------------------------------------------------------------
# the placement contract
# ---------------------------------------------------------------------------

def test_contract_constants_are_the_reference_s():
    assert sharding.PROD_AXIS_SIZE == jsharding.PROD_AXIS_SIZE
    assert sharding.MESH_AXES == jsharding.MESH_AXES
    assert sharding.AXIS_GROUPS == jsharding.AXIS_GROUPS
    assert set(sharding.SPEC_FAMILIES) == set(jsharding.SPEC_FAMILIES)


@pytest.mark.parametrize("entry", [None, "data", ("data",), ("pod", "data"),
                                   ("model", "data"), ("pod", "model"),
                                   ("data", "model"), ("bogus",)])
def test_normalize_and_contract_match_reference(entry):
    assert sharding.normalize_entry(entry) == jsharding.normalize_entry(entry)
    spec = (entry, None)
    assert sharding.spec_in_contract(spec) == jsharding.spec_in_contract(spec)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dp_axes_match_reference(multi_pod):
    assert sharding.dp_axes(multi_pod) == jsharding.dp_axes(multi_pod)
    assert sharding.current_dp_axes() is None


def test_lm_param_pspecs_match_reference():
    shapes = {"layers": {"attn": {"wq": {"kernel": (64, 5120, 8192)}},
                         "ln_attn": {"scale": (64, 5120)}},
              "lm_head": (5120, 151936), "ln_f": {"scale": (5120,)},
              "embedding": {"emb": (151936, 5120)}, "odd": (7, 9),
              "mixed": (48, 30)}

    def build(tree, leaf):
        if isinstance(tree, dict):
            return {k: build(v, leaf) for k, v in tree.items()}
        return leaf(tree)
    got = sharding.lm_param_pspecs(build(shapes, _meta))
    want = jsharding.lm_param_pspecs(
        build(shapes, lambda s: SDS(s, jnp.float32)))
    assert_same_specs(got, want)
    assert tuple(got["lm_head"]) == ("data", "model")


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("vocab_sharded", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("dp", [None, ("data",), ("pod", "data")])
def test_lm_logits_pspecs_match_reference(batch, vocab_sharded, multi_pod,
                                          dp):
    kw = dict(vocab_sharded=vocab_sharded, dp=dp, multi_pod=multi_pod)
    assert _norm(sharding.lm_logits_pspecs(batch, **kw)) \
        == _norm(jsharding.lm_logits_pspecs(batch, **kw))


@pytest.mark.parametrize("rows_axes", [("model",), ("pod", "model")])
def test_recsys_table_pspecs_match_reference(rows_axes):
    assert_same_specs(sharding.recsys_table_pspecs(rows_axes),
                      jsharding.recsys_table_pspecs(rows_axes))
    shapes = {"emb": (64, 8), "gamma": (4, 7), "alpha": (7,), "beta": (8,),
              "extra": (3, 2, 2)}
    got = sharding.recsys_table_pspecs(
        rows_axes, {k: _meta(s) for k, s in shapes.items()})
    want = jsharding.recsys_table_pspecs(
        rows_axes, {k: SDS(s, jnp.float32) for k, s in shapes.items()})
    assert_same_specs(got, want)


def _tables():
    sub = {"b2": (512, 1), "b4": (1024, 2)}
    port = {"subtables": {k: _meta(s) for k, s in sub.items()},
            "local_idx": _meta((9,)), "width_idx": _meta((9,)),
            "alpha": _meta((3,)), "beta": _meta((8,))}
    ref = {"subtables": {k: SDS(s, jnp.uint32) for k, s in sub.items()},
           "local_idx": SDS((9,), jnp.int32),
           "width_idx": SDS((9,), jnp.int32),
           "alpha": SDS((3,), jnp.float32), "beta": SDS((8,), jnp.float32)}
    return port, ref


@pytest.mark.parametrize("rows_axes", [("model",), ("pod", "model")])
def test_packed_families_match_reference(rows_axes):
    port, ref = _tables()
    assert_same_specs(sharding.packed_table_pspecs(port, rows_axes=rows_axes),
                      jsharding.packed_table_pspecs(ref, rows_axes=rows_axes))
    assert_same_specs(sharding.host_packed_table_pspecs(port),
                      jsharding.host_packed_table_pspecs(ref))
    hot_p = dict(port, tier_local=_meta((9,)), is_hot=_meta((9,)))
    hot_r = dict(ref, tier_local=SDS((9,), jnp.int32),
                 is_hot=SDS((9,), bool))
    assert_same_specs(sharding.tiered_hot_pspecs(hot_p, rows_axes=rows_axes),
                      jsharding.tiered_hot_pspecs(hot_r, rows_axes=rows_axes))
    params_p = {"embedding": port, "wide": _meta((9,)),
                "mlp": {"kernel": _meta((8, 4)), "bias": _meta((4,))}}
    params_r = {"embedding": ref, "wide": SDS((9,), jnp.float32),
                "mlp": {"kernel": SDS((8, 4), jnp.float32),
                        "bias": SDS((4,), jnp.float32)}}
    assert_same_specs(
        sharding.packed_serve_pspecs(params_p, rows_axes=rows_axes),
        jsharding.packed_serve_pspecs(params_r, rows_axes=rows_axes))


@pytest.mark.parametrize("shape,spec", [
    ((64, 8), ("model", None)), ((63, 8), ("model", None)),
    ((64, 8), (("data", "model"), None)), ((6, 8), (("data", "model"),)),
    ((64,), ("pod",)), ((8, 8), (None, "data"))])
def test_fit_spec_matches_reference(shape, spec):
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    got = sharding._fit_spec(shape, sharding.P(*spec), mesh)
    want = jsharding._fit_spec(shape, jsharding.P(*spec), mesh)
    assert tuple(got) == tuple(want)


def test_in_model_constraints_are_identities_and_specs_replicate():
    x = torch.ones(4, 3)
    assert sharding.maybe_shard(x, sharding.P("data")) is x
    assert sharding.shard_batch_dim(x) is x
    tree = {"a": torch.ones(2, 3), "b": [torch.ones(4)], "c": torch.ones(())}
    got = sharding.replicate_like(tree)
    assert tuple(got["a"]) == (None, None) and tuple(got["b"][0]) == (None,)
    assert tuple(got["c"]) == ()


def test_named_shardings_give_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = dmesh.host_mesh(1, 1)
    specs = {"rows": sharding.P("model", None),
             "both": sharding.P(("data", "model"), None),
             "cols": sharding.P(None, "data"), "none": sharding.P()}
    got = sharding.tree_named_shardings(mesh, specs)
    assert got["rows"].placements == (Replicate(), Shard(0))
    assert got["both"].placements == (Shard(0), Shard(0))
    assert got["cols"].placements == (Shard(1), Replicate())
    assert got["none"].placements == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_one_process_mesh_is_one_by_one():
    mesh = dmesh.host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.axis_index(("data", "model")) == 0
    assert mesh.group(("model",)) is None and mesh.device_mesh is None
    assert shard.active_mesh(mesh) is None and shard.active_mesh() is None
    pod = dmesh.host_mesh(1, 1, n_pod=1)
    assert pod.axis_names == ("pod", "data", "model")
    assert mesh_signature(mesh).startswith("1x1:data,model:")


def test_use_mesh_nests():
    outer, inner = dmesh.host_mesh(1, 1), dmesh.host_mesh(1, 1, n_pod=1)
    assert dmesh.current_mesh() is None
    with dmesh.use_mesh(outer):
        with dmesh.use_mesh(inner):
            assert dmesh.current_mesh() is inner
            assert sharding.current_dp_axes() is None   # one rank
        assert dmesh.current_mesh() is outer
    assert dmesh.current_mesh() is None


@pytest.mark.parametrize("flag", ["x", "2", "2,2,2,2", "a,b", "0,1", "2,-1"])
def test_parse_mesh_flag_rejects_garbage(flag):
    with pytest.raises(SystemExit, match="--mesh expects"):
        dmesh.parse_mesh_flag(flag)


@pytest.mark.parametrize("flag", ["2,2", "1,4", "2,1,2"])
def test_parse_mesh_flag_rejects_a_mesh_larger_than_the_world(flag):
    with pytest.raises(SystemExit, match="needs 4 ranks, 1 running"):
        dmesh.parse_mesh_flag(flag)


def test_parse_mesh_flag_rejects_a_mesh_smaller_than_the_world(
        monkeypatch):
    monkeypatch.setattr(dmesh, "world_size", lambda: 4)
    with pytest.raises(SystemExit, match="must hold every rank"):
        dmesh.parse_mesh_flag("1,2")


def test_cell_cache_runs_sharded_cells_eager_on_a_multi_rank_mesh():
    """A cell whose step holds collectives is eager on a mesh of more than
    one rank, and a graph on the card otherwise."""
    from repro_torch.serve.cache import CellCache
    two_by_two = types.SimpleNamespace(size=4, devices=np.zeros((2, 2)),
                                       axis_names=("data", "model"),
                                       device_type="cpu")
    cache = CellCache("cpu", mesh=two_by_two)
    assert cache.eager({"shard_lookup": True})
    assert not cache.eager({"shard_lookup": False}) and not cache.eager({})
    assert cache.key("dlrm", "p99").mesh_sig == "2x2:data,model:cpu"
    one = CellCache("cpu")
    assert not one.eager({"shard_lookup": True})
    assert one.key("dlrm", "p99").mesh_sig.startswith("1x1:data,model:")


def test_parse_mesh_flag_builds_the_host_mesh():
    assert dmesh.parse_mesh_flag(None) is None
    assert dmesh.parse_mesh_flag("") is None
    assert dmesh.parse_mesh_flag("auto").shape == {"data": 1, "model": 1}
    assert dmesh.parse_mesh_flag("1,1").shape == {"data": 1, "model": 1}
    assert dmesh.parse_mesh_flag("1,1,1").axis_names == ("pod", "data",
                                                         "model")


def test_production_mesh_is_a_function_needing_its_ranks():
    with pytest.raises(ValueError, match="256-rank mesh"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512-rank mesh"):
        make_production_mesh(multi_pod=True)


def test_init_distributed_is_a_no_op_without_a_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dmesh.init_distributed() is False
    assert dmesh.init_distributed(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="need a coordinator"):
        dmesh.init_distributed(num_processes=4)
    with pytest.raises(ValueError, match="process count"):
        dmesh.init_distributed("localhost:1")
    assert dmesh.host_boundary_groups() == [[0]]


# ---------------------------------------------------------------------------
# the integer plans
# ---------------------------------------------------------------------------

_j_plan = jax.jit(jshard.plan_buckets, static_argnames=("n_shards",
                                                         "capacity"))


def check_plan(owner, valid, n_shards, capacity):
    """The BucketPlan contract, and every field bit-identical to
    ``repro``'s plan of the same instance."""
    plan = shard.plan_buckets(owner, valid, n_shards=n_shards,
                              capacity=capacity)
    want = _j_plan(jnp.asarray(owner), jnp.asarray(valid),
                   n_shards=n_shards, capacity=capacity)
    for name in ("slot", "in_bucket", "spilled", "counts"):
        got, w = getattr(plan, name).numpy(), np.asarray(getattr(want, name))
        assert got.shape == w.shape, name
        np.testing.assert_array_equal(got, w, err_msg=name)
    inb, spl = plan.in_bucket.numpy(), plan.spilled.numpy()
    # no drop, no dup: every valid id is bucketed XOR spilled
    assert not (inb & spl).any()
    np.testing.assert_array_equal(inb | spl, valid)
    o2 = np.asarray(owner).reshape(-1, np.shape(owner)[-1])
    i2 = inb.reshape(o2.shape)
    s2 = plan.slot.numpy().reshape(o2.shape)
    for sl in range(o2.shape[0]):
        used = s2[sl][i2[sl]]
        assert len(set(used.tolist())) == len(used)
        np.testing.assert_array_equal(used // capacity, o2[sl][i2[sl]])
    per_slice = spl.reshape(o2.shape).sum(-1)
    assert (per_slice <= shard.spill_capacity(o2.shape[-1], capacity,
                                              n_shards)).all()


def test_plan_buckets_property_sweep_matches_reference():
    rng = np.random.default_rng(11)
    for _ in range(40):
        n_shards = int(rng.integers(2, 5))
        slice_len = int(rng.integers(1, 24))
        n_slices = int(rng.integers(1, 4))
        capacity = int(rng.integers(1, slice_len + 1))
        shape = (n_slices, slice_len) if n_slices > 1 else (slice_len,)
        owner = rng.integers(0, n_shards, size=shape).astype(np.int32)
        valid = rng.random(shape) < rng.choice([0.3, 0.8, 1.0])
        check_plan(owner, valid, n_shards, capacity)


def test_plan_buckets_all_one_owner_overflow():
    owner = np.zeros((2, 9), np.int32)
    valid = np.ones((2, 9), bool)
    check_plan(owner, valid, 4, 1)
    plan = shard.plan_buckets(owner, valid, n_shards=4, capacity=1)
    assert int(plan.in_bucket.sum()) == 2 and int(plan.spilled.sum()) == 16


@pytest.mark.parametrize("args", [(16, 16, 4), (16, 4, 4), (3, 8, 2),
                                  (9, 1, 4), (1, 1, 1), (24, 0, 3)])
def test_spill_capacity_matches_reference(args):
    assert shard.spill_capacity(*args) == jshard.spill_capacity(*args)


@pytest.mark.parametrize("batch", [1, 7, 72, 300])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("cap", [None, 1, 4, 1000])
def test_cap_slice_matches_reference(batch, n_shards, cap):
    assert shard._cap_slice(batch, n_shards, cap) \
        == jshard._cap_slice(batch, n_shards, cap)


def _random_table(n=150, d=12, seed=7, row_pad_multiple=1):
    rng = np.random.default_rng(seed)
    cfg = JMPEConfig()
    emb = rng.normal(size=(n, d)).astype(np.float32)
    fbits = rng.integers(0, len(cfg.bits), size=n).astype(np.int32)
    alpha = (np.abs(rng.normal(size=len(cfg.bits))) * 0.1
             + 0.01).astype(np.float32)
    beta = (rng.normal(size=d) * 0.01).astype(np.float32)
    table, meta = j_build(emb, fbits, alpha, beta, cfg,
                          row_pad_multiple=row_pad_multiple)
    return table, to_torch(jax.tree.map(np.asarray, table), "cpu"), meta


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("cap", [None, 4, 1])
def test_lookup_route_stats_match_reference(n_shards, cap):
    table, t_table, meta = _random_table()
    ids = np.random.default_rng(3).integers(0, meta["n"], 64).astype(np.int32)
    got = shard.lookup_route_stats(t_table, meta, torch.from_numpy(ids),
                                   n_shards=n_shards, bucket_capacity=cap)
    want = jshard.lookup_route_stats(table, meta, jnp.asarray(ids),
                                     n_shards=n_shards, bucket_capacity=cap)
    assert got == want
    assert got["routed"] == got["bucketed"] + got["spilled"]


@pytest.mark.parametrize("rows,n", [(10, 4), (12, 4), (1, 3), (7, 1)])
def test_row_blocks_are_the_padded_table_s(rows, n):
    x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    padded = shard.pad_rows_to_shard(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jshard.pad_rows_to_shard(jnp.asarray(x),
                                                            n)))
    blocks = [shard.local_row_block(torch.from_numpy(x), s, n)
              for s in range(n)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), padded.numpy())


# ---------------------------------------------------------------------------
# the local bodies, every shard in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("comms,cap", [("psum", None), ("a2a", None),
                                       ("a2a", 4), ("a2a", 1)])
def test_all_shards_lookup_bit_exact(n_shards, comms, cap):
    """Every row shard's body in one process (a ``LocalMesh`` of one and
    of two data slices), through ``sharded_packed_lookup`` itself."""
    table, t_table, meta = _random_table()
    ids = np.random.default_rng(5).integers(0, meta["n"], 72).astype(np.int32)
    want = np.asarray(jax.jit(lambda t, i: j_packed_lookup(t, meta, i))(
        table, ids))
    for n_data in (1, 2):
        got = shard.sharded_packed_lookup(
            t_table, meta, torch.from_numpy(ids),
            mesh=shard.LocalMesh(n_data, n_shards), lookup_comms=comms,
            bucket_capacity=cap)
        np.testing.assert_array_equal(got.numpy(), want)


def test_local_mesh_takes_no_row_blocks():
    _, t_table, meta = _random_table()
    with pytest.raises(ValueError, match="whole table"):
        shard.sharded_packed_lookup(t_table, meta, torch.zeros(4, dtype=
                                                                torch.int32),
                                    mesh=shard.LocalMesh(1, 2),
                                    row_blocks=True)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("comms,cap", [("psum", None), ("a2a", 1)])
def test_all_shards_tiered_hot_lookup_bit_exact(n_shards, comms, cap):
    table, t_table, meta = _random_table()
    freqs = zipf_frequencies(meta["n"], seed=1)
    jstore = JStore(table, meta, freqs, 0.4)
    store = TieredTableStore(t_table, meta, freqs, 0.4, device="cpu")
    ids = np.random.default_rng(6).integers(0, meta["n"], 40).astype(np.int32)
    want = np.asarray(jax.jit(lambda h, i: j_tiered_hot_lookup(
        h, meta["bits"], meta["d"], i))(jstore.hot, ids))
    got = shard.sharded_tiered_hot_lookup(
        store.hot, meta["bits"], meta["d"], torch.from_numpy(ids),
        mesh=shard.LocalMesh(1, n_shards), lookup_comms=comms,
        bucket_capacity=cap)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_bag_local_bodies_sum_to_the_bag(n_shards):
    rng = np.random.default_rng(9)
    tab = rng.normal(0, 1, (101, 16)).astype(np.float32)
    ids = rng.integers(0, 101, (8, 5)).astype(np.int32)
    mask = rng.random((8, 5)) < 0.8
    g = rng.normal(0, 1, (8, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: j_bag(t, ids, mask), tab)
    t_tab = torch.from_numpy(tab)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    rows_loc = -(-101 // n_shards)
    got = sum(shard.bag_partial(shard.local_row_block(t_tab, s, n_shards),
                                t_ids, t_mask, s) for s in range(n_shards))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=0,
                               atol=1e-6)
    grad = torch.cat([shard.bag_grad_local(torch.from_numpy(g), t_ids, t_mask,
                                           s, rows_loc)
                      for s in range(n_shards)])[:101]
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(g)[0]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_alpt_projection_of_row_shards_is_the_whole_tables(n_shards,
                                                           monkeypatch):
    """Each shard, projected from a generator seeded as the whole table's,
    takes the whole table's projection of its rows bit for bit — across
    chunk edges (chunks of 7 rows here)."""
    from repro_torch.core.baselines import alpt
    monkeypatch.setattr(alpt, "PROJECT_ROWS", 7)
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.normal(0, 0.1, (40, 6)).astype(np.float32))
    alpha = torch.tensor(0.01)
    whole = alpt.ALPT.project_(emb.clone(), alpha, 4,
                               torch.Generator().manual_seed(3))
    rows = 40 // n_shards
    for s in range(n_shards):
        block = emb[s * rows:(s + 1) * rows].clone()
        alpt.ALPT.project_(block, alpha, 4, torch.Generator().manual_seed(3),
                           row_shard=(s, n_shards))
        np.testing.assert_array_equal(block.numpy(),
                                      whole[s * rows:(s + 1) * rows].numpy())
