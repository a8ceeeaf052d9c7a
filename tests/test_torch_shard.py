"""The port's sharded kernels, train step and engines on gloo ranks.

This process computes the reference's outputs with JAX — each function
single-device and jitted, as the reference's ``tests/test_shard.py`` holds
its ``shard_map`` wrappers — and the port's own single-device outputs; then
it starts 4 gloo ranks (``torch_dist_ranks.run_world``), which import no
JAX, once per mesh shape and suite, and holds what every rank returns.
A 1×1 mesh takes the wrappers' single-device path, in this process.

Contract (the reference's ``tests/test_shard.py`` and
``tests/test_shard_a2a.py``):
  - the packed lookup (psum, and a2a at capacities none, 4 and 1) and the
    tiered hot lookup (psum and a2a): bit-identical to the reference's
    jitted single-device lookup — both its routes, the jnp lookup and the
    Pallas kernel in interpret mode — and to the port's, on 1×1, 1×4, 2×2,
    1×2×2 and 4×1; the packed lookup also over each rank's row blocks
    placed once (``place_table_rows``, ``row_blocks=True``);
  - flash attention and the QAT expectation, forward and gradients:
    bit-identical to the port's single-device kernels (dα and dβ, summed
    over ranks, within rtol 1e-5 / atol 1e-8); against the reference's
    single-device kernels within the tolerances the port's kernels hold on
    one device (flash 3e-5 forward, 5e-4 gradients; Eq. 9 rtol 1e-5 / atol
    1e-7 forward, rtol 1e-4 / atol 1e-6 gradients);
  - the bag: atol 1e-6 forward, rtol and atol 2e-5 gradients;
  - ``sharded_value_and_grad``: loss rtol 1e-6, gradients rtol 1e-4 /
    atol 1e-7 against the reference's jitted single-device
    ``value_and_grad``;
  - 8 ``Trainer(mesh=2×2)`` steps against the reference's single-device
    Trainer: losses rtol 1e-4, parameters rtol 2e-3 / atol 1e-5; a step's
    gradient norm (and so its clip scale) is the global one;
  - engines on 2×2: psum and a2a scores bit-identical to a 1×1 engine's,
    no recompile on repeated shapes, psum and a2a cells apart; the bound
    table only this rank's row blocks, and a swap's scores one device's;
  - ALPT's Trainer on 1×4 and 2×2, one step and its projection shard by
    shard, against the port's single-device Trainer under the same seed:
    loss rtol 1e-4, parameters rtol 2e-3 / atol 1e-5 (each rank draws the
    whole table's uniforms and projects its rows with theirs; uniforms
    drawn from each shard's start would move codes by a whole grid step).
The DLRMs of the train step run without BatchNorm, as the reference's
test does: data-parallel batch statistics are per rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import TieredTableStore as JStore
from repro.cache.tiers import tiered_hot_lookup as j_tiered_hot_lookup
from repro.core import quantizer as jquantizer
from repro.core.inference import build_packed_table as j_build
from repro.core.inference import packed_lookup as j_packed_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.embeddings.frequency import zipf_frequencies
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_bag
from repro.kernels.flash_attention.ops import flash_attention_kernel as j_flash
from repro.kernels.mpe_lookup.ops import packed_lookup_kernel as j_lookup_kernel
from repro.kernels.mpe_qat.ops import mixed_expectation_kernel as j_qat
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.cache.tiers import TieredTableStore
from repro_torch.dist import shard
from repro_torch.dist.mesh import host_mesh
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.serve.cells import packed_score_cell
from repro_torch.train.tree import leaves, unflatten
from torch_dist_ranks import alpt_trainer, run_world, suite_kernels

MESHES = [(1, 1), (1, 4), (2, 2), (1, 2, 2), (4, 1)]
LOOKUP_CASES = [(c, cap) for c in ("psum", "a2a") for cap in (None, 4, 1)]
TIERED_CASES = [("psum", None), ("a2a", None), ("a2a", 1)]
FLASH_FWD = dict(rtol=3e-5, atol=3e-5)
FLASH_GRAD = dict(rtol=5e-4, atol=5e-4)
QAT_FWD = dict(rtol=1e-5, atol=1e-7)
QAT_RED = dict(rtol=1e-4, atol=1e-6)
TRAIN_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers and the ranks share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def kernel_case():
    """The kernels' inputs as numpy, the reference's jitted single-device
    outputs on them, and the port's single-device outputs."""
    rng = np.random.default_rng(7)
    cfg = JMPEConfig()
    n, d = 150, 12
    emb = rng.normal(size=(n, d)).astype(np.float32)
    fbits = rng.integers(0, len(cfg.bits), size=n).astype(np.int32)
    alpha = (np.abs(rng.normal(size=len(cfg.bits))) * 0.1
             + 0.01).astype(np.float32)
    beta = (rng.normal(size=d) * 0.01).astype(np.float32)
    # one row of padding: odd subtable rows on every row split
    table, meta = j_build(emb, fbits, alpha, beta, cfg, row_pad_multiple=1)
    table_np = _np_tree(table)
    ids = rng.integers(0, n, size=(24, 3)).astype(np.int32)
    freqs = zipf_frequencies(n, seed=1)
    jstore = JStore(table, meta, freqs, 0.4)
    store = TieredTableStore(to_torch(table_np, "cpu"), meta, freqs, 0.4,
                             device="cpu")
    hot = {k: (v.numpy() if torch.is_tensor(v)
               else {s: t.numpy() for s, t in v.items()})
           for k, v in store.hot.items()}

    q = rng.normal(0, 1, (4, 32, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (4, 32, 2, 16)).astype(np.float32)    # GQA
    v = rng.normal(0, 1, (4, 32, 2, 16)).astype(np.float32)
    do = rng.normal(0, 1, (4, 32, 4, 16)).astype(np.float32)

    m = len(cfg.bits)
    logits = rng.normal(0, 1, (101, m)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    qat = {"rows": rng.normal(0, 3e-3, (101, 16)).astype(np.float32),
           "probs": probs,
           "alpha": np.asarray([jquantizer.init_alpha(3e-3, b)
                                for b in cfg.bits], np.float32),
           "beta": rng.normal(0, 1e-4, (16,)).astype(np.float32),
           "g": rng.normal(0, 1, (101, 16)).astype(np.float32),
           "bits": tuple(cfg.bits)}
    bag = {"table": rng.normal(0, 1, (101, 16)).astype(np.float32),
           "ids": rng.integers(0, 101, (8, 5)).astype(np.int32),
           "mask": rng.random((8, 5)) < 0.8,
           "g": rng.normal(0, 1, (8, 16)).astype(np.float32)}
    inputs = {"table": table_np, "meta": dict(meta), "ids": ids,
              "hot": hot, "flash": {"q": q, "k": k, "v": v, "do": do},
              "qat": qat, "bag": bag, "lookup_cases": LOOKUP_CASES,
              "tiered_cases": TIERED_CASES}

    ref = {"lookup": np.asarray(jax.jit(
        lambda t, i: j_packed_lookup(t, meta, i))(table, ids)),
        "lookup_pallas": np.asarray(j_lookup_kernel(
            table, meta, jnp.asarray(ids), interpret=True)),
        "tiered": np.asarray(jax.jit(lambda h, i: j_tiered_hot_lookup(
            h, meta["bits"], meta["d"], i))(jstore.hot, ids))}
    o, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, causal=True), q, k, v)
    ref["flash"] = (np.asarray(o), [np.asarray(g) for g in vjp(do)])
    e, vjp = jax.vjp(lambda r, p, a, b: j_qat(r, p, a, b, qat["bits"]),
                     *(qat[x] for x in ("rows", "probs", "alpha", "beta")))
    ref["qat"] = (np.asarray(e), [np.asarray(g) for g in vjp(qat["g"])])
    b, vjp = jax.vjp(lambda t: j_bag(t, bag["ids"], bag["mask"]),
                     bag["table"])
    ref["bag"] = (np.asarray(b), np.asarray(vjp(bag["g"])[0]))
    port = suite_kernels(host_mesh(1, 1), inputs)   # the single-device path
    return inputs, ref, port


@pytest.fixture(scope="module")
def kernel_worlds(kernel_case, tmp_path_factory):
    """Each mesh's ranks' outputs, one world a mesh, started on first use;
    the 1×1 mesh in this process."""
    inputs, _, port = kernel_case
    cache = {}

    def get(shape):
        if shape not in cache:
            if shape == (1, 1):
                cache[shape] = [port]
            else:
                tmp = tmp_path_factory.mktemp("kernels")
                cache[shape] = run_world("kernels", inputs, tmp, shape)
        return cache[shape]
    return get


@pytest.mark.parametrize("ref_use_kernel", [False, True])
@pytest.mark.parametrize("comms,cap", LOOKUP_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_packed_lookup_bit_exact(mesh, comms, cap, ref_use_kernel,
                                 kernel_case, kernel_worlds):
    """Against the reference's route ``ref_use_kernel``: its jitted jnp
    lookup, or its Pallas kernel in interpret mode."""
    _, ref, port = kernel_case
    want = ref["lookup_pallas" if ref_use_kernel else "lookup"]
    key = f"lookup/{comms}/{cap}"
    np.testing.assert_array_equal(port[key], want)
    for rank in kernel_worlds(mesh):
        np.testing.assert_array_equal(rank[key], want)


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_placed_row_blocks_lookup_bit_exact(mesh, kernel_case,
                                            kernel_worlds):
    """The lookup over each rank's row blocks, cut once: every case
    bit-identical, and each block the padded table's share of rows."""
    inputs, ref, _ = kernel_case
    mp = mesh[-1]
    for rank in kernel_worlds(mesh):
        for comms, cap in LOOKUP_CASES:
            np.testing.assert_array_equal(rank[f"placed/{comms}/{cap}"],
                                          ref["lookup"])
        assert rank["placed/rows"] == {
            k: -(-v.shape[0] // mp)
            for k, v in inputs["table"]["subtables"].items()}


@pytest.mark.parametrize("comms,cap", TIERED_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_tiered_hot_lookup_bit_exact(mesh, comms, cap, kernel_case,
                                     kernel_worlds):
    _, ref, _ = kernel_case
    for rank in kernel_worlds(mesh):
        np.testing.assert_array_equal(rank[f"tiered/{comms}/{cap}"],
                                      ref["tiered"])
        assert (rank[f"tiered/{comms}/{cap}"] == 0).all(-1).any()  # cold


@pytest.mark.parametrize("mesh", MESHES)
def test_flash_forward_bit_exact(mesh, kernel_case, kernel_worlds):
    _, ref, port = kernel_case
    for rank in kernel_worlds(mesh):
        for key in ("flash/fwd", "flash/o"):
            np.testing.assert_array_equal(rank[key], port["flash/o"])
        np.testing.assert_allclose(rank["flash/o"], ref["flash"][0],
                                   **FLASH_FWD)


@pytest.mark.parametrize("mesh", MESHES)
def test_flash_gradients_bit_exact(mesh, kernel_case, kernel_worlds):
    _, ref, port = kernel_case
    for rank in kernel_worlds(mesh):
        for got, mine, want in zip(rank["flash/grads"], port["flash/grads"],
                                   ref["flash"][1]):
            np.testing.assert_array_equal(got, mine)
            np.testing.assert_allclose(got, want, **FLASH_GRAD)


@pytest.mark.parametrize("mesh", MESHES)
def test_mixed_expectation_bit_exact(mesh, kernel_case, kernel_worlds):
    _, ref, port = kernel_case
    for rank in kernel_worlds(mesh):
        np.testing.assert_array_equal(rank["qat/fwd"], port["qat/fwd"])
        np.testing.assert_allclose(rank["qat/fwd"], ref["qat"][0], **QAT_FWD)


@pytest.mark.parametrize("mesh", MESHES)
def test_mixed_expectation_gradients(mesh, kernel_case, kernel_worlds):
    """drows and dprobs bit for bit (row-parallel); dα and dβ are sums over
    ranks, reassociated."""
    _, ref, port = kernel_case
    for rank in kernel_worlds(mesh):
        got, mine = rank["qat/grads"], port["qat/grads"]
        for i in (0, 1):
            np.testing.assert_array_equal(got[i], mine[i])
        for i in (2, 3):
            np.testing.assert_allclose(got[i], mine[i], rtol=1e-5,
                                       atol=1e-8)
        for g, want in zip(got, ref["qat"][1]):
            np.testing.assert_allclose(g, want, **QAT_RED)


@pytest.mark.parametrize("mesh", MESHES)
def test_embedding_bag_forward(mesh, kernel_case, kernel_worlds):
    _, ref, port = kernel_case
    for rank in kernel_worlds(mesh):
        np.testing.assert_allclose(rank["bag/fwd"], ref["bag"][0], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["bag/fwd"], port["bag/fwd"], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_embedding_bag_gradients(mesh, kernel_case, kernel_worlds):
    _, ref, _ = kernel_case
    for rank in kernel_worlds(mesh):
        assert rank["bag/grad"].shape == ref["bag"][1].shape
        np.testing.assert_allclose(rank["bag/grad"], ref["bag"][1],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh", MESHES[1:])
def test_ranks_sit_at_their_mesh_coordinates(mesh, kernel_worlds):
    coords = [tuple(r["coordinate"].values()) for r in kernel_worlds(mesh)]
    assert coords == [tuple(int(c) for c in np.unravel_index(i, mesh))
                      for i in range(4)]


# ---------------------------------------------------------------------------
# the train step and the Trainer
# ---------------------------------------------------------------------------

VOCABS = (300, 200)
TRAIN_MODELS = [("plain", (1, 4)), ("plain", (2, 2)), ("mpe_search", (2, 2))]


def _train_case(compressor):
    """A reference DLRM without BatchNorm (numpy trees), the same in the
    port, its loss in both packages, and the reference's data stream."""
    comp_cfg = (JMPEConfig(group_size=16, lam=3e-5)._asdict()
                if compressor == "mpe_search" else {})
    kw = dict(d_embed=8, mlp_hidden=(16,), backbone="dnn",
              use_batchnorm=False, compressor=compressor, comp_cfg=comp_cfg)
    jcfg = JDLRMConfig(fields=tuple(JFieldSpec(f"f{i}", v)
                                    for i, v in enumerate(VOCABS)), **kw)
    cfg = DLRMConfig(fields=tuple(FieldSpec(f"f{i}", v)
                                  for i, v in enumerate(VOCABS)), **kw)
    ds = JSyntheticCTR(JCTRSpec(field_vocabs=VOCABS, batch_size=64, seed=0))
    params, buffers, state = _np_tree(JDLRM.init(
        jax.random.PRNGKey(0), jcfg, ds.expected_frequencies()))
    lam = 3e-5 if compressor == "mpe_search" else 0.0

    def jloss(p, bu, st, batch, *, step=None):
        return JDLRM.loss_fn(p, bu, st, batch, jcfg, lam=lam, train=True,
                             step=step)

    model = {"vocabs": VOCABS, "d": 8, "hidden": (16,),
             "compressor": compressor, "comp_cfg": comp_cfg, "lam": lam,
             "params": params, "buffers": buffers, "state": state,
             "batch": 64, "seed": 0}
    return model, cfg, jloss, ds


def _port_tree(model, cfg, flat):
    """``flat`` (leaves in the port's order) as the port's param tree."""
    params, _, _ = model_from_numpy(model["params"], model["state"],
                                    model["buffers"], cfg, "cpu")
    return unflatten(params, [np.asarray(x) for x in flat])


def _pairs(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), path
        return [x for k in got for x in _pairs(got[k], want[k], f"{path}/{k}")]
    if isinstance(got, (list, tuple)):
        return [x for i, (g, w) in enumerate(zip(got, want))
                for x in _pairs(g, w, f"{path}/{i}")]
    return [(path, np.asarray(got), np.asarray(want))]


@pytest.fixture(scope="module")
def train_worlds(tmp_path_factory):
    cache = {}

    def get(compressor, shape):
        key = (compressor, shape)
        if key not in cache:
            model, cfg, jloss, ds = _train_case(compressor)
            tmp = tmp_path_factory.mktemp("train")
            outs = run_world("train", {"model": model,
                                       "train_steps": TRAIN_STEPS,
                                       "tight_clip": 1e-3,
                                       "ckpt_root": str(tmp)}, tmp, shape)
            cache[key] = (model, cfg, jloss, ds, outs)
        return cache[key]
    return get


@pytest.mark.parametrize("compressor,mesh", TRAIN_MODELS)
def test_sharded_value_and_grad_matches_reference(compressor, mesh,
                                                  train_worlds):
    model, cfg, jloss, ds, outs = train_worlds(compressor, mesh)
    batch = {k: jnp.asarray(v) for k, v in ds.batch(0).items()}
    (loss, _), grads = jax.jit(
        lambda p, bu, st, ba: jax.value_and_grad(jloss, has_aux=True)(
            p, bu, st, ba, step=0))(model["params"], model["buffers"],
                                    model["state"], batch)
    for rank in outs:
        np.testing.assert_allclose(float(rank["vag/loss"]), float(loss),
                                   rtol=1e-6)
        got = _port_tree(model, cfg, rank["vag/grads"])
        for path, g, w in _pairs(got, _np_tree(grads)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7,
                                       err_msg=path)


@pytest.mark.parametrize("compressor,mesh", TRAIN_MODELS)
def test_table_gradients_arrive_row_shard_local(compressor, mesh,
                                                train_worlds):
    model, cfg, _, _, outs = train_worlds(compressor, mesh)
    params, _, _ = model_from_numpy(model["params"], model["state"],
                                    model["buffers"], cfg, "cpu")
    emb = params["embedding"]["emb"]
    for rank in outs:
        flags, rows = rank["vag/flags"], rank["vag/local_rows"]
        sharded = [r for r, f in zip(rows, flags) if f]
        assert sharded == [emb.shape[0] // mesh[-1]]
        assert rank["trainer/local_shapes"][flags.index(True)][0] \
            == emb.shape[0] // mesh[-1]


def _port_trainer(model, cfg, ds, n_steps, **kw):
    """The port's single-device Trainer over the carried model."""
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import adam

    params, state, buffers = model_from_numpy(model["params"],
                                              model["state"],
                                              model["buffers"], cfg, "cpu")

    def loss_fn(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=model["lam"],
                            train=True, step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3), **kw)
    trainer.run(ds.batch, n_steps, log_every=0)
    return trainer


@pytest.mark.parametrize("compressor,mesh", TRAIN_MODELS)
def test_trainer_on_mesh_matches_reference_trainer(compressor, mesh,
                                                   train_worlds):
    """Losses against the reference's single-device Trainer; parameters
    against the port's single-device Trainer, and for the plain table also
    against the reference's. (The search-phase α of the port's own
    single-device Trainer parts from the reference's by ~1e-4 after 8
    steps, with or without a mesh: Adam's first steps are ±lr on α's tiny
    gradients.)"""
    model, cfg, jloss, ds, outs = train_worlds(compressor, mesh)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, model["params"]),
                   jax.tree.map(jnp.asarray, model["buffers"]),
                   jax.tree.map(jnp.asarray, model["state"]), jadam(1e-3),
                   donate=False)
    want = []
    for s in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(s).items()}
        ref.carry, out = ref._train_step(ref.carry, batch, jnp.asarray(s))
        want.append(float(out["loss"]))
    one = leaves(_port_trainer(model, cfg, ds, TRAIN_STEPS).params)
    for rank in outs:
        hist = rank["trainer/history"]
        assert not any(h["skipped"] for h in hist)
        np.testing.assert_allclose([h["loss"] for h in hist], want,
                                   rtol=1e-4)
        for a, b in zip(rank["trainer/params"], one):
            np.testing.assert_allclose(a, b.numpy(), rtol=2e-3, atol=1e-5)
        if compressor == "plain":
            got = _port_tree(model, cfg, rank["trainer/params"])
            for path, g, w in _pairs(got, _np_tree(ref.params)):
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-5,
                                           err_msg=path)
    first = outs[0]["trainer/params"]
    for rank in outs[1:]:        # every rank holds the same tree
        for a, b in zip(first, rank["trainer/params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compressor,mesh", TRAIN_MODELS)
def test_trainer_clip_scale_is_global(compressor, mesh, train_worlds):
    """At a clip that binds, the mesh step's norm — and so its scale — is
    the one-device step's, and so is the step it takes."""
    model, cfg, _, ds, outs = train_worlds(compressor, mesh)
    one = _port_trainer(model, cfg, ds, 1, clip_norm=1e-3)
    gnorm = one.history[0]["grad_norm"]
    assert gnorm > 1e-3 * 10          # the clip binds
    for rank in outs:
        got = rank["tight/history"][0]["grad_norm"]
        np.testing.assert_allclose(got, gnorm, rtol=1e-5)
        np.testing.assert_allclose(min(1.0, 1e-3 / (got + 1e-12)),
                                   min(1.0, 1e-3 / (gnorm + 1e-12)),
                                   rtol=1e-5)
        for a, b in zip(rank["tight/params"], leaves(one.params)):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("compressor,mesh", TRAIN_MODELS)
def test_each_rank_checkpoints_its_own_shards(compressor, mesh,
                                              train_worlds):
    *_, outs = train_worlds(compressor, mesh)
    for rank in outs:
        assert rank["ckpt/dirs"] == [f"rank{r}" for r in range(4)]
        assert rank["ckpt/restored"] and rank["ckpt/same"]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

REQUEST_ROWS = (40, 64, 300, 40)


@pytest.fixture(scope="module")
def engine_world(tmp_path_factory):
    return run_world("engine", {"request_rows": REQUEST_ROWS},
                     tmp_path_factory.mktemp("engine"), (2, 2))


@pytest.mark.parametrize("comms", ["psum", "a2a"])
def test_engine_on_mesh_bit_exact_and_zero_recompile(comms, engine_world):
    for rank in engine_world:
        for got, again, want in zip(rank[f"{comms}/first"],
                                    rank[f"{comms}/again"], rank["ref"]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(again, want)
        before, after = rank[f"{comms}/compiles"]
        assert before == after == 4       # two shapes, each with its lookup
        assert rank[f"{comms}/hits"] == 0
    np.testing.assert_array_equal(engine_world[0]["ref"][2],
                                  engine_world[3]["ref"][2])


@pytest.mark.parametrize("comms", ["psum", "a2a"])
def test_engine_cells_are_keyed_by_mesh_signature(comms, engine_world):
    for rank in engine_world:
        sigs = {key[-1] for key in rank[f"{comms}/keys"]}
        assert sigs == {"2x2:data,model:cpu"}


def test_lookup_comms_forks_the_cells_on_ranks(engine_world):
    """psum, a2a, psum on one cache: a2a builds a score cell and a lookup
    companion of its own (the companion gathers as its score cell does),
    the second psum builds nothing."""
    for rank in engine_world:
        first, a2a, again = rank["shared/counters"]
        assert (first["compiles"], first["hits"]) == (2, 0)
        assert (a2a["compiles"], a2a["hits"]) == (4, 0)
        assert (again["compiles"], again["hits"]) == (4, 2)


def test_engine_on_mesh_binds_its_row_blocks_and_swaps_them(engine_world):
    """Each rank's bound table holds its share of the padded rows, not the
    whole table; after a swap the mesh engine's scores are the 1×1
    engine's, and not the old table's."""
    for rank in engine_world:
        assert rank["psum/bound_rows"] == {
            k: -(-v // 2) for k, v in rank["table_rows"].items()}
        for got, want, old in zip(rank["swap/mesh"], rank["swap/one"],
                                  rank["ref"]):
            np.testing.assert_array_equal(got, want)
            assert not np.array_equal(got, old)


def test_tiered_engine_on_mesh_bit_exact(engine_world):
    for rank in engine_world:
        for got, want in zip(rank["tiered"]["mesh"], rank["tiered"]["one"]):
            np.testing.assert_array_equal(got, want)


def test_lookup_comms_forks_cell_fingerprint():
    cfg = DLRMConfig(fields=(FieldSpec("f0", 10),), d_embed=4,
                     mlp_hidden=(4,), compressor="packed",
                     comp_cfg={"bits": (0, 2), "d": 4, "n": 10})

    def mk(comms, cap):
        return packed_score_cell(DLRM, cfg, {}, {}, {}, batch=64,
                                 arch="dlrm", shape="p99", shard_lookup=True,
                                 lookup_comms=comms, bucket_capacity=cap)
    fps = {mk("psum", None).fingerprint, mk("a2a", None).fingerprint,
           mk("a2a", 8).fingerprint}
    assert len(fps) == 3


def test_sharded_wrappers_take_the_single_device_path_on_one_rank(
        kernel_case):
    inputs, ref, _ = kernel_case
    table = to_torch(inputs["table"], "cpu")
    ids = torch.from_numpy(inputs["ids"])
    for mesh in (None, host_mesh(1, 1)):
        assert shard.active_mesh(mesh) is None
        got = shard.sharded_packed_lookup(table, inputs["meta"], ids,
                                          mesh=mesh, lookup_comms="a2a",
                                          bucket_capacity=1)
        np.testing.assert_array_equal(got.numpy(), ref["lookup"])
    with pytest.raises(ValueError, match="lookup_comms"):
        shard.sharded_packed_lookup(table, inputs["meta"], ids,
                                    lookup_comms="ring")


# ---------------------------------------------------------------------------
# ALPT's projection on row shards
# ---------------------------------------------------------------------------

ALPT_STEPS = 1     # one step, one projection: see the test's docstring


@pytest.fixture(scope="module")
def alpt_case():
    model, cfg, _, _ = _train_case("alpt")
    inp = {"model": model, "train_steps": ALPT_STEPS}
    one = alpt_trainer(inp)
    return inp, [h["loss"] for h in one.history], leaves(one.params)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_alpt_trainer_on_mesh_projects_as_one_device(mesh, alpt_case,
                                                     tmp_path):
    """A step and its projection: the table within the Trainer's
    tolerances of one device's, where a shard projected with uniforms
    drawn from its own start would move codes by a whole step α. (Held
    over one step: from the second on, Adam's ±lr steps on α's tiny
    gradient part the mesh's α from one device's by ~4e-5, which moves
    every grid value — as the ``mpe_search`` Trainer's α parts.)"""
    inp, losses, params = alpt_case
    n_rows = sum(VOCABS)
    for rank in run_world("alpt", inp, tmp_path, mesh):
        assert rank["emb_rows"] == n_rows // mesh[-1]    # a row shard
        np.testing.assert_allclose(rank["history"], losses, rtol=1e-4)
        for a, b in zip(rank["params"], params):
            np.testing.assert_allclose(a, b.numpy(), rtol=2e-3, atol=1e-5)
