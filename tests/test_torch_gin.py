"""Port parity for GIN and its graph data on the CPU, from parameters made
once by the reference and carried into the port, on the same seeded numpy
graphs:

- ``data/graphs.py``: CSR adjacency, the SBM graph, the molecule batch,
  edge padding and the neighbour sampler equal the reference's bit for bit
  from the same seeds;
- ``scatter_sum`` and its gradient against ``jax.ops.segment_sum`` and its
  VJP: the port sums in float64 and rounds once, the reference in float32,
  so rtol 1e-6, atol 1e-6 times the largest sum; the gradient (a gather)
  bit for bit;
- GIN ``apply``, ``loss_fn`` and the gradient of every parameter for the
  reduced configuration of each of the four cells, built as the reference's
  smoke tests build them (logits rtol 1e-5, atol 1e-5 times the largest;
  loss rtol 1e-5; gradients rtol 1e-4, atol 1e-5 times the largest of the
  tree: message sums of another order and precision pass through every
  layer);
- four ``Trainer`` steps on the molecule cell against the reference's
  Trainer (losses rtol 1e-4);
- the configurations and cells equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNN_SHAPES as JGNN_SHAPES
from repro.configs.gin_tu import ARCH as JARCH
from repro.configs.gin_tu import GRAPH_CELLS as JGRAPH_CELLS
from repro.configs.gin_tu import make_config as jmake_config
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.data import graphs as jgraphs
from repro.models.gnn import GIN as JGIN
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.configs.base import GNN_SHAPES, get_arch
from repro_torch.configs.gin_tu import GRAPH_CELLS, make_config
from repro_torch.data import graphs
from repro_torch.interop import model_from_numpy
from repro_torch.kernels.segment_sum.ops import scatter_sum
from repro_torch.models.gnn import GIN
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten

LAM = 1e-5


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


def assert_same(got, want):
    """Equal key for key, array for array: values, dtypes and shapes."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_generators_equal_the_reference(seed):
    assert_same(graphs.make_sbm_graph(300, 2000, 12, 5, seed=seed),
                jgraphs.make_sbm_graph(300, 2000, 12, 5, seed=seed))
    assert_same(graphs.make_sbm_graph(100, 700, 4, 3, seed=seed,
                                      homophily=0.3),
                jgraphs.make_sbm_graph(100, 700, 4, 3, seed=seed,
                                       homophily=0.3))
    # more classes than an int8 holds: the sort's other key type
    assert_same(graphs.make_sbm_graph(400, 3000, 2, 130, seed=seed),
                jgraphs.make_sbm_graph(400, 3000, 2, 130, seed=seed))
    assert_same(graphs.make_molecule_batch(16, 12, 24, atom_vocab=119,
                                           seed=seed),
                jgraphs.make_molecule_batch(16, 12, 24, atom_vocab=119,
                                            seed=seed))


@pytest.mark.parametrize("multiple", [7, 512])
def test_csr_and_edge_padding_equal_the_reference(multiple):
    g = jgraphs.make_sbm_graph(400, 3000, 4, 3, seed=2)
    src, dst = g["edge_src"].astype(np.int64), g["edge_dst"].astype(np.int64)
    got, want = graphs.csr_from_edges(src, dst, 400), \
        jgraphs.csr_from_edges(src, dst, 400)
    for k in ("indptr", "indices"):
        assert_same(getattr(got, k), getattr(want, k))
    assert got.n_nodes == want.n_nodes
    assert_same(graphs.pad_graph_edges(g, multiple),
                jgraphs.pad_graph_edges(g, multiple))
    padded = jgraphs.pad_graph_edges(g, multiple)
    assert_same(graphs.pad_graph_edges(padded, multiple),
                jgraphs.pad_graph_edges(padded, multiple))


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (4,)])
def test_neighbor_sampler_equals_the_reference(fanouts):
    g = jgraphs.make_sbm_graph(500, 4000, 4, 3, seed=1)
    src, dst = g["edge_src"].astype(np.int64), g["edge_dst"].astype(np.int64)
    ours = graphs.NeighborSampler(graphs.csr_from_edges(src, dst, 500),
                                  fanouts, seed=7)
    ref = jgraphs.NeighborSampler(jgraphs.csr_from_edges(src, dst, 500),
                                  fanouts, seed=7)
    for seeds in (np.arange(8), np.array([3, 499, 0, 17])):
        # the sampler's generator advances: every draw must agree in turn
        got, want = ours.sample(seeds), ref.sample(seeds)
        assert_same(got, want)
    assert graphs.NeighborSampler.output_sizes(1024, fanouts) == \
        jgraphs.NeighborSampler.output_sizes(1024, fanouts)


@pytest.mark.parametrize("w", [1, 16, 300])
def test_scatter_sum_and_its_gradient_match_segment_sum(w, rng):
    t, n = 2000, 150
    x = rng.normal(0, 1, (t, w)).astype(np.float32)
    seg = (rng.zipf(1.3, t) % n).astype(np.int32)
    seg[seg % 7 == 3] = 0                        # empty segments
    g = rng.normal(0, 1, (n, w)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax.ops.segment_sum(a, seg, num_segments=n),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = scatter_sum(xt, torch.from_numpy(seg), n)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want_dx))
    exact = np.zeros((n, w), np.float64)
    np.add.at(exact, seg, x.astype(np.float64))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  exact.astype(np.float32))


def reference_gin(shape, seed=0):
    """The reduced reference GIN of ``shape`` under the compressor of its
    cell (``mpe_search`` on the molecule cell), each ε and bias drawn at
    random, as numpy trees, with both configs."""
    rng = np.random.default_rng(seed)
    jcfg = jmake_config(reduced=True, shape=shape)
    if jcfg.input_mode == "categorical":
        jcfg = jcfg._replace(compressor="mpe_search",
                             comp_cfg=JMPEConfig(group_size=16)._asdict())
    cfg = make_config(reduced=True, shape=shape)._replace(
        compressor=jcfg.compressor, comp_cfg=jcfg.comp_cfg)
    freqs = None
    if jcfg.input_mode == "categorical":
        freqs = np.arange(1, jcfg.atom_vocab + 1) ** -1.1
    params, buffers = JGIN.init(jax.random.PRNGKey(seed), jcfg, freqs)
    params, buffers = np_tree(params), np_tree(buffers)
    for layer in params["layers"]:
        layer["eps"] = np.float32(rng.normal(0, 0.1))
        for dense in layer["mlp"].values():
            dense["bias"] = (0.1 * rng.normal(0, 1, dense["bias"].shape)
                             ).astype(np.float32)
    if "embedding" in params:
        emb = params["embedding"]
        emb["emb"] = (0.05 * rng.normal(0, 1, emb["emb"].shape)
                      ).astype(np.float32)
        emb["gamma"] = (0.01 * rng.normal(0, 1, emb["gamma"].shape)
                        ).astype(np.float32)
    return jcfg, cfg, params, buffers


def cell_graph(shape, cfg):
    """The graph the reference's smoke tests build for ``shape`` (the
    dense cells on an SBM graph, ``minibatch_lg`` sampled from one) as
    numpy, with its static node or graph count."""
    if shape == "molecule":
        return jgraphs.make_molecule_batch(8, 10, 20, atom_vocab=cfg.atom_vocab)
    if shape == "minibatch_lg":
        g = jgraphs.make_sbm_graph(500, 4000, cfg.d_in, cfg.n_classes, seed=1)
        csr = jgraphs.csr_from_edges(g["edge_src"].astype(np.int64),
                                     g["edge_dst"].astype(np.int64), 500)
        sub = jgraphs.NeighborSampler(csr, (5, 3)).sample(np.arange(8))
        nn_ = sub["node_ids"].shape[0]
        return {"x": g["x"][sub["node_ids"]], "edge_src": sub["edge_src"],
                "edge_dst": sub["edge_dst"], "edge_mask": sub["edge_mask"],
                "labels": g["labels"][sub["node_ids"]],
                "label_mask": (np.arange(nn_) < 8).astype(np.float32)}
    seed = 0 if shape == "full_graph_sm" else 4
    return jgraphs.make_sbm_graph(200, 1000, cfg.d_in, cfg.n_classes,
                                  seed=seed)


def split(graph):
    """(jax graph, torch graph): arrays as each package's, ints as they
    are (``n_nodes``, ``n_graphs``)."""
    jg = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in graph.items()}
    tg = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in graph.items()}
    return jg, tg


def carried(cfg, params, buffers):
    t_params, _, t_buffers = model_from_numpy(params, {}, buffers, cfg, "cpu")
    return t_params, t_buffers


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
    pairs = _pairs(got, want)
    top = max(np.abs(w).max() for _, _, w in pairs if w.size)
    for path, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * top,
                                   err_msg=path)


def test_carrier_takes_gin_with_and_without_a_table():
    for shape in ("molecule", "full_graph_sm"):
        _, cfg, params, buffers = reference_gin(shape)
        t_params, t_buffers = carried(cfg, params, buffers)
        assert ("embedding" in t_buffers) == (shape == "molecule")
        assert all(layer["eps"].shape == () for layer in t_params["layers"])
        fresh, _ = GIN.init(cfg, seed=0, device="cpu")
        # jax.tree sorts dict keys: compare by path
        assert {p: g.shape for p, g, _ in _pairs(fresh, fresh)} == \
            {p: g.shape for p, g, _ in _pairs(t_params, t_params)}


@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_apply_loss_and_grads_match_reference(shape):
    jcfg, cfg, params, buffers = reference_gin(shape, seed=1)
    jg, tg = split(cell_graph(shape, cfg))
    want_logits, want_reg = jax.jit(lambda p: JGIN.apply(
        p, buffers, jg, jcfg))(params)
    (want_loss, want_ce), want_grads = jax.jit(jax.value_and_grad(
        lambda p: JGIN.loss_fn(p, buffers, jg, jcfg, lam=LAM),
        has_aux=True))(params)
    t_params, t_buffers = carried(cfg, params, buffers)
    with torch.no_grad():
        logits, reg = GIN.apply(t_params, t_buffers, tg, cfg)
    want_logits = np.asarray(want_logits)
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(want_logits).max())
    np.testing.assert_allclose(float(reg), float(want_reg), rtol=1e-5)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, ce = GIN.loss_fn(t_params, t_buffers, tg, cfg, lam=LAM)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ce.detach()), float(want_ce), rtol=1e-5)
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-5)
    # every ε takes a gradient
    assert all(float(g["eps"]) != 0.0 for g in grads["layers"])


def test_trainer_steps_on_the_molecule_cell_match_reference():
    jcfg, cfg, params, buffers = reference_gin("molecule", seed=4)
    batches = [jgraphs.make_molecule_batch(8, 10, 20, atom_vocab=119,
                                           seed=s) for s in range(4)]
    for b in batches:
        b.pop("n_graphs")           # static: the loss functions inject it

    def jloss(p, bu, st, batch, *, step=None):
        loss, ce = JGIN.loss_fn(p, bu, dict(batch, n_graphs=8), jcfg, lam=LAM,
                                step=step)
        return loss, (st, ce)

    def tloss(p, bu, st, batch, *, step=None):
        loss, ce = GIN.loss_fn(p, bu, dict(batch, n_graphs=8), cfg, lam=LAM,
                               step=step)
        return loss, (st, ce)

    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers), {}, jadam(3e-3),
                   donate=False)
    want = []
    for s, batch in enumerate(batches):
        ref.carry, out = ref._train_step(
            ref.carry, jax.tree.map(jnp.asarray, batch), jnp.asarray(s))
        want.append(float(out["loss"]))
    port = Trainer(tloss, *carried(cfg, params, buffers), {}, adam(3e-3))
    port.run(lambda s: batches[s], 4, log_every=0)
    got = [h["loss"] for h in port.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(h["skipped"] for h in port.history)
    assert len({round(x, 6) for x in got}) == 4
    np.testing.assert_allclose(
        [float(layer["eps"]) for layer in port.params["layers"]],
        [float(layer["eps"]) for layer in ref.carry["params"]["layers"]],
        rtol=1e-4, atol=1e-7)


def test_configuration_and_cells_match_reference():
    assert GNN_SHAPES == JGNN_SHAPES
    assert {k: tuple(v) for k, v in GRAPH_CELLS.items()} == \
        {k: tuple(v) for k, v in JGRAPH_CELLS.items()}
    for shape in GNN_SHAPES:
        for reduced in (False, True):
            assert make_config(reduced, shape)._asdict() == \
                jmake_config(reduced, shape)._asdict()
    spec = get_arch("gin-tu")
    assert spec.shapes == JARCH.shapes and spec.family == JARCH.family
    assert spec.citation == JARCH.citation and spec.notes == JARCH.notes
