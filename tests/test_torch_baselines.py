"""The paper's Table-3 baselines in the port against the reference's, on the
CPU, from parameters the reference makes and the carrier brings over
(``jax.random`` and ``torch.Generator`` never agree):

- the port's own init: the reference's shapes and types, and the storage
  ratio of the reference's ``test_interface``;
- each lookup at ``train=True`` and ``False`` and its gradients (of
  ``Σ out·G``) against the reference's, at the reference's quantizer
  tolerance (rtol 1e-5, atol 1e-7; ``tests/test_kernels.py``), the
  gradients of the small leaves that sum over the whole batch (α, β, the
  thresholds, QR's remainder rows) at its kernels' contract for such sums
  (rtol 1e-4, atol 1e-6), as they are summed in another order: LSQ through
  the Eq. 9 kernel's plain version with one width and probability 1, ALPT
  with β = 0, QR (mult and add), PEP, OptFS;
- ALPT's hook projects the table a chunk of rows at a time, in place;
- ALPT's stochastic-rounding projection on the same uniforms equals the
  reference's (whose ``jax.random.uniform`` is handed them), on the grid,
  in place;
- OptFS's anneal at steps {0, 1, total/2, total, None};
- a 3-step ``Trainer`` trajectory of a DLRM with each baseline (ALPT's
  post-update hook projecting with the same uniforms in both) within loss
  rtol 1e-4 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_compressor as jget_compressor
from repro.core.baselines import alpt as jalpt_module
from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.models.dlrm import DLRM as JDLRM
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.core.api import get_compressor
from repro_torch.core.baselines import alpt as alpt_module
from repro_torch.core.baselines.alpt import ALPT
from repro_torch.core.baselines.optfs import OptFS
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.models.dlrm import DLRM
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from test_torch_train import configs, np_tree

QTOL = dict(rtol=1e-5, atol=1e-7)     # the reference's quantizer tolerance
RED_TOL = dict(rtol=1e-4, atol=1e-6)  # its kernels' contract for batch sums
N, D = 512, 16

CASES = [
    ("plain", {}, 1.0),
    ("lsq", {"bits": 6}, 6 / 32),
    ("lsq", {"bits": 4}, 4 / 32),
    ("alpt", {"bits": 8}, 8 / 32),
    ("qr", {"k": 2}, None),
    ("qr", {"k": 2, "combine": "add"}, None),
    ("qr", {"k": 3}, None),
    ("pep", {}, None),
    ("optfs", {"total_steps": 100}, None),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in c.items())}" for n, c, _ in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_params(name, cfg, rng):
    """The reference's init of compressor ``name`` as numpy, made
    non-trivial where its init is degenerate (β, thresholds, gates)."""
    p, b = jget_compressor(name).init(jax.random.PRNGKey(0), N, D,
                                      rng.zipf(1.3, N).astype(np.float64), cfg)
    p = np_tree(p)
    if name == "lsq":
        p["beta"] = rng.normal(0, 1e-3, D).astype(np.float32)
    if name == "pep":   # thresholds of the table's scale, so some prune
        p["thresh_logit"] = rng.normal(-5.8, 0.3, D).astype(np.float32)
    if name == "optfs":
        p["gate_logit"] = rng.normal(0, 2, N).astype(np.float32)
    return p, np_tree(b)


@pytest.mark.parametrize("name,cfg,ratio", CASES, ids=IDS)
def test_init_shapes_and_storage_ratio(name, cfg, ratio, rng):
    gen = torch.Generator().manual_seed(0)
    p, b = get_compressor(name).init(gen, N, D, rng.zipf(1.3, N), cfg)
    want_p, want_b = jget_compressor(name).init(jax.random.PRNGKey(0), N, D,
                                                None, cfg)
    assert set(p) == set(want_p) and b == {} == want_b
    for k, v in p.items():
        assert tuple(v.shape) == want_p[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want_p[k].dtype), k
    r = get_compressor(name).storage_ratio(p, b, cfg)
    want = jget_compressor(name).storage_ratio(want_p, want_b, cfg)
    if ratio is not None:
        assert abs(r - ratio) < 1e-6
    else:
        assert abs(r - want) < 1e-3, (r, want)
    assert 0.0 <= r <= 1.01


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,cfg,ratio", CASES, ids=IDS)
def test_lookup_and_grads_match_reference(name, cfg, ratio, train, rng):
    params, buffers = reference_params(name, cfg, rng)
    ids = rng.integers(0, N, (64, 4)).astype(np.int32)
    g = rng.normal(0, 1, (64, 4, D)).astype(np.float32)
    jc = jget_compressor(name)

    def jf(p):
        out = jc.lookup(p, buffers, jnp.asarray(ids), cfg, train=train,
                        step=jnp.asarray(37, jnp.int32))
        return jnp.sum(out * g), out
    (_, want), want_grads = jax.value_and_grad(jf, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    tp = to_torch(params, "cpu")
    for x in tp.values():
        x.requires_grad_(True)
    out = get_compressor(name).lookup(tp, to_torch(buffers, "cpu"),
                                      torch.from_numpy(ids), cfg, train=train,
                                      step=torch.tensor(37, dtype=torch.int32))
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                list(tp.values()), allow_unused=True)
    assert out.shape == (64, 4, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **QTOL)
    for k, gr in zip(tp, grads):
        w = np.asarray(want_grads[k])
        gr = np.zeros_like(w) if gr is None else gr.numpy()
        tol = QTOL if w.ndim and w.shape[0] >= N // 3 else RED_TOL  # rows or sums
        np.testing.assert_allclose(gr, w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, np.abs(w).max()),
                                   err_msg=f"{name} d{k}")


def test_alpt_projection_matches_reference_on_same_uniforms(rng, monkeypatch):
    """The port's in-place projection and the reference's ``_project`` fed
    the same uniforms give the same table, every entry α times an integer
    code in [-128, 127]."""
    params, _ = reference_params("alpt", {"bits": 8}, rng)
    emb = params["emb"] + rng.normal(0, 1e-4, params["emb"].shape).astype(np.float32)
    alpha = np.float32(params["alpha"] * 1.07)
    u = rng.random(emb.shape).astype(np.float32)
    monkeypatch.setattr(jalpt_module.jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    want = np.asarray(jalpt_module.ALPT._project(jnp.asarray(emb),
                                                 jnp.asarray(alpha), 8,
                                                 jax.random.PRNGKey(0)))
    t_emb = torch.from_numpy(emb.copy())
    ptr = t_emb.data_ptr()
    got = ALPT._project_(t_emb, torch.tensor(alpha), 8, torch.from_numpy(u))
    assert got.data_ptr() == t_emb.data_ptr() == ptr           # in place
    np.testing.assert_array_equal(t_emb.numpy(), want)
    codes = torch.round(t_emb / float(alpha))
    assert torch.equal(float(alpha) * codes, t_emb)
    assert codes.min() >= -128 and codes.max() <= 127
    # the hook draws its uniforms from the generator on the table's device
    p = to_torch(params, "cpu")
    ptr = p["emb"].data_ptr()
    out = ALPT.post_update(p, {}, {"bits": 8}, torch.Generator().manual_seed(1))
    assert out is p and p["emb"].data_ptr() == ptr


def test_alpt_hook_projects_chunk_by_chunk(rng, monkeypatch):
    """The hook projects ``PROJECT_ROWS`` rows at a time, each chunk on
    uniforms drawn in turn from the generator: the same table as
    ``_project_`` on those draws, in place and on the grid, with a last
    chunk shorter than the others."""
    params, _ = reference_params("alpt", {"bits": 8}, rng)
    monkeypatch.setattr(alpt_module, "PROJECT_ROWS", 7)
    p = to_torch(params, "cpu")
    p["emb"].add_(torch.from_numpy(
        rng.normal(0, 1e-3, p["emb"].shape).astype(np.float32)))
    n = p["emb"].shape[0]
    assert n % 7
    want = p["emb"].clone()
    gen = torch.Generator().manual_seed(3)
    for r in range(0, n, 7):
        rows = want[r:r + 7]
        ALPT._project_(rows, p["alpha"], 8,
                       torch.rand(rows.shape, generator=gen))
    ptr = p["emb"].data_ptr()
    ALPT.post_update(p, {}, {"bits": 8}, torch.Generator().manual_seed(3))
    assert p["emb"].data_ptr() == ptr
    assert torch.equal(p["emb"], want)
    codes = torch.round(p["emb"] / p["alpha"])
    assert torch.equal(p["alpha"] * codes, p["emb"])


@pytest.mark.parametrize("step", [0, 1, 50, 100, None])
def test_optfs_anneal_matches_reference(step):
    jfs = jget_compressor("optfs")
    want = jfs._anneal(None if step is None else jnp.asarray(step, jnp.int32), 100)
    got = OptFS._anneal(None if step is None else
                        torch.tensor(step, dtype=torch.int32), 100)
    if step is None:
        assert got == want == 100.0
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert float(got) == {0: 1.0, 100: 100.0}.get(step, float(got))


VOCABS = (300, 200, 150, 100)
TRAJ = [("plain", {}), ("lsq", {"bits": 6}), ("alpt", {"bits": 8}),
        ("qr", {"k": 2}), ("pep", {}), ("optfs", {"total_steps": 3})]


@pytest.mark.parametrize("name,cfg", TRAJ, ids=[n for n, _ in TRAJ])
def test_trainer_trajectory_matches_reference(name, cfg, rng, monkeypatch):
    spec = JCTRSpec(field_vocabs=VOCABS, batch_size=256, seed=1)
    ds = JSyntheticCTR(spec)
    jcfg, tcfg = configs(name, cfg)
    params, buffers, state = JDLRM.init(jax.random.PRNGKey(1), jcfg,
                                        ds.expected_frequencies())
    params, buffers, state = np_tree(params), np_tree(buffers), np_tree(state)
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    tcfg, "cpu")
    jpost = tpost = None
    if name == "alpt":   # the projection on the same uniforms in both
        draws = [rng.random(params["embedding"]["emb"].shape).astype(np.float32)
                 for _ in range(3)]
        used = {"j": iter(draws), "t": iter(draws)}
        monkeypatch.setattr(jalpt_module.jax.random, "uniform",
                            lambda key, shape: jnp.asarray(next(used["j"])))

        def jpost(p):
            e = p["embedding"]
            return dict(p, embedding=dict(e, emb=jalpt_module.ALPT._project(
                e["emb"], e["alpha"], 8, jax.random.PRNGKey(0))))

        def tpost(p):
            e = p["embedding"]
            ALPT._project_(e["emb"], e["alpha"], 8, torch.from_numpy(next(used["t"])))
            return p

    def jloss(p, bu, st, batch, *, step=None):
        return JDLRM.loss_fn(p, bu, st, batch, jcfg, lam=3e-5, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, tcfg, lam=3e-5, step=step)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers),
                   jax.tree.map(jnp.asarray, state), jadam(1e-3), donate=False,
                   post_update=jpost)
    want = []
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(s).items()}
        ref.carry, out = ref._train_step(ref.carry, batch, jnp.asarray(s))
        ref.carry["params"] = jpost(ref.carry["params"]) if jpost else ref.carry["params"]
        want.append(float(out["loss"]))
    port = Trainer(tloss, t_params, t_buffers, t_state, adam(1e-3),
                   post_update=tpost)
    port.run(ds.batch, 3, log_every=0)
    got = [h["loss"] for h in port.history]
    assert not any(h["skipped"] for h in port.history)
    np.testing.assert_allclose(got, want, rtol=1e-4)
