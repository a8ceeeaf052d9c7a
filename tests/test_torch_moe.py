"""Port parity for the Mixture-of-Experts FFN on the CPU, from the
reference's own weights:

- routing integers bit-identical: the reference's top-k choices (read from
  its ``jax.lax.top_k``), which choices it keeps (the nonzero rows it hands
  ``jax.ops.segment_sum``) and the capacity; each choice's position in its
  expert and its slot equal to a numpy recount in choice order;
- ``MoE.apply`` outputs and the load-balance loss within 1e-6 (rtol and
  atol): the router's and the experts' float32 products sum in XLA's own
  order, and the port's combine (``scatter_sum``) sums each token's top-k
  contributions in float64, rounded once;
- dense, shared-expert, int8-expert and overflowing (dropping) configs;
- both gathers, the dispatch and the combine's, on
  ``kernels/segment_sum``'s ``gather`` (its backward the segment sum): the
  forward bit-identical to plain indexing, the gradients in x and in the
  weights within 1e-5 of ``jax.grad``'s (the segment sums in float64 in
  another order); in bf16 the gathers take the rows as they are, and the
  outputs and gradients are bit-identical to gathering float32 copies of
  the rows and rounding the gathered rows back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.interop import to_torch
from repro_torch.nn import moe as moe_module
from repro_torch.nn.moe import MoE, MoEConfig, ffn_apply, routing
from repro_torch.train.tree import leaves, unflatten

TOL = dict(rtol=1e-6, atol=1e-6)

CONFIGS = {
    "routed": dict(n_experts=8, top_k=2, d_model=16, d_ff=24),
    "shared": dict(n_experts=8, top_k=2, d_model=16, d_ff=12, n_shared=2),
    "int8_experts": dict(n_experts=4, top_k=2, d_model=16, d_ff=20,
                         expert_weight_int8=True),
    "overflow": dict(n_experts=4, top_k=3, d_model=16, d_ff=8,
                     capacity_factor=0.5),
    "top6_of_64": dict(n_experts=64, top_k=6, d_model=32, d_ff=8,
                       n_shared=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_moe(name: str, seed: int = 0):
    kw = CONFIGS[name]
    jcfg, cfg = jmoe.MoEConfig(**kw), MoEConfig(**kw)
    params = jmoe.MoE.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, params, to_torch(jax.tree.map(np.asarray, params), "cpu")


def recount(topi: np.ndarray, n_experts: int, cap: int):
    """Each choice's position in its expert (choices in token-major order)
    and its slot: an independent count of the reference's cumsum."""
    flat = topi.reshape(-1)
    seen = np.zeros(n_experts, np.int64)
    pos = np.empty_like(flat)
    for c, e in enumerate(flat):
        pos[c] = seen[e]
        seen[e] += 1
    return pos, flat * cap + np.clip(pos, 0, cap - 1), pos < cap


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routing_integers_are_the_references(rng, name, monkeypatch):
    jcfg, cfg, params, tparams = reference_moe(name)
    x = rng.normal(0, 1, (3, 7, cfg.d_model)).astype(np.float32)
    seen = {}
    top_k, segment_sum = jax.lax.top_k, jax.ops.segment_sum

    def spy_top_k(v, k):
        out = top_k(v, k)
        seen["topi"] = np.asarray(out[1])
        return out

    def spy_segment_sum(data, ids, num_segments):
        seen["data"], seen["ids"] = np.asarray(data), np.asarray(ids)
        return segment_sum(data, ids, num_segments=num_segments)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.ops, "segment_sum", spy_segment_sum)
    jmoe.MoE.apply(params, jnp.asarray(x), jcfg)        # eager: values seen
    monkeypatch.undo()

    r = routing(torch.from_numpy(x.reshape(-1, cfg.d_model)),
                tparams["router"], cfg)
    t = x.shape[0] * x.shape[1]
    assert r["cap"] == max(1, int(cfg.capacity_factor * cfg.top_k * t
                                  / cfg.n_experts))
    np.testing.assert_array_equal(r["topi"].numpy(), seen["topi"])
    pos, slot, keep = recount(seen["topi"], cfg.n_experts, r["cap"])
    np.testing.assert_array_equal(r["pos_in_expert"].numpy(), pos)
    np.testing.assert_array_equal(r["slot"].numpy(), slot)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    # the reference hands segment_sum zero rows exactly where it drops
    np.testing.assert_array_equal(np.any(seen["data"] != 0, axis=1), keep)
    np.testing.assert_array_equal(seen["ids"], np.repeat(np.arange(t),
                                                         cfg.top_k))
    if name == "overflow":
        assert not keep.all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_apply_matches_reference(rng, name):
    jcfg, cfg, params, tparams = reference_moe(name)
    x = rng.normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    want, waux = jax.jit(lambda p, v: jmoe.MoE.apply(p, v, jcfg))(params, x)
    got, aux = MoE.apply(tparams, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)


def test_ffn_apply_matches_reference(rng):
    p = jmoe._ffn_init(jax.random.PRNGKey(3), 16, 24, jnp.float32)
    x = rng.normal(0, 1, (5, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jmoe.ffn_apply)(p, x))
    got = ffn_apply(to_torch(jax.tree.map(np.asarray, p), "cpu"),
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_port_init_has_the_references_layout():
    for name in ("shared", "int8_experts"):
        jcfg, cfg, params, _ = reference_moe(name)
        mine = MoE.init(torch.Generator().manual_seed(0), cfg)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        for path, leaf in flat:
            node = mine
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_gathers_are_segment_sum_gathers(rng, name, monkeypatch):
    jcfg, cfg, params, tparams = reference_moe(name)
    x = rng.normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    real, seen = moe_module.gather, []

    def spy(table, ids):
        seen.append(table.dtype)
        return real(table, ids)

    monkeypatch.setattr(moe_module, "gather", spy)
    got, aux = MoE.apply(tparams, torch.from_numpy(x), cfg)
    assert seen == [torch.float32, torch.float32]   # dispatch, combine
    monkeypatch.setattr(moe_module, "gather", lambda table, ids: table[ids])
    plain, plain_aux = MoE.apply(tparams, torch.from_numpy(x), cfg)
    assert torch.equal(got, plain) and torch.equal(aux, plain_aux)
    monkeypatch.undo()
    if cfg.expert_weight_int8:      # int8 codes take no gradient
        return

    def jloss(p, v):
        out, a = jmoe.MoE.apply(p, v, jcfg)
        return jnp.sum(out * cot) + a

    wgp, wgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    flat = [p.detach().requires_grad_(True) for p in leaves(tparams)]
    tx = torch.tensor(x, requires_grad=True)
    out, a = MoE.apply(unflatten(tparams, flat), tx, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + a,
                                [tx, *flat])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(wgx), rtol=1e-5,
                               atol=1e-5)
    want = jax.tree.leaves(wgp)
    assert len(want) == len(flat)
    for g, w in zip(grads[1:], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["shared", "top6_of_64"])
def test_moe_bf16_gathers_sum_their_gradients_in_float32(rng, name,
                                                        monkeypatch):
    _, cfg, _, tparams = reference_moe(name)
    tparams = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                   if k != "router" else v) for k, v in tparams.items()}
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    cot = torch.from_numpy(rng.normal(0, 1, tuple(x.shape)).astype(
        np.float32)).to(torch.bfloat16)
    real, seen = moe_module.gather, []

    def spy(table, ids):
        seen.append(table.dtype)
        return real(table, ids)

    def float32_rows(table, ids):
        return real(table.to(torch.float32), ids).to(table.dtype)

    runs = []
    for gather in (spy, float32_rows):
        monkeypatch.setattr(moe_module, "gather", gather)
        flat = [p.detach().requires_grad_(True) for p in leaves(tparams)]
        tx = x.clone().requires_grad_(True)
        out, a = MoE.apply(unflatten(tparams, flat), tx, cfg)
        grads = torch.autograd.grad((out.float() * cot.float()).sum() + a,
                                    [tx, *flat])
        runs.append((out, a, grads))
    assert seen == [torch.bfloat16, torch.bfloat16]   # dispatch, combine
    (out, a, grads), (out2, a2, grads2) = runs
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, out2) and torch.equal(a, a2)
    assert all(torch.equal(g, g2) for g, g2 in zip(grads, grads2))
