"""Port parity for the LM's training path on the CPU: the same numpy inputs
and the reference's own weights (carried with ``interop.model_from_numpy``)
go through ``repro`` and ``repro_torch``.

- ``chunked_softmax_xent`` against the reference's value and ``jax.grad``
  in x and ``lm_head`` at two chunk sizes (value within 1e-6, gradients
  within 1e-5: XLA's float32 products and the log-softmax's sums run in
  their own order); a chunk that does not divide S raises;
- ``hidden_states`` and ``loss_fn``, both routes (``ce_chunk`` set and
  unset, the MoE's aux loss included), at the five reduced LM configs in
  float32: losses within 1e-5 relative, each gradient leaf within 1e-4 of
  its largest |value|;
- the per-layer remat (``torch.utils.checkpoint``) changes no bit of the
  loss or of any gradient;
- three ``Trainer`` steps against the reference's Trainer on reduced
  internlm2-1.8b and deepseek-moe-16b (losses within rtol 1e-4);
- a bf16 reduced internlm2-1.8b: the moments of its bf16 leaves are
  float32 after a step, as the reference's are; the loss within 5e-4
  relative (XLA and torch round bf16 products and their elementwise
  chains at other points), and each updated entry within 2·lr plus a bf16
  step of the reference's, on at most 3% of a leaf's entries apart at
  all (Adam's first step is lr times the gradient's sign, which a
  near-zero gradient may take the other way);
- the Adam pass's plain version on bf16 leaves bit-identical to the
  reference's update chain run op by op, with and without weight decay
  and a schedule;
- the vocabulary search (``mpe_search`` on the token table) of a reduced LM
  for three steps (losses within rtol 1e-4), and Eq. 11's sampled group
  widths bit-identical when both packages sample from the same trained
  probabilities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.core.mpe import MPESearchEmbedding as JMPESearch
from repro.core.sampling import sample_group_bits as jsample_group_bits
from repro.data.tokens import TokenStream as JTokenStream
from repro.models.lm import LM as JLM
from repro.nn.chunked import chunked_softmax_xent as jxent
from repro.train import optimizer as jopt
from repro.train.loop import Trainer as JTrainer
from repro_torch.configs.base import get_arch
from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding
from repro_torch.core.sampling import sample_group_bits
from repro_torch.data.tokens import TokenStream
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.kernels.adam.ref import adam_step_ref_
from repro_torch.models.lm import LM
from repro_torch.nn.chunked import chunked_softmax_xent
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam, warmup_cosine
from repro_torch.train.tree import leaves, unflatten

LM_ARCHS = ("internlm2-1.8b", "qwen3-32b", "starcoder2-7b",
            "deepseek-moe-16b", "grok-1-314b")
XENT_VALUE_TOL = dict(rtol=1e-6, atol=1e-6)
XENT_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-4          # of each leaf's largest |value|
TRAIN_RTOL = 1e-4
BF16_LOSS_RTOL = 5e-4
BF16_PARTED_SHARE = 0.03   # entries of a leaf a bf16 step may part on
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reference_lm(arch: str, seed: int = 0, **replace):
    """The reduced config of ``arch`` in both packages (fields replaced
    where given), the reference's initialised weights and the same carried
    into the port."""
    jcfg = jget_arch(arch).make_config(reduced=True)._replace(**replace)
    cfg = get_arch(arch).make_config(reduced=True)._replace(**replace)
    freqs = None
    if replace.get("compressor") == "mpe_search":
        freqs = JTokenStream(jcfg.vocab, 1, 1).expected_frequencies()
    params, buffers = JLM.init(jax.random.PRNGKey(seed), jcfg, freqs=freqs)
    tp, _, tb = model_from_numpy(np_tree(params), {}, np_tree(buffers), cfg,
                                 device="cpu")
    return jcfg, cfg, params, buffers, tp, tb


def token_batch(vocab: int, step: int = 0, batch: int = B, seq: int = S):
    return TokenStream(vocab, batch, seq).batch_at(step)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def value_and_grads(fn, params):
    """fn(live params) -> (loss, aux...), and the gradient of the loss in
    every leaf, in the tree's leaf order."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    out = fn(unflatten(params, flat))
    grads = torch.autograd.grad(out[0], flat)
    return out, [g.numpy() for g in grads]


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        top = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_SHARE * top)


# -- chunked cross-entropy ---------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_softmax_xent_matches_reference(rng, chunk):
    d, v = 24, 300
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    w = rng.normal(0, 0.2, (d, v)).astype(np.float32)
    labels = rng.integers(0, v, (B, S)).astype(np.int32)
    want, (wdx, wdw) = jax.value_and_grad(
        lambda a, b: jxent(a, b, labels, chunk=chunk), argnums=(0, 1))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = chunked_softmax_xent(tx, tw, torch.from_numpy(labels), chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), **XENT_VALUE_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx),
                               **XENT_GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(wdw),
                               **XENT_GRAD_TOL)
    # the whole logit matrix at once gives the same mean
    whole = torch.nn.functional.cross_entropy(
        (tx @ tw).reshape(-1, v), torch.from_numpy(labels).long().reshape(-1))
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)


def test_chunked_softmax_xent_refuses_a_chunk_that_does_not_divide_s(rng):
    x = torch.zeros((B, S, 4))
    with pytest.raises(ValueError, match="divide"):
        chunked_softmax_xent(x, torch.zeros((4, 10)),
                             torch.zeros((B, S), dtype=torch.int32), chunk=12)
    # a chunk longer than S is cut to S, as the reference cuts it
    out = chunked_softmax_xent(x, torch.zeros((4, 10)),
                               torch.zeros((B, S), dtype=torch.int32),
                               chunk=4 * S)
    np.testing.assert_allclose(float(out), np.log(10.0), rtol=1e-6)


# -- hidden states and the loss ----------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_hidden_states_match_reference(arch):
    jcfg, cfg, params, buffers, tp, tb = reference_lm(arch)
    toks = token_batch(cfg.vocab)["tokens"]
    want, waux = JLM.hidden_states(params, buffers, toks, jcfg)
    with torch.no_grad():
        got, aux = LM.hidden_states(tp, tb, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ce_chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_fn_and_grads_match_reference(arch, ce_chunk):
    jcfg, cfg, params, buffers, tp, tb = reference_lm(arch, ce_chunk=ce_chunk)
    batch = token_batch(cfg.vocab)
    (wl, wce), wg = jax.value_and_grad(
        lambda p: JLM.loss_fn(p, buffers, batch, jcfg), has_aux=True)(params)
    (loss, ce), grads = value_and_grads(
        lambda p: LM.loss_fn(p, tb, torch_batch(batch), cfg), tp)
    np.testing.assert_allclose(float(loss), float(wl), rtol=LOSS_RTOL)
    assert tuple(ce.shape) == tuple(np.shape(wce))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(wce),
                               rtol=LOSS_RTOL, atol=1e-6)
    assert_grads_close(grads, jax.tree.leaves(wg))
    if cfg.moe is not None:   # the aux loss takes part
        _, aux = LM.hidden_states(tp, tb, torch.from_numpy(batch["tokens"]),
                                  cfg)
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_remat_changes_no_bit(arch):
    _, cfg, _, _, tp, tb = reference_lm(arch, ce_chunk=8)
    batch = torch_batch(token_batch(cfg.vocab))
    runs = []
    for remat in (True, False):
        c = cfg._replace(remat=remat)
        (loss, _), grads = value_and_grads(
            lambda p: LM.loss_fn(p, tb, batch, c), tp)
        runs.append((float(loss), grads))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_remat_runs_each_layer_under_checkpoint(monkeypatch):
    """With remat the layers run inside ``checkpoint`` where grad is on, and
    never where it is off or where caches are passed."""
    from repro_torch.models.lm import transformer
    _, cfg, _, _, tp, tb = reference_lm("internlm2-1.8b")
    calls = []
    real = transformer.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    toks = torch.from_numpy(token_batch(cfg.vocab)["tokens"])
    flat = [p.detach().requires_grad_(True) for p in leaves(tp)]
    LM.hidden_states(unflatten(tp, flat), tb, toks, cfg)
    assert calls == [False] * cfg.n_layers
    with torch.no_grad():
        LM.hidden_states(tp, tb, toks, cfg)
        LM.prefill(tp, tb, toks, cfg, max_len=S)
    LM.hidden_states(tp, tb, toks, cfg._replace(remat=False))
    assert len(calls) == cfg.n_layers


# -- the Trainer -------------------------------------------------------------

def lm_losses(jcfg, cfg, params, buffers, tp, tb, n_steps: int, *,
              mpe_cfg=None):
    """``n_steps`` of both Trainers (``adam(1e-3)``, clip 10) on the same
    TokenStream batches; the vocabulary search's regulariser where
    ``mpe_cfg`` is given. Returns (reference losses, port losses, both
    trainers)."""
    batches = [token_batch(cfg.vocab, s) for s in range(n_steps)]

    def jloss(p, bu, st, batch, *, step=None):
        loss, ce = JLM.loss_fn(p, bu, batch, jcfg, train=True, step=step)
        if mpe_cfg is not None:
            loss = loss + mpe_cfg.lam * JMPESearch.reg_loss(
                p["embedding"], bu["embedding"], mpe_cfg)
        return loss, (st, jnp.mean(ce))

    def tloss(p, bu, st, batch, *, step=None):
        loss, ce = LM.loss_fn(p, bu, batch, cfg, train=True, step=step)
        if mpe_cfg is not None:
            loss = loss + mpe_cfg.lam * MPESearchEmbedding.reg_loss(
                p["embedding"], bu["embedding"], mpe_cfg)
        return loss, (st, torch.mean(ce))

    ref = JTrainer(jloss, params, buffers, {}, jopt.adam(1e-3), donate=False)
    want = []
    for s, batch in enumerate(batches):
        ref.carry, out = ref._train_step(
            ref.carry, jax.tree.map(jnp.asarray, batch), jnp.asarray(s))
        want.append(float(out["loss"]))
    port = Trainer(tloss, tp, tb, {}, adam(1e-3))
    port.run(lambda s: batches[s], n_steps, log_every=0)
    assert not any(h["skipped"] for h in port.history)
    return want, [h["loss"] for h in port.history], ref, port


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_trainer_steps_match_reference(arch):
    jcfg, cfg, params, buffers, tp, tb = reference_lm(arch, ce_chunk=8)
    want, got, _, _ = lm_losses(jcfg, cfg, params, buffers, tp, tb, 3)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    assert len({round(x, 6) for x in got}) == 3            # it trains


def test_bf16_trainer_step_keeps_float32_moments():
    jcfg, cfg, params, buffers, tp, tb = reference_lm(
        "internlm2-1.8b", ce_chunk=8, dtype="bfloat16")
    assert tp["layers"]["ffn"]["w_up"].dtype == torch.bfloat16
    want, got, ref, port = lm_losses(jcfg, cfg, params, buffers, tp, tb, 1)
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    jmu = jax.tree.leaves(ref.carry["opt"]["mu"])
    mu = leaves(port.carry["opt"]["mu"])
    assert all(m.dtype == torch.float32 for m in mu)
    assert all(m.dtype == jnp.float32 for m in jmu)   # the reference's too
    for p, jp in zip(leaves(port.params), jax.tree.leaves(ref.carry["params"])):
        assert p.dtype == (torch.bfloat16 if jp.dtype == jnp.bfloat16
                           else torch.float32)
        w = np.asarray(jp, np.float32)
        diff = np.abs(p.float().numpy() - w)
        # Adam's first step moves an entry by lr times the sign of its
        # gradient, so where the two packages' bf16 roundings leave a
        # near-zero gradient of the other sign the entries part by 2·lr
        # (and a bf16 step of the entry): on a few entries only
        assert (diff <= 2 * 1e-3 + 2.0 ** -7 * np.abs(w)).all()
        assert (diff > 0).mean() <= BF16_PARTED_SHARE


# -- the Adam pass on bf16 leaves ---------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("scheduled", [False, True], ids=["const", "sched"])
def test_bf16_adam_plain_version_is_the_reference_chain(rng, weight_decay,
                                                        scheduled):
    """One bf16 leaf through the reference's clip, ``adam.update`` and
    ``apply_updates``, run op by op, against ``adam_step_ref_``: every bit
    of the leaf and of both float32 moments."""
    shape = (64, 33)
    p = jnp.asarray(rng.normal(0, 1, shape), jnp.bfloat16)
    g = jnp.asarray(rng.normal(0, 1e-2, shape), jnp.bfloat16)
    m = rng.normal(0, 1e-3, shape).astype(np.float32)
    v = rng.uniform(0, 1e-4, shape).astype(np.float32)
    scale = np.float32(0.7)
    step = 3
    lr = (jopt.warmup_cosine(1e-3, 10, 100) if scheduled else 1e-3)
    opt = jopt.adam(lr, weight_decay=weight_decay)
    state = {"step": jnp.asarray(step, jnp.int32), "mu": {"w": jnp.asarray(m)},
             "nu": {"w": jnp.asarray(v)}}
    grads = jax.tree.map(lambda x: x * jnp.asarray(scale), {"w": g})
    upd, new_state = opt.update(grads, state, {"w": p})
    want = jopt.apply_updates({"w": p}, upd)["w"]

    tp, tg = (to_torch(np.asarray(x), "cpu") for x in (p, g))
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    step_f = torch.tensor(float(step + 1))
    bc1 = 1 - torch.pow(torch.full((), 0.9), step_f)
    bc2 = 1 - torch.pow(torch.full((), 0.999), step_f)
    tlr = (warmup_cosine(1e-3, 10, 100)(torch.tensor(step + 1))
           if scheduled else 1e-3)
    adam_step_ref_(tp, tg, tm, tv, torch.tensor(scale), torch.tensor(True),
                   bc1, bc2, lr=tlr, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=weight_decay)
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(new_state["mu"]["w"]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(new_state["nu"]["w"]))


def test_adam_init_keeps_float32_moments_for_bf16_leaves():
    params = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": torch.zeros((4,))}
    state = adam(1e-3).init(params)
    assert state["mu"]["w"].dtype == state["nu"]["w"].dtype == torch.float32
    assert state["mu"]["b"].dtype == torch.float32
    low = adam(1e-3, moment_dtype=torch.bfloat16).init(params)
    assert low["mu"]["w"].dtype == low["mu"]["b"].dtype == torch.bfloat16


def test_adam_wrapper_refuses_other_mixes():
    from repro_torch.kernels.adam import ops
    one = torch.ones(())
    ok = torch.ones((), dtype=torch.bool)
    bf, f32 = torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8)
    ops._check(bf, bf, f32, f32, one, ok, one, one, 1e-3)
    ops._check(f32, f32, bf, bf, one, ok, one, one, 1e-3)
    for p, g, m in ((bf, bf, bf), (bf, f32, f32), (f32, bf, f32),
                    (torch.zeros(8, dtype=torch.float16),) * 2 + (f32,)):
        with pytest.raises(TypeError):
            ops._check(p, g, m, m.clone(), one, ok, one, one, 1e-3)


# -- the vocabulary search ---------------------------------------------------

def test_vocabulary_search_matches_reference():
    mpe = dict(lam=1e-5, embed_std=0.02)
    jmpe, tmpe = JMPEConfig(**mpe), MPEConfig(**mpe)
    jcfg, cfg, params, buffers, tp, tb = reference_lm(
        "internlm2-1.8b", compressor="mpe_search", comp_cfg=jmpe._asdict(),
        embed_std=0.02)
    assert tuple(tp["embedding"]["emb"].shape) == (cfg.vocab, cfg.d_model)
    want, got, ref, _ = lm_losses(jcfg, cfg, params, buffers, tp, tb, 3,
                                  mpe_cfg=tmpe)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    trained = ref.carry["params"]["embedding"]
    jbits = np.asarray(jsample_group_bits(trained, jmpe))
    bits = sample_group_bits(to_torch(np_tree(trained), "cpu"), tmpe)
    np.testing.assert_array_equal(bits.numpy(), jbits)
