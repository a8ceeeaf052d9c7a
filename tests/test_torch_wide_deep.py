"""Wide & Deep in the port against the reference's, on the CPU, at the
reduced config (6 fields × 1,000 ids, d=32, MLP (64, 32)), from parameters
the reference makes and the carrier brings over:

- ``apply`` (train and eval), ``loss_fn`` and its gradients under the
  ``plain`` and ``mpe_search`` compressors (loss rtol 1e-5; gradients rtol
  1e-4, atol 1e-6 times the largest gradient of the tree, as for DLRM: sums
  over the batch in another order, and the biases in front of BatchNorm
  get gradients of rounding size), the wide part and its bias non-zero;
- a 3-step ``Trainer`` trajectory under ``mpe_search`` at loss rtol 1e-4;
- the port's reduced MPE pipeline through ``launch.train --arch wide-deep``:
  its packed table served by ``WideDeep.apply`` under the ``packed``
  compressor gives the retrained model's logits (rtol = atol = 1e-5), its
  lookup the retrain layer's quantized rows (atol 1e-6); the config is the
  reference's, full and reduced.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.models.wide_deep import WideDeep as JWideDeep
from repro.train.loop import Trainer as JTrainer
from repro.train.optimizer import adam as jadam
from repro_torch.configs.base import get_arch
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.sampling import MPERetrainEmbedding
from repro_torch.interop import model_from_numpy
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref
from repro_torch.launch import train as launch_train
from repro_torch.models.wide_deep import WideDeep
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten
from test_torch_train import assert_tree_close, np_tree, torch_batch

LAM = 3e-5
PRE_BN_BIASES = ("layers/0/bias", "layers/1/bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_configs(compressor):
    comp_cfg = {"group_size": 16, "lam": LAM} if compressor == "mpe_search" else {}
    jcfg = jget_arch("wide-deep").make_config(True)._replace(
        compressor=compressor, comp_cfg=comp_cfg)
    cfg = get_arch("wide-deep").make_config(True)._replace(
        compressor=compressor, comp_cfg=comp_cfg)
    return jcfg, cfg


def reference_model(compressor, seed=0):
    jcfg, cfg = both_configs(compressor)
    ds = JSyntheticCTR(JCTRSpec(field_vocabs=tuple(f.vocab for f in jcfg.fields),
                                batch_size=256, seed=seed))
    params, buffers, state = JWideDeep.init(jax.random.PRNGKey(seed), jcfg,
                                            ds.expected_frequencies())
    params, buffers, state = np_tree(params), np_tree(buffers), np_tree(state)
    rng = np.random.default_rng(seed)
    params["wide"] = rng.normal(0, 0.05, params["wide"].shape).astype(np.float32)
    params["wide_bias"] = np.float32(0.1)
    if compressor == "mpe_search":
        emb = params["embedding"]
        emb["gamma"] = (0.01 * rng.normal(0, 1, emb["gamma"].shape)).astype(np.float32)
        emb["beta"] = rng.normal(0, 1e-4, emb["beta"].shape).astype(np.float32)
    for st in state["mlp"]["bn"]:
        st["mean"] = rng.normal(0, 0.05, st["mean"].shape).astype(np.float32)
    return jcfg, cfg, params, buffers, state, ds


def test_config_is_the_reference_config():
    for reduced in (False, True):
        want = jget_arch("wide-deep").make_config(reduced)
        got = get_arch("wide-deep").make_config(reduced)
        assert [f.vocab for f in got.fields] == [f.vocab for f in want.fields]
        assert (got.d_embed, got.mlp_hidden, got.compressor) == (
            want.d_embed, want.mlp_hidden, want.compressor)
    full = get_arch("wide-deep").make_config()
    assert sum(f.vocab for f in full.fields) == 41_943_040 and len(full.fields) == 40


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("compressor", ["plain", "mpe_search"])
def test_apply_loss_and_grads_match_reference(compressor, train):
    jcfg, cfg, params, buffers, state, ds = reference_model(compressor)
    batch = ds.batch(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, want_state, _ = JWideDeep.apply(params, buffers, state, jb,
                                                 jcfg, train=train)

    def jloss(p, s):
        return JWideDeep.loss_fn(p, buffers, s, jb, jcfg, lam=LAM, train=train)
    (want_loss, (_, want_ce)), want_grads = jax.value_and_grad(
        jloss, has_aux=True)(params, state)

    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    tb = torch_batch(batch)
    logits, new_state, _ = WideDeep.apply(t_params, t_buffers, t_state, tb, cfg,
                                          train=train)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-6)
    assert_tree_close(new_state, np_tree(want_state), rtol=1e-5, atol=1e-6)
    flat = [p.requires_grad_(True) for p in leaves(t_params)]
    loss, (_, ce) = WideDeep.loss_fn(t_params, t_buffers, t_state, tb, cfg,
                                     lam=LAM, train=train)
    grads = unflatten(t_params, list(torch.autograd.grad(loss, flat)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    skip = PRE_BN_BIASES if train else ()
    assert_tree_close(grads, want_grads, rtol=1e-4, atol=1e-6, skip=skip)
    assert float(np.abs(np.asarray(want_grads["wide"])).max()) > 0


def test_trainer_trajectory_matches_reference():
    jcfg, cfg, params, buffers, state, ds = reference_model("mpe_search", seed=1)

    def jloss(p, bu, st, batch, *, step=None):
        return JWideDeep.loss_fn(p, bu, st, batch, jcfg, lam=LAM, step=step)

    def tloss(p, bu, st, batch, *, step=None):
        return WideDeep.loss_fn(p, bu, st, batch, cfg, lam=LAM, step=step)
    ref = JTrainer(jloss, jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, buffers),
                   jax.tree.map(jnp.asarray, state), jadam(1e-3), donate=False)
    want = []
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in ds.batch(s).items()}
        ref.carry, out = ref._train_step(ref.carry, batch, jnp.asarray(s))
        want.append(float(out["loss"]))
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    port = Trainer(tloss, t_params, t_buffers, t_state, adam(1e-3))
    port.run(ds.batch, 3, log_every=0)
    np.testing.assert_allclose([h["loss"] for h in port.history], want,
                               rtol=1e-4)
    assert not any(h["skipped"] for h in port.history)


def test_pipeline_table_served_equals_retrained_model():
    """The reduced pipeline through the launcher; its packed table served by
    ``WideDeep.apply`` under ``packed`` gives the retrained model's logits
    (the export's codes are the retrain layer's quantizer), and its lookup
    is the plain version's (on the CPU the wrapper runs it)."""
    res = launch_train.main(["--arch", "wide-deep", "--reduced", "--device",
                             "cpu", "--steps", "4", "--batch", "256"])
    cfg, table, meta = res["cfg"], res["packed_table"], res["packed_meta"]
    assert len(res["search_history"]) == len(res["retrain_history"]) == 4
    assert all(np.isfinite(h["loss"]) for h in res["search_history"]
               + res["retrain_history"])
    served_cfg = cfg._replace(compressor="packed",
                              comp_cfg={"bits": meta["bits"], "d": meta["d"],
                                        "n": meta["n"]})
    params = {**res["final_params"], "embedding": table}
    buffers = {"offsets": res["buffers"]["offsets"], "embedding": {"meta": meta}}
    ds = JSyntheticCTR(JCTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                                batch_size=300, seed=7))
    batch = torch_batch(ds.batch(0))
    retrain_cfg = cfg._replace(compressor="mpe_retrain",
                               comp_cfg=MPEConfig(lam=LAM)._asdict())
    with torch.no_grad():
        got, _, _ = WideDeep.apply(params, buffers, res["state"], batch,
                                   served_cfg)
        want, _, _ = WideDeep.apply(res["final_params"], res["buffers"],
                                    res["state"], batch, retrain_cfg)
        gids = (batch["ids"] + buffers["offsets"][None, :]).reshape(-1)
        emb = packed_lookup_ref(table, meta, gids)
        retrained = MPERetrainEmbedding.lookup(
            res["final_params"]["embedding"], res["buffers"]["embedding"],
            gids, MPEConfig(lam=LAM))
    assert got.shape == (300,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb.numpy(), retrained.numpy(), rtol=0, atol=1e-6)
