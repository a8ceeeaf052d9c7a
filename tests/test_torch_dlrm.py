"""Port parity for the packed-table DLRM in eval mode: a reference model,
carried into the port by ``model_from_numpy``, gives the same looked-up
embeddings bit for bit and the same logits (rtol 1e-5, atol 1e-6) for all
four backbones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import Packed as JPacked
from repro.embeddings.table import FieldSpec as JFieldSpec
from repro.models.dlrm import DLRM as JDLRM
from repro.models.dlrm import DLRMConfig as JDLRMConfig
from repro_torch.core.compressors import Packed
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy
from repro_torch.models import interactions
from repro_torch.models.dlrm import DLRM, DLRMConfig

VOCABS = (300, 200, 150, 100, 50)
BACKBONES = ("dnn", "dcn", "deepfm", "ipnn")


def configs(backbone, vocabs=VOCABS, hidden=(32, 16)):
    """The same packed DLRM config in both packages."""
    comp_cfg = {"bits": (0, 1, 2, 3, 4, 5, 6), "d": 16, "n": sum(vocabs),
                "group_size": 16}
    kw = dict(d_embed=16, mlp_hidden=hidden, backbone=backbone,
              compressor="packed", comp_cfg=comp_cfg)
    jcfg = JDLRMConfig(fields=tuple(JFieldSpec(f"f{i}", v)
                                    for i, v in enumerate(vocabs)), **kw)
    cfg = DLRMConfig(fields=tuple(FieldSpec(f"f{i}", v)
                                  for i, v in enumerate(vocabs)), **kw)
    return jcfg, cfg


def make_reference_dlrm(backbone, seed=0, vocabs=VOCABS, hidden=(32, 16)):
    """A reference packed DLRM with every eval-mode parameter made non-trivial
    (BatchNorm running stats and scales, biases, cross and FM terms), as
    numpy pytrees, plus both configs."""
    jcfg, cfg = configs(backbone, vocabs, hidden)
    rng = np.random.default_rng(seed)
    freqs = rng.zipf(1.2, sum(vocabs)).astype(np.float64)
    params, buffers, state = JDLRM.init(jax.random.PRNGKey(seed), jcfg, freqs)
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)

    def rand(shape, scale=0.1, loc=0.0):
        return (loc + scale * rng.normal(0, 1, shape)).astype(np.float32)

    for layer in params["mlp"]["layers"]:
        layer["bias"] = rand(layer["bias"].shape)
    params["mlp"]["head"]["bias"] = rand((1,))
    for bn, st in zip(params["mlp"]["bn"], state["mlp"]["bn"]):
        bn["scale"] = rand(bn["scale"].shape, 0.2, 1.0)
        bn["bias"] = rand(bn["bias"].shape)
        st["mean"] = rand(st["mean"].shape, 0.05)
        st["var"] = np.abs(rand(st["var"].shape, 0.3, 1.0)) + 0.05
    if backbone == "dcn":
        params["cross"]["b"] = [rand(b.shape, 1e-3) for b in params["cross"]["b"]]
    if backbone == "deepfm":
        params["fm_linear"] = rand(params["fm_linear"].shape, 0.05)
        params["fm_bias"] = np.asarray(rand((), 0.1))
    return jcfg, cfg, params, state, buffers


def reference_logits(jcfg, params, state, buffers, ids):
    fn = jax.jit(lambda p, s, i: JDLRM.apply(p, buffers, s, {"ids": i}, jcfg,
                                             train=False)[0])
    return np.asarray(fn(params, state, jnp.asarray(ids)))


def _ids(rng, vocabs, n):
    return np.stack([rng.integers(0, v, n) for v in vocabs], 1).astype(np.int32)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_eval_logits_match_reference(backbone, rng):
    jcfg, cfg, params, state, buffers = make_reference_dlrm(backbone)
    ids = _ids(rng, VOCABS, 96)
    want = reference_logits(jcfg, params, state, buffers, ids)
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers, cfg,
                                                    "cpu")
    got = DLRM.apply(t_params, t_buffers, t_state,
                     {"ids": torch.from_numpy(ids)}, cfg)[0].numpy()
    assert got.shape == (96,) and np.isfinite(got).all()
    assert np.std(want) > 1e-3          # the logits carry signal
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_lookup_embeddings_bit_exact(backbone, rng):
    jcfg, cfg, params, state, buffers = make_reference_dlrm(backbone, seed=1)
    t_params, _, t_buffers = model_from_numpy(params, state, buffers, cfg, "cpu")
    gids = _ids(rng, VOCABS, 64) + np.asarray(buffers["offsets"])[None, :]
    want = np.asarray(jax.jit(
        lambda t, i: JPacked.lookup(t, buffers["embedding"], i, jcfg.comp_cfg)
    )(jax.tree.map(jnp.asarray, params["embedding"]), jnp.asarray(gids)))
    got = Packed.lookup(t_params["embedding"], t_buffers["embedding"],
                        torch.from_numpy(gids), cfg.comp_cfg).numpy()
    assert got.shape == (64, len(VOCABS), 16)
    np.testing.assert_array_equal(got, want)


def test_carrier_keeps_packed_bits(rng):
    jcfg, cfg, params, state, buffers = make_reference_dlrm("dnn")
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers, cfg,
                                                    "cpu")
    for k, sub in params["embedding"]["subtables"].items():
        assert sub.dtype == np.uint32
        got = t_params["embedding"]["subtables"][k]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), sub)
    assert t_buffers["embedding"]["meta"] == {"bits": (0, 1, 2, 3, 4, 5, 6),
                                              "d": 16, "n": sum(VOCABS)}
    with pytest.raises(ValueError):   # a compressor the carrier does not know
        model_from_numpy(params, state, buffers,
                         cfg._replace(compressor="hashing"), "cpu")


@pytest.mark.parametrize("backbone", BACKBONES)
def test_port_init_builds_a_servable_model(backbone, rng):
    _, cfg = configs(backbone)
    params, buffers, state = DLRM.init(cfg, rng.zipf(1.2, sum(VOCABS)),
                                       seed=3, device="cpu")
    ids = torch.from_numpy(_ids(rng, VOCABS, 20))
    logits, new_state, reg = DLRM.apply(params, buffers, state, {"ids": ids},
                                        cfg)
    assert float(reg) == 0.0             # eval mode keeps the running stats
    assert all(n is o for n, o in zip(new_state["mlp"]["bn"],
                                      state["mlp"]["bn"]))
    assert logits.shape == (20,) and torch.isfinite(logits).all()
    again = DLRM.init(cfg, rng.zipf(1.2, sum(VOCABS)), seed=3, device="cpu")[0]
    torch.testing.assert_close(again["mlp"]["layers"][0]["kernel"],
                               params["mlp"]["layers"][0]["kernel"])
    ratio = Packed.storage_ratio(params["embedding"], buffers["embedding"],
                                 cfg.comp_cfg)
    assert 0.0 < ratio < 6 / 32 + 1e-9


def test_interactions_match_reference(rng):
    from repro.models import interactions as jinteractions
    emb = rng.normal(0, 0.1, (8, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        interactions.fm_second_order(torch.from_numpy(emb)).numpy(),
        np.asarray(jinteractions.fm_second_order(jnp.asarray(emb))),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        interactions.inner_products(torch.from_numpy(emb)).numpy(),
        np.asarray(jinteractions.inner_products(jnp.asarray(emb))),
        rtol=1e-5, atol=1e-7)


def test_model_init_raises_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("dnn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRM.init(cfg)
    jcfg, cfg, params, state, buffers = make_reference_dlrm("dnn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_from_numpy(params, state, buffers, cfg)
