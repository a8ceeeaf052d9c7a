"""Port parity for the packed export: frequency groups, Eq. 11 sampling and
``build_packed_table`` are bit-equal to the JAX reference, and the storage
accounting agrees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as jinference
from repro.core import mpe as jmpe
from repro.core import sampling as jsampling
from repro.core.compressors import Packed as JPacked
from repro_torch.core import inference, mpe, sampling
from repro_torch.core.compressors import Packed

CFG = mpe.MPEConfig(group_size=16)
JCFG = jmpe.MPEConfig(group_size=16)


def _freqs(rng, n):
    # integer counts: many ties, so the stable order matters
    return rng.zipf(1.3, n).astype(np.float64)


@pytest.mark.parametrize("n", [1, 100, 1000, 4099])
def test_make_groups_bit_equal(n, rng):
    freqs = _freqs(rng, n)
    gof, sums = mpe.make_groups(freqs, 16)
    jgof, jsums = jmpe.make_groups(freqs, 16)
    np.testing.assert_array_equal(gof.numpy(), np.asarray(jgof))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    assert gof.dtype == torch.int32 and sums.dtype == torch.float32


@pytest.mark.parametrize("scale", [0.003, 0.01, 0.1])
def test_sample_group_bits_bit_equal(scale, rng):
    gamma = (scale * rng.normal(0, 1, (500, len(CFG.bits)))).astype(np.float32)
    got = sampling.sample_group_bits({"gamma": torch.from_numpy(gamma)}, CFG)
    want = jsampling.sample_group_bits({"gamma": jnp.asarray(gamma)}, JCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gof, _ = mpe.make_groups(_freqs(rng, 8000), 16)     # 500 groups
    fb = sampling.feature_bits(got, gof)
    jfb = jsampling.feature_bits(want, jnp.asarray(gof.numpy()))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jfb))
    assert sampling.average_bits(fb, CFG) == jsampling.average_bits(jfb, JCFG)
    assert sampling.storage_ratio(fb, CFG) == jsampling.storage_ratio(jfb, JCFG)


def test_expected_bits_and_probabilities_match(rng):
    n = 3000
    gof, sums = mpe.make_groups(_freqs(rng, n), 16)
    gamma = (0.01 * rng.normal(0, 1, (sums.shape[0], 7))).astype(np.float32)
    p = mpe.MPESearchEmbedding.probabilities({"gamma": torch.from_numpy(gamma)},
                                             CFG)
    jp = jmpe.MPESearchEmbedding.probabilities({"gamma": jnp.asarray(gamma)},
                                               JCFG)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    eb = mpe.MPESearchEmbedding.expected_bits(
        {"gamma": torch.from_numpy(gamma)}, {"group_of_feature": gof}, CFG)
    jeb = jmpe.MPESearchEmbedding.expected_bits(
        {"gamma": jnp.asarray(gamma)},
        {"group_of_feature": jnp.asarray(gof.numpy())}, JCFG)
    np.testing.assert_allclose(float(eb), float(jeb), rtol=1e-6)


def test_search_init_shapes_and_alpha():
    gen = torch.Generator().manual_seed(0)
    params, buffers = mpe.MPESearchEmbedding.init(gen, 300, 16,
                                                  np.ones(300), CFG)
    jparams, _ = jmpe.MPESearchEmbedding.init(jax.random.PRNGKey(0), 300, 16,
                                              np.ones(300), JCFG)
    for k in ("emb", "gamma", "alpha", "beta"):
        assert tuple(params[k].shape) == tuple(jparams[k].shape)
    np.testing.assert_array_equal(params["alpha"].numpy(),
                                  np.asarray(jparams["alpha"]))
    assert float(params["emb"].std()) == pytest.approx(3e-3, rel=0.1)
    assert buffers["group_of_feature"].shape == (300,)


def _export_inputs(rng, n, d, n_groups_scale=0.01):
    freqs = _freqs(rng, n)
    gof, sums = mpe.make_groups(freqs, 16)
    gamma = (n_groups_scale * rng.normal(0, 1, (sums.shape[0], 7))
             ).astype(np.float32)
    gb = sampling.sample_group_bits({"gamma": torch.from_numpy(gamma)}, CFG)
    fb = sampling.feature_bits(gb, gof).numpy()
    emb = rng.normal(0, 3e-3, (n, d)).astype(np.float32)
    alpha = np.asarray([0.7, 5e-3, 3e-3, 2e-3, 1.5e-3, 1e-3, 7e-4], np.float32)
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    return emb, fb, alpha, beta


def _assert_tables_equal(table, meta, jtable, jmeta):
    assert meta == {"bits": tuple(jmeta["bits"]), "d": jmeta["d"],
                    "n": jmeta["n"]}
    assert sorted(table["subtables"]) == sorted(jtable["subtables"])
    for k, sub in table["subtables"].items():
        want = np.asarray(jtable["subtables"][k])
        assert sub.dtype == torch.int32
        np.testing.assert_array_equal(sub.numpy().view(np.uint32), want)
    for k in ("local_idx", "width_idx", "alpha", "beta"):
        np.testing.assert_array_equal(table[k].numpy(), np.asarray(jtable[k]))
        assert table[k].numpy().dtype == np.asarray(jtable[k]).dtype
    assert (inference.packed_storage_bytes(table)
            == jinference.packed_storage_bytes(jtable))


@pytest.mark.parametrize("n,d", [(500, 16), (3000, 16), (2000, 8), (777, 50)])
def test_build_packed_table_byte_identical(n, d, rng):
    emb, fb, alpha, beta = _export_inputs(rng, n, d)
    table, meta = inference.build_packed_table(
        torch.from_numpy(emb), torch.from_numpy(fb), torch.from_numpy(alpha),
        torch.from_numpy(beta), CFG)
    jtable, jmeta = jinference.build_packed_table(emb, fb, alpha, beta, JCFG)
    _assert_tables_equal(table, meta, jtable, jmeta)


@pytest.mark.parametrize("multiple", [8, 64, 512])
def test_build_packed_table_pad_multiple(multiple, rng):
    emb, fb, alpha, beta = _export_inputs(rng, 1200, 16)
    args = (torch.from_numpy(emb), torch.from_numpy(fb),
            torch.from_numpy(alpha), torch.from_numpy(beta), CFG)
    table, meta = inference.build_packed_table(*args, row_pad_multiple=multiple)
    jtable, jmeta = jinference.build_packed_table(emb, fb, alpha, beta, JCFG,
                                                  row_pad_multiple=multiple)
    _assert_tables_equal(table, meta, jtable, jmeta)


def test_build_packed_table_row_capacities(rng):
    emb, fb, alpha, beta = _export_inputs(rng, 1500, 16)
    counts = np.bincount(fb, minlength=7)
    caps = {f"b{b}": int(counts[i]) + 13 * i for i, b in enumerate(CFG.bits)
            if b}
    args = (torch.from_numpy(emb), torch.from_numpy(fb),
            torch.from_numpy(alpha), torch.from_numpy(beta), CFG)
    table, meta = inference.build_packed_table(*args, row_capacities=caps)
    jtable, jmeta = jinference.build_packed_table(emb, fb, alpha, beta, JCFG,
                                                  row_capacities=caps)
    _assert_tables_equal(table, meta, jtable, jmeta)
    full = int(np.argmax(counts[1:])) + 1
    tight = dict(caps, **{f"b{CFG.bits[full]}": int(counts[full]) - 1})
    with pytest.raises(ValueError, match="pinned capacity"):
        inference.build_packed_table(*args, row_capacities=tight)
    with pytest.raises(ValueError, match="pinned capacity"):
        jinference.build_packed_table(emb, fb, alpha, beta, JCFG,
                                      row_capacities=tight)


def test_storage_ratio_matches(rng):
    emb, fb, alpha, beta = _export_inputs(rng, 2500, 16)
    table, meta = inference.build_packed_table(
        torch.from_numpy(emb), torch.from_numpy(fb), torch.from_numpy(alpha),
        torch.from_numpy(beta), CFG)
    jtable, jmeta = jinference.build_packed_table(emb, fb, alpha, beta, JCFG)
    got = Packed.storage_ratio(table, {"meta": meta}, None)
    want = JPacked.storage_ratio(jtable, {"meta": jmeta}, None)
    assert got == want
    assert sampling.storage_ratio(torch.from_numpy(fb), CFG) == \
        jsampling.storage_ratio(fb, JCFG)


@pytest.mark.parametrize("n", [0, 7, 100, 5_000, 100_000, 34_223_104])
def test_pad_rules_match(n):
    for widths in (1, 6, 8):
        assert (inference._auto_pad_multiple(n, widths)
                == jinference._auto_pad_multiple(n, widths))
    for multiple in (8, 512):
        assert inference._pad_rows(n, multiple) == \
            jinference._pad_rows(n, multiple)
