"""Port parity for the LM's serving path on the CPU: the same numpy inputs
and the reference's own weights (carried with ``interop.model_from_numpy``)
go through ``repro`` and ``repro_torch``.

- the int8 helpers (``quantize_symmetric``, ``requantize_int8``,
  ``dequantize_symmetric``): bit-identical to the jitted reference;
- the KV-cache write (``LM._requant_cache`` / ``LM._cache_write``, the
  plain version of ``kernels/kv_cache_write``): codes and scales
  bit-identical on the valid prefix at a first write, a grown scale, a kept
  scale, a recycled slot and a slot at ``max_len``;
- ``RMSNorm`` and RoPE within 1e-6: jitted XLA sums the squares in its own
  order, takes its own reciprocal square root, ``pow`` and sin/cos, each
  within a float32 ulp or two of torch's;
- ``gqa_attention`` (scalar and per-row offsets and lengths, an extra
  mask) and ``chunked_gqa_attention`` (also with ``expand_kv`` and bf16
  blocks) within 1e-6: XLA's float32 dot products sum in their own order;
- the five LM configs (full and reduced) field for field, ``ALL_ARCHS``,
  ``TokenStream`` batches bit for bit, the initialised trees' shapes and
  dtypes;
- at each reduced config in float32, ``LM.apply``, ``prefill`` (int8 and
  float caches), ``decode_step`` and ``decode_step_slotted``: logits within
  1e-5 (rtol and atol), int8 cache codes on the valid prefix equal, the
  greedy tokens equal; in bf16 (internlm2 reduced) logits within 0.05 of
  the logits' scale: XLA and torch round bf16 products and their
  elementwise chains at other points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_arch as jget_arch
from repro.core import quantizer as jquant
from repro.data.tokens import TokenStream as JTokenStream
from repro.models.lm import LM as JLM
from repro.nn.attention import gqa_attention as jgqa
from repro.nn.chunked import chunked_gqa_attention as jchunked
from repro.nn.norms import RMSNorm as JRMSNorm
from repro.nn.rope import apply_rope as japply_rope
from repro.nn.rope import rope_frequencies as jrope_frequencies
from repro_torch.configs.base import ALL_ARCHS, get_arch
from repro_torch.core import quantizer
from repro_torch.data.tokens import TokenStream
from repro_torch.interop import model_from_numpy, to_torch
from repro_torch.kernels.kv_cache_write.ref import INV127
from repro_torch.models.lm import LM
from repro_torch.nn.attention import gqa_attention
from repro_torch.nn.chunked import chunked_gqa_attention
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rope import apply_rope, rope_frequencies
from repro_torch.train.tree import leaves

LM_ARCHS = ("internlm2-1.8b", "qwen3-32b", "starcoder2-7b",
            "deepseek-moe-16b", "grok-1-314b")
NORM_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


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


def t(x):
    return torch.from_numpy(np.array(x))


def reference_lm(arch: str, dtype: str | None = None, seed: int = 0):
    """The reduced config of ``arch`` in both packages (``dtype`` replaced
    where given), the reference's initialised weights, and the same carried
    into the port."""
    jcfg = jget_arch(arch).make_config(reduced=True)
    cfg = get_arch(arch).make_config(reduced=True)
    if dtype is not None:
        jcfg, cfg = jcfg._replace(dtype=dtype), cfg._replace(dtype=dtype)
    params, buffers = JLM.init(jax.random.PRNGKey(seed), jcfg)
    tp, _, tb = model_from_numpy(np_tree(params), {}, np_tree(buffers), cfg,
                                 device="cpu")
    return jcfg, cfg, params, buffers, tp, tb


def caches_np(caches) -> dict:
    out = {}
    for k, v in caches.items():
        if torch.is_tensor(v):
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[k] = np.asarray(v.astype(jnp.float32)
                                if v.dtype == jnp.bfloat16 else v)
    return out


# -- the int8 helpers and the KV-cache write --------------------------------

def test_the_reciprocal_of_127_is_the_float32_quotient():
    """XLA multiplies by float32(1/127) where the reference divides by the
    constant 127; the kernel's 1.0f / 127.0f is the same float32."""
    assert np.float32(INV127) == np.float32(1) / np.float32(127)
    x = np.random.default_rng(0).uniform(0, 50, 100_000).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: v / 127.0)(x))
    np.testing.assert_array_equal(got, x * np.float32(INV127))


def test_int8_helpers_are_the_references_bit_for_bit(rng):
    vals = (rng.normal(0, 1, (64, 5, 3, 8)) * 5).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, (64, 1, 3, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jquant.quantize_symmetric)(vals, scale))
    got = quantizer.quantize_symmetric(t(vals), t(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    ratio = rng.uniform(0.3, 1.0, (64, 1, 3, 1)).astype(np.float32)
    codes = rng.integers(-127, 128, (64, 7, 3, 8)).astype(np.int8)
    np.testing.assert_array_equal(
        quantizer.requantize_int8(t(codes), t(ratio)).numpy(),
        np.asarray(jax.jit(jquant.requantize_int8)(codes, ratio)))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.jit(lambda q, s: jquant.dequantize_symmetric(
            q, s, jdt))(codes, scale[:, :, :, :1][:, :1].repeat(7, 1)
                        .reshape(64, 7, 3, 1)).astype(jnp.float32))
        got = quantizer.dequantize_symmetric(
            t(codes), t(scale[:, :1].repeat(7, 1).reshape(64, 7, 3, 1)), tdt)
        np.testing.assert_array_equal(got.float().numpy(), want)


def _requant_case(rng, b, t_max, h, hd, s, lens, *, loud):
    cache = rng.integers(-127, 128, (b, t_max, h, hd)).astype(np.int8)
    scale = rng.uniform(0.02, 0.04, (b, 1, h, 1)).astype(np.float32)
    mag = np.where(np.asarray(loud)[:, None, None, None], 6.0, 0.05)
    vals = (rng.normal(0, 1, (b, s, h, hd)) * mag).astype(np.float32)
    return cache, scale, vals, np.asarray(lens, np.int32)


def _valid_prefix_equal(got, want, lens, s, t_max):
    for row, n in enumerate(np.broadcast_to(lens, (got.shape[0],))):
        end = min(int(n) + s, t_max)
        np.testing.assert_array_equal(got[row, :end], want[row, :end])


@pytest.mark.parametrize("case", ["first", "grown", "kept", "recycled",
                                  "at_max_len", "shared_len"])
def test_int8_cache_write_is_the_references_on_the_valid_prefix(rng, case):
    b, t_max, h, hd, s = 4, 12, 3, 8, 1
    lens, loud = {
        "first": ([0, 0, 0, 0], [True, False, True, False]),
        "grown": ([5, 7, 2, 9], [True, True, True, True]),
        "kept": ([5, 7, 2, 9], [False, False, False, False]),
        "recycled": ([5, 0, 2, 0], [True, False, False, True]),
        "at_max_len": ([12, 11, 12, 3], [True, False, True, True]),
        "shared_len": (6, [True, False, False, True]),
    }[case]
    if case == "first":
        s = 5
    cache, scale, vals, lens = _requant_case(rng, b, t_max, h, hd, s, lens,
                                             loud=loud)
    want_c, want_s = jax.jit(JLM._requant_cache)(cache, scale, vals, lens)
    got_c, got_s = LM._requant_cache(t(cache.copy()), t(scale.copy()),
                                     t(vals), t(lens))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    _valid_prefix_equal(got_c.numpy(), np.asarray(want_c), lens, s, t_max)
    if case == "kept":      # no scale grew: the stored codes stay as they are
        for row, n in enumerate(lens):
            np.testing.assert_array_equal(got_c.numpy()[row, :n],
                                          cache[row, :n])
    if case in ("grown", "recycled"):
        assert (got_s.numpy() > scale).any()


@pytest.mark.parametrize("per_row", [False, True])
def test_float_cache_write_clamps_its_start_as_the_reference(rng, per_row):
    b, t_max, h, hd, s = 3, 10, 2, 8, 4
    cache = rng.normal(0, 1, (b, t_max, h, hd)).astype(np.float32)
    upd = rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
    start = np.asarray([9, 2, 6], np.int32) if per_row else np.int32(8)
    want = np.asarray(jax.jit(JLM._cache_write)(cache, upd, start))
    got = LM._cache_write(t(cache.copy()), t(upd), t(start))
    np.testing.assert_array_equal(got.numpy(), want)
    bf = LM._cache_write(torch.zeros((b, t_max, h, hd), dtype=torch.bfloat16),
                         t(upd), t(start))
    want_bf = np.asarray(jax.jit(JLM._cache_write)(
        jnp.zeros((b, t_max, h, hd), jnp.bfloat16), upd, start)
        .astype(jnp.float32))
    np.testing.assert_array_equal(bf.float().numpy(), want_bf)


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 96, 2048])
def test_rmsnorm_matches_reference(rng, d):
    x = rng.normal(0, 1, (64, d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    want = np.asarray(jax.jit(JRMSNorm.apply)({"scale": scale}, x))
    got = RMSNorm.apply({"scale": t(scale)}, t(x))
    np.testing.assert_allclose(got.numpy(), want, **NORM_TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(JRMSNorm.apply)(
        {"scale": jnp.ones(d, jnp.bfloat16)}, xb).astype(jnp.float32))
    got = RMSNorm.apply(RMSNorm.init(d, torch.bfloat16),
                        t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7)


@pytest.mark.parametrize("hd", [16, 128])
def test_rope_matches_reference(rng, hd):
    np.testing.assert_array_equal(rope_frequencies(hd).numpy(),
                                  np.asarray(jax.jit(jrope_frequencies,
                                                     static_argnums=0)(hd)))
    x = rng.normal(0, 1, (2, 37, 3, hd)).astype(np.float32)
    for pos in (np.arange(37, dtype=np.int32)[None],
                (np.arange(37)[None] + np.array([[0], [1000]])).astype(np.int32)):
        want = np.asarray(jax.jit(japply_rope)(x, pos))
        got = apply_rope(t(x), t(pos))
        np.testing.assert_allclose(got.numpy(), want, **NORM_TOL)


def _attention_inputs(rng, b=3, s=4, t_max=11, hq=4, hkv=2, hd=8):
    q = rng.normal(0, 1, (b, s, hq, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, t_max, hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t_max, hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("offsets", ["none", "scalar", "per_row", "mask"])
def test_gqa_attention_matches_reference(rng, offsets):
    q, k, v = _attention_inputs(rng)
    kw = {"none": {},
          "scalar": {"q_offset": np.int32(3), "kv_valid_len": np.int32(7)},
          "per_row": {"q_offset": np.asarray([0, 4, 7], np.int32),
                      "kv_valid_len": np.asarray([4, 8, 11], np.int32)},
          "mask": {"attn_mask": rng.random((3, 4, 11)) < 0.7}}[offsets]
    if offsets == "mask":
        kw["attn_mask"][:, :, 0] = True
    want = np.asarray(jax.jit(lambda q, k, v, kw: jgqa(
        q, k, v, n_heads=4, n_kv_heads=2, causal=True, **kw))(q, k, v, kw))
    got = gqa_attention(t(q), t(k), t(v), n_heads=4, n_kv_heads=2,
                        causal=True, **{n: t(np.asarray(x))
                                        for n, x in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, **NORM_TOL)
    # a bf16 cache: probabilities rounded to bf16 before p·v, as there
    kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    want = np.asarray(jax.jit(lambda q, k, v: jgqa(
        q, k, v, n_heads=4, n_kv_heads=2, causal=False))(q, kb, vb))
    got = gqa_attention(t(q), *(t(np.asarray(x.astype(jnp.float32)))
                                .to(torch.bfloat16) for x in (kb, vb)),
                        n_heads=4, n_kv_heads=2, causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["plain", "expand_kv", "bf16_blocks",
                                     "offset_valid"])
def test_chunked_gqa_attention_matches_reference(rng, variant):
    q, k, v = _attention_inputs(rng, b=2, s=16, t_max=16, hq=4, hkv=2, hd=8)
    kw = dict(q_chunk=4, kv_chunk=8)
    if variant == "expand_kv":
        kw["expand_kv"] = True
    if variant == "offset_valid":
        kw.update(q_offset=0, kv_valid_len=13)
    jkw = dict(kw)
    tkw = dict(kw)
    if variant == "bf16_blocks":
        jkw["block_dtype"], tkw["block_dtype"] = jnp.bfloat16, torch.bfloat16
    want = np.asarray(jax.jit(lambda q, k, v: jchunked(
        q, k, v, n_kv_heads=2, causal=True, **jkw))(q, k, v))
    got = chunked_gqa_attention(t(q), t(k), t(v), n_kv_heads=2, causal=True,
                                **tkw)
    tol = NORM_TOL if variant != "bf16_blocks" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    # and it is the plain attention it bounds the memory of
    whole = gqa_attention(t(q), t(k), t(v), n_heads=4, n_kv_heads=2,
                          causal=True,
                          kv_valid_len=kw.get("kv_valid_len"))
    if variant != "bf16_blocks":
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-5)


# -- configs, tokens, init ----------------------------------------------------

def test_all_archs_and_the_lm_configs_are_the_references():
    assert ALL_ARCHS() == J_ALL_ARCHS()
    for arch in LM_ARCHS:
        assert get_arch(arch).family == "lm"
        assert get_arch(arch).shapes == jget_arch(arch).shapes
        for reduced in (False, True):
            mine = get_arch(arch).make_config(reduced=reduced)._asdict()
            ref = jget_arch(arch).make_config(reduced=reduced)._asdict()
            for d in (mine, ref):
                if d["moe"] is not None:
                    d["moe"] = d["moe"]._asdict()
            assert mine == ref, arch


def test_token_stream_batches_are_the_references():
    for vocab, batch, seq, seed in ((512, 4, 9, 0), (92544, 3, 33, 7)):
        mine, ref = TokenStream(vocab, batch, seq, seed=seed), \
            JTokenStream(vocab, batch, seq, seed=seed)
        np.testing.assert_array_equal(mine.expected_frequencies(),
                                      ref.expected_frequencies())
        for step in (0, 3):
            a, b = mine.batch_at(step), ref.batch_at(step, host_id=0)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == np.int32


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_trees_have_the_references_shapes_and_dtypes(arch):
    jcfg = jget_arch(arch).make_config(reduced=True)._replace(dtype="bfloat16")
    cfg = get_arch(arch).make_config(reduced=True)._replace(dtype="bfloat16")
    jp, jb = JLM.init(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    p, b = LM.init(gen, cfg)
    carried, _, _ = model_from_numpy(np_tree(jp), {}, np_tree(jb), cfg,
                                     device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves(p)) == len(flat_ref)

    def at(tree, path):
        for key in path:
            tree = tree[key.key]
        return tree

    for path, leaf in flat_ref:
        mine, came = at(p, path), at(carried, path)
        assert tuple(mine.shape) == leaf.shape, path
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype), path
        assert came.dtype == mine.dtype, path
        if leaf.dtype == jnp.bfloat16:   # the carried bits are the reference's
            np.testing.assert_array_equal(
                came.view(torch.int16).numpy(),
                np.asarray(leaf).view(np.int16))


def test_int8_expert_weights_carry_as_code_and_scale_pairs():
    jcfg = jget_arch("grok-1-314b").make_config(reduced=True)
    moe = jcfg.moe._replace(expert_weight_int8=True)
    jp, _ = JLM.init(jax.random.PRNGKey(1), jcfg._replace(moe=moe))
    tree = to_torch(np_tree(jp["layers"]["moe"]["experts"]), "cpu")
    for name in ("w_gate", "w_up", "w_down"):
        assert tree[name]["q"].dtype == torch.int8
        np.testing.assert_array_equal(tree[name]["q"].numpy(),
                                      np.asarray(jp["layers"]["moe"]["experts"]
                                                 [name]["q"]))
        assert tree[name]["scale"].dtype == torch.float32


# -- the LM -------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_prefill_and_decode_match_reference(rng, arch):
    jcfg, cfg, params, buffers, tp, tb = reference_lm(arch)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    want, waux, _ = jax.jit(lambda p, x: JLM.apply(p, buffers, x, jcfg))(
        params, toks)
    got, aux, none = LM.apply(tp, tb, t(toks), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)

    for jdt, tdt in ((jnp.int8, torch.int8), (jnp.float32, torch.float32)):
        wl, wc = jax.jit(lambda p, x: JLM.prefill(p, buffers, x, jcfg, 16,
                                                  jdt))(params, toks)
        gl, gc = LM.prefill(tp, tb, t(toks), cfg, 16, tdt)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
        assert int(gc["len"]) == int(wc["len"]) == 9
        assert sorted(gc) == sorted(wc)
        for step in range(3):
            nxt = np.asarray(np.argmax(np.asarray(wl), -1)[:, None], np.int32)
            np.testing.assert_array_equal(
                nxt[:, 0], gl.numpy().argmax(-1))     # greedy tokens equal
            wl, wc = jax.jit(lambda p, x, c: JLM.decode_step(
                p, buffers, x, c, jcfg))(params, nxt, wc)
            gl, gc = LM.decode_step(tp, tb, t(nxt), gc, cfg)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                       **LOGIT_TOL)
        assert int(gc["len"]) == 12
        if tdt == torch.int8:
            got_c, want_c = caches_np(gc), caches_np(wc)
            same = got_c["k"][:, :, :12] == want_c["k"][:, :, :12]
            assert same.mean() > 0.999     # an ulp apart where a code rounds
            np.testing.assert_allclose(got_c["k_scale"], want_c["k_scale"],
                                       rtol=1e-6)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("kv", ["int8", "float32"])
def test_decode_step_slotted_matches_reference(rng, arch, kv):
    jcfg, cfg, params, buffers, tp, tb = reference_lm(arch)
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "float32": (jnp.float32, torch.float32)}[kv]
    b, max_len = 3, 12
    wc = JLM.make_kv_caches(jcfg, b, max_len, jdt)
    wc.pop("len")
    gc = LM.make_kv_caches(cfg, b, max_len, tdt)
    gc.pop("len")
    lens = np.asarray([0, 4, 0], np.int32)
    step = jax.jit(lambda p, x, ln, c: JLM.decode_step_slotted(
        p, buffers, x, ln, c, jcfg))
    for _ in range(6):
        toks = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        wl, wc = step(params, toks, lens, wc)
        gl, gc = LM.decode_step_slotted(tp, tb, t(toks), t(lens), gc, cfg)
        assert "len" not in gc
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
        lens = lens + 1
        lens[2] = 0 if lens[1] % 3 == 0 else lens[2]   # a slot recycled


def test_bf16_lm_within_its_stated_tolerance(rng):
    jcfg, cfg, params, buffers, tp, tb = reference_lm("internlm2-1.8b",
                                                      "bfloat16")
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    wl, wc = jax.jit(lambda p, x: JLM.prefill(p, buffers, x, jcfg, 16,
                                              jnp.int8))(params, toks)
    gl, gc = LM.prefill(tp, tb, t(toks), cfg, 16, torch.int8)
    assert gl.dtype == torch.bfloat16 and gc["k"].dtype == torch.int8
    want = np.asarray(wl.astype(jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(gl.float().numpy(), want, atol=0.05 * scale)
    nxt = np.argmax(want, -1)[:, None].astype(np.int32)
    wl, _ = jax.jit(lambda p, x, c: JLM.decode_step(p, buffers, x, c, jcfg))(
        params, nxt, wc)
    gl, _ = LM.decode_step(tp, tb, t(nxt), gc, cfg)
    np.testing.assert_allclose(gl.float().numpy(),
                               np.asarray(wl.astype(jnp.float32)),
                               atol=0.05 * scale)


def test_make_kv_caches_is_the_references():
    jcfg = jget_arch("qwen3-32b").make_config(reduced=True)
    cfg = get_arch("qwen3-32b").make_config(reduced=True)
    for jdt, tdt in ((jnp.int8, torch.int8), (jnp.bfloat16, torch.bfloat16)):
        want = JLM.make_kv_caches(jcfg, 3, 20, jdt, prefill_len=2)
        got = LM.make_kv_caches(cfg, 3, 20, tdt, prefill_len=2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(caches_np(got)[k],
                                          caches_np(want)[k])


def test_the_returned_caches_are_the_caches_passed_in(rng):
    """Parted by design: the port writes k, v and the scales in place; the
    reference returns new arrays."""
    _, cfg, _, _, tp, tb = reference_lm("internlm2-1.8b")
    caches = LM.make_kv_caches(cfg, 2, 8, torch.int8)
    toks = t(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
    _, new = LM.decode_step(tp, tb, toks, caches, cfg)
    for k in ("k", "v", "k_scale", "v_scale"):
        assert new[k] is caches[k]
    assert int(new["len"]) == 1 and int(caches["len"]) == 0
