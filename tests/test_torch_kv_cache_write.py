"""Port parity on the CPU for the LM's one-call KV-cache write,
``kernels/kv_cache_write/ops.py::kv_cache_write_kv``, which writes a
layer's keys and values together (one kernel launch at decode on the
card; on the CPU the plain version, keys then values).

- int8 caches: both caches' codes on the valid prefix and both scales
  bit-identical to the reference's ``LM._requant_cache`` applied to each,
  at a first write, grown, kept and recycled scales, a slot at
  ``max_len``, a length past ``T - s``, one shared length, and a write
  wider than the decode route (``s * hd > SMALL_WORK``);
- float32 and bf16 caches: both bit-identical to the reference's
  ``LM._cache_write``, the start clamped, per-row and shared lengths;
- the route's kernel count (``kernels_a_call``), no launch counted on the
  CPU, keys and values that differ refused;
- ``LM.decode_step_slotted`` writes each layer's caches in one call, and
  its greedy tokens over recycled slots are the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models.lm import LM as JLM
from repro_torch.configs.base import get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.kernels.kv_cache_write import ops as kvw_ops
from repro_torch.models.lm import LM
from repro_torch.models.lm import transformer as transformer_module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def _int8_case(rng, b, t_max, h, hd, s, loud):
    cache = rng.integers(-127, 128, (b, t_max, h, hd)).astype(np.int8)
    scale = rng.uniform(0.02, 0.04, (b, 1, h, 1)).astype(np.float32)
    mag = np.where(np.asarray(loud)[:, None, None, None], 6.0, 0.05)
    vals = (rng.normal(0, 1, (b, s, h, hd)) * mag).astype(np.float32)
    return cache, scale, vals


def _valid_prefix_equal(got, want, lens, s, t_max):
    for row, n in enumerate(np.broadcast_to(lens, (got.shape[0],))):
        end = min(max(int(n), 0) + s, t_max)
        np.testing.assert_array_equal(got[row, :end], want[row, :end])


INT8_CASES = {
    "first": ([0, 0, 0, 0], 5),
    "grown": ([5, 7, 2, 9], 1),
    "kept": ([5, 7, 2, 9], 1),
    "recycled": ([5, 0, 2, 0], 1),
    "at_max_len": ([12, 11, 12, 3], 1),
    "past_t_minus_s": ([10, 11, 9, 4], 3),
    "shared_len": (6, 1),
    "wide": ([0, 2, 4, 1], 8),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_kv_pair_write_is_the_references_on_both_caches(rng, case):
    lens, s = INT8_CASES[case]
    b, t_max, h = 4, 12, 3
    hd = 1024 if case == "wide" else 8        # s * hd past SMALL_WORK
    loud_k = [case != "kept" and i % 2 == 0 for i in range(b)]
    loud_v = [case == "grown" or i == 3 for i in range(b)]
    if case == "kept":
        loud_v = [False] * b
    kc, ks, kx = _int8_case(rng, b, t_max, h, hd, s, loud_k)
    vc, vs, vx = _int8_case(rng, b, t_max, h, hd, s, loud_v)
    lens = np.asarray(lens, np.int32)
    step = jax.jit(JLM._requant_cache)
    want = [step(c, sc, x, lens) for c, sc, x in ((kc, ks, kx),
                                                   (vc, vs, vx))]
    got = [t(kc), t(ks), t(vc), t(vs)]
    n = kvw_ops.kv_cache_write.launches
    ck, cv = kvw_ops.kv_cache_write_kv(got[0], got[1], t(kx), got[2], got[3],
                                       t(vx), t(lens))
    assert kvw_ops.kv_cache_write.launches == n     # the CPU launches nothing
    assert ck is got[0] and cv is got[2]
    for (c, sc), (wc, ws) in zip(((got[0], got[1]), (got[2], got[3])), want):
        np.testing.assert_array_equal(sc.numpy(), np.asarray(ws))
        _valid_prefix_equal(c.numpy(), np.asarray(wc), lens, s, t_max)
    if case == "kept":        # no scale grew: the stored codes stay
        for row, n_row in enumerate(lens):
            np.testing.assert_array_equal(got[0].numpy()[row, :n_row],
                                          kc[row, :n_row])
    if case in ("grown", "recycled"):
        assert (got[1].numpy() > ks).any() and (got[3].numpy() > vs).any()


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_pair_write_into_float_caches_clamps_as_the_reference(rng, per_row,
                                                                dtype):
    b, t_max, h, hd, s = 3, 10, 2, 8, 4
    tdt = getattr(torch, dtype)
    caches = [rng.normal(0, 1, (b, t_max, h, hd)).astype(np.float32)
              for _ in range(2)]
    upd = [rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
           for _ in range(2)]
    start = np.asarray([9, 2, 6], np.int32) if per_row else np.int32(8)
    got = [t(c).to(tdt) for c in caches]
    kvw_ops.kv_cache_write_kv(got[0], None, t(upd[0]), got[1], None,
                              t(upd[1]), t(start))
    step = jax.jit(JLM._cache_write)
    for c, u, g in zip(caches, upd, got):
        want = step(jax.numpy.asarray(c).astype(dtype), u, start)
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(want.astype(jax.numpy.float32)))


def test_kv_pair_write_route_counts_and_refusals(rng):
    assert kvw_ops.SMALL_WORK == 4096
    assert kvw_ops.kernels_a_call(1, 128, torch.int8) == 1
    assert kvw_ops.kernels_a_call(32, 128, torch.int8) == 1
    assert kvw_ops.kernels_a_call(33, 128, torch.int8) == 2
    assert kvw_ops.kernels_a_call(32768, 128, torch.int8) == 2
    assert kvw_ops.kernels_a_call(32768, 128, torch.bfloat16) == 1
    cache = torch.zeros((2, 8, 2, 4), dtype=torch.int8)
    scale = torch.full((2, 1, 2, 1), 0.05)
    vals = torch.ones((2, 1, 2, 4))
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError):
        kvw_ops.kv_cache_write_kv(cache, scale, vals, cache[:, :4].clone(),
                                  scale, vals, lens)
    with pytest.raises(ValueError):
        kvw_ops.kv_cache_write_kv(cache, scale, vals, cache.clone(), scale,
                                  vals.double(), lens)
    with pytest.raises(ValueError):
        kvw_ops.kv_cache_write_kv(cache, None, vals, cache.clone(), None,
                                  vals, lens)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_slotted_decode_writes_a_layer_in_one_call_and_generates_the_references_tokens(
        rng, arch, monkeypatch):
    jcfg = jget_arch(arch).make_config(reduced=True)
    cfg = get_arch(arch).make_config(reduced=True)
    params, buffers = JLM.init(jax.random.PRNGKey(0), jcfg)
    tp, _, tb = model_from_numpy(jax.tree.map(np.asarray, params), {},
                                 jax.tree.map(np.asarray, buffers), cfg,
                                 device="cpu")
    calls = []
    real = transformer_module.kv_cache_write_kv

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(transformer_module, "kv_cache_write_kv", counted)
    b, max_len = 3, 12
    wc = JLM.make_kv_caches(jcfg, b, max_len, jax.numpy.int8)
    wc.pop("len")
    gc = LM.make_kv_caches(cfg, b, max_len, torch.int8)
    gc.pop("len")
    lens = np.asarray([0, 4, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    step = jax.jit(lambda p, x, ln, c: JLM.decode_step_slotted(
        p, buffers, x, ln, c, jcfg))
    for i in range(8):
        wl, wc = step(params, toks, lens, wc)
        gl, gc = LM.decode_step_slotted(tp, tb, t(toks), t(lens), gc, cfg)
        assert len(calls) == cfg.n_layers * (i + 1)
        want = np.asarray(wl).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(gl.numpy().argmax(-1), want)
        toks = want.reshape(b, 1)
        lens = lens + 1
        if i == 4:
            lens[0] = 0                               # a slot recycled
            toks[0, 0] = int(rng.integers(0, cfg.vocab))
