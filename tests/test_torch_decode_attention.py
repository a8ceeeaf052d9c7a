"""Port parity for decode attention's plain version (``ref.py``: the path
CPU tensors take and the yardstick the CUDA kernel of
``csrc/decode_attention.cu`` is held against on the card) at the shapes
the kernel's redesign targets: internlm2's grouping (two query heads a kv
head), rows whose lengths fall on the kernel's chunk edges (1, chunk - 1,
chunk, chunk + 1 and T, with chunk the kernel's 2,048 keys), int8 caches
with their scales (bf16 and float32 queries) and bf16 caches, against
``repro.nn.attention.gqa_attention`` over the cache dequantized by
``repro.core.quantizer.dequantize_symmetric``.

Tolerances: float32 queries within rtol = atol = 3e-5 (the kernel's
contract: float32 logits and sums in other orders); bf16 queries within
one bf16 ulp of the output plus one bf16 step (2^-8) of each probability
weighted by |v| — both round float32 probabilities to bf16, and the two
frameworks' float32 sums, taken in other orders, move one across a
rounding boundary now and then.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import dequantize_symmetric
from repro.nn.attention import gqa_attention
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

CHUNK = 2048                        # kChunk in csrc/decode_attention.cu
T = 3 * CHUNK + 5
LENGTHS = (1, CHUNK - 1, CHUNK, CHUNK + 1, T)
HQ, HKV = 4, 2                      # group 2, as internlm2-1.8b's 16 / 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _case(rng, kind, hd):
    b = len(LENGTHS)
    if kind.startswith("int8"):
        k, v = (rng.integers(-127, 128, (b, T, HKV, hd), dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.05, (b, 1, HKV, 1)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(0, 1, (b, T, HKV, hd)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    q = rng.normal(0, 1, (b, 1, HQ, hd)).astype(np.float32)
    valid = np.asarray(LENGTHS, np.int32)
    return q, k, v, ks, vs, valid


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("kind", ["int8 q bf16", "int8 q f32", "bf16"])
def test_decode_attention_ref_matches_reference_at_chunk_edges(rng, kind, hd):
    q, k, v, ks, vs, valid = _case(rng, kind, hd)
    q_dtype = (torch.float32, jnp.float32) if kind == "int8 q f32" else \
        (torch.bfloat16, jnp.bfloat16)
    off = valid - 1
    tq = torch.from_numpy(q).to(q_dtype[0])
    jq = jnp.asarray(q).astype(q_dtype[1])
    if kind == "bf16":
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
        jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
        tks = tvs = None
    else:
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
        jk = dequantize_symmetric(jnp.asarray(k), jnp.asarray(ks), q_dtype[1])
        jv = dequantize_symmetric(jnp.asarray(v), jnp.asarray(vs), q_dtype[1])
    got = ops.decode_attention(tq, tk, tv, tks, tvs, q_offset=torch.from_numpy(off),
                               kv_valid_len=torch.from_numpy(valid))
    assert got.dtype == q_dtype[0] and got.shape == tq.shape
    want = gqa_attention(jq, jk, jv, n_heads=HQ, n_kv_heads=HKV, causal=True,
                         q_offset=jnp.asarray(off),
                         kv_valid_len=jnp.asarray(valid))
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if kind == "int8 q f32":
        np.testing.assert_allclose(g, w, rtol=3e-5, atol=3e-5)
    else:
        weight = decode_attention_ref(tq, tk, tv.abs(), tks, tvs,
                                      torch.from_numpy(off),
                                      torch.from_numpy(valid)).float().numpy()
        tol = _bf16_ulp(w) + 2.0 ** -8 * weight
        assert (np.abs(g - w) <= tol).all(), float(np.abs(g - w).max())
    # a row of length 1 attends to its one key: its dequantized value row
    assert np.isfinite(g).all()
    np.testing.assert_array_equal(
        g[0, 0, :HQ // HKV], np.broadcast_to(
            np.asarray(jv[0, 0, 0].astype(jnp.float32)), (HQ // HKV, hd)))


def test_ref_reads_only_each_rows_valid_keys(rng):
    """Keys past a row's bound change nothing: the plain version at the
    chunk edges with the cache past every bound overwritten."""
    q, k, v, ks, vs, valid = _case(rng, "int8 q bf16", 16)
    args = [torch.from_numpy(x) for x in (k, v)]
    tq = torch.from_numpy(q).to(torch.bfloat16)
    off, val = torch.from_numpy(valid - 1), torch.from_numpy(valid)
    first = decode_attention_ref(tq, *args, torch.from_numpy(ks),
                                 torch.from_numpy(vs), off, val)
    for i, n in enumerate(valid):
        args[0][i, n:] = 127
        args[1][i, n:] = -127
    again = decode_attention_ref(tq, *args, torch.from_numpy(ks),
                                 torch.from_numpy(vs), off, val)
    assert torch.equal(first, again)
