"""Port parity for flash attention on the CPU: the plain versions that CPU
tensors take (and that the CUDA kernels are held against on the card)
against the reference's oracle and its Pallas kernels in interpret mode, on
the same numpy inputs. Tolerances are the reference's own
(``tests/test_flash_attention.py``):

- the forward and the logsumexp rows: rtol = atol = 3e-5;
- the backward from the stored logsumexp: rtol = atol = 2e-4;
- autograd end to end through the (B, S, H, hd) wrapper, GQA, BST's and
  SASRec's heads: rtol = atol = 5e-4.

The CUDA forward divides by a correctly rounded reciprocal and a fused
correction step (``divide()`` in ``csrc/flash_attention.cu``); a test here
holds that step to the IEEE division with exact arithmetic.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                  flash_attention_fwd_stats,
                                                  flash_attention_pallas)
from repro.kernels.flash_attention.ops import flash_attention_kernel
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jflash_attention_ref
from repro.nn.attention import gqa_attention
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (bwd_ref,
                                                     flash_attention_ref,
                                                     fwd_stats_ref)
from repro_torch.models.lm.transformer import causal_attention

FWD_TOL = dict(rtol=3e-5, atol=3e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
VJP_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, *shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bk", [(32, 8, 8), (64, 16, 32), (64, 64, 64)])
def test_forward_matches_oracle_and_pallas(s, bq, bk, causal):
    q, k, v = inputs(s + bq, 3, s, 16)
    got = ops.flash_attention_fwd(*t(q, k, v), causal).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jflash_attention_ref(q, k, v, causal=causal)), **FWD_TOL)
    np.testing.assert_allclose(
        got, np.asarray(flash_attention_pallas(q, k, v, causal=causal, bq=bq,
                                               bk=bk)), **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_at_sasrec_width(causal):
    """(BH, S, hd) = (2, 50, 50): SASRec's sequence and head width."""
    q, k, v = inputs(7, 2, 50, 50)
    want_o, want_lse = flash_attention_fwd_stats(q, k, v, causal=causal)
    o, lse = ops.flash_attention_fwd_stats(*t(q, k, v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    np.testing.assert_allclose(ops.flash_attention_fwd(*t(q, k, v), causal).numpy(),
                               np.asarray(flash_attention_pallas(
                                   q, k, v, causal=causal)), **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_pallas_over_blocks(causal):
    q, k, v = inputs(3, 3, 64, 16)
    _, want = flash_attention_fwd_stats(q, k, v, causal=causal, bq=16, bk=16)
    _, lse = fwd_stats_ref(*t(q, k, v), causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("shape,blocks", [((3, 64, 16), 16), ((2, 50, 50), 50)],
                         ids=["64x16", "sasrec"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_pallas(shape, blocks, causal):
    """The same (q, k, v, o, lse, do) into both backwards."""
    q, k, v, do = inputs(11, *shape, n=4)
    o, lse = flash_attention_fwd_stats(q, k, v, causal=causal, bq=blocks,
                                       bk=blocks)
    o, lse = np.array(o), np.array(lse)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, bq=blocks,
                               bk=blocks)
    got = ops.flash_attention_bwd(*t(q, k, v, o, lse, do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_autograd_of_the_forward(causal):
    q, k, v, do = t(*inputs(5, 3, 32, 8, n=4))
    o, lse = fwd_stats_ref(q, k, v, causal)
    got = bwd_ref(q, k, v, o, lse, do, causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_attention_ref(*leaves, causal).backward(do)
    for g, x in zip(got, leaves):
        torch.testing.assert_close(g, x.grad, **BWD_TOL)


def _gqa_inputs():
    """The reference's GQA case: 8 query heads over 4 kv heads."""
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (2, 32, 8, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 32, 4, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 32, 4, 16)).astype(np.float32)
    return q, k, v


def test_gqa_wrapper_matches_reference_module():
    q, k, v = _gqa_inputs()
    want = gqa_attention(q, k, v, n_heads=8, n_kv_heads=4, causal=True)
    got = ops.flash_attention(*t(q, k, v), n_kv_heads=4, causal=True)
    assert got.shape == (2, 32, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _head_inputs(b, s, h, hd, n=3):
    rng = np.random.default_rng(s + h)
    return [rng.normal(0, 1, (b, s, h, hd)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("case", ["gqa", "bst", "sasrec"])
def test_autograd_end_to_end_matches_reference_vjp(case):
    """``jax.grad`` of the reference's ``flash_attention_kernel`` (its
    ``custom_vjp`` over the Pallas kernels in interpret mode) against
    autograd through the port's wrapper on (B, S, H, hd), on sum(o²): the
    reference's GQA case (8 query heads over 4 kv heads), BST's heads
    (S 21, 8 heads of width 4, not causal) and SASRec's (S 50, one head of
    width 50, causal)."""
    q, k, v, kv_heads, causal = {
        "gqa": (*_gqa_inputs(), 4, True),
        "bst": (*_head_inputs(3, 21, 8, 4), 8, False),
        "sasrec": (*_head_inputs(2, 50, 1, 50), 1, True),
    }[case]
    s = q.shape[1]
    blocks = 8 if case == "gqa" else s
    want = jax.grad(lambda *a: jnp.sum(
        flash_attention_kernel(*a, causal=causal, bq=blocks, bk=blocks) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    leaves = [x.requires_grad_(True) for x in t(q, k, v)]
    out = ops.flash_attention(*leaves, n_kv_heads=kv_heads, causal=causal)
    assert out.grad_fn is not None
    assert out.shape == q.shape
    torch.sum(out ** 2).backward()
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **VJP_TOL)


@pytest.mark.parametrize("case", ["bst", "sasrec"])
def test_wrappers_take_the_models_layout(case):
    """The three wrappers on (B, S, H, hd), lse (B, H, S), against the Pallas
    kernels on the reference's (B·H, S, hd) flattening of the same arrays."""
    b, s, h, hd, causal = {"bst": (3, 21, 8, 4, False),
                           "sasrec": (2, 50, 1, 50, True)}[case]
    q, k, v, do = _head_inputs(b, s, h, hd, n=4)

    def flat(x):
        return np.moveaxis(x, 2, 1).reshape(b * h, s, hd)

    def heads(x):
        return np.moveaxis(np.asarray(x).reshape(b, h, s, hd), 1, 2)

    want_o, want_lse = flash_attention_fwd_stats(flat(q), flat(k), flat(v),
                                                 causal=causal, bq=s, bk=s)
    o, lse = ops.flash_attention_fwd_stats(*t(q, k, v), causal)
    assert o.shape == (b, s, h, hd) and lse.shape == (b, h, s)
    np.testing.assert_allclose(o.numpy(), heads(want_o), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(b, h, s),
                               **FWD_TOL)
    np.testing.assert_allclose(ops.flash_attention_fwd(*t(q, k, v), causal).numpy(),
                               heads(want_o), **FWD_TOL)
    o, lse = np.ascontiguousarray(o.numpy()), lse.numpy()
    want = flash_attention_bwd(flat(q), flat(k), flat(v), flat(o),
                               lse.reshape(b * h, s), flat(do), causal=causal,
                               bq=s, bk=s)
    got = ops.flash_attention_bwd(*t(q, k, v, o, lse, do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (b, s, h, hd)
        np.testing.assert_allclose(g.numpy(), heads(w), err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_tiled_route_shape_matches_pallas(causal):
    """The yardstick of the tiled route at the LM's head width: (BH, S, hd)
    = (2, 256, 128), two blocks of 128 a side (the reference's bq = bk =
    128), so the online softmax and the backward's sums cross blocks. o
    and lse against ``flash_attention_fwd_stats``, dq, dk, dv against
    ``flash_attention_bwd`` from the same o and lse, all in interpret
    mode."""
    q, k, v, do = inputs(28, 2, 256, 128, n=4)
    want_o, want_lse = flash_attention_fwd_stats(q, k, v, causal=causal,
                                                 bq=128, bk=128)
    o, lse = ops.flash_attention_fwd_stats(*t(q, k, v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)
    np.testing.assert_allclose(
        ops.flash_attention_fwd(*t(q, k, v), causal).numpy(),
        np.asarray(flash_attention_pallas(q, k, v, causal=causal, bq=128,
                                          bk=128)), **FWD_TOL)
    o, lse = np.array(want_o), np.array(want_lse)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, bq=128,
                               bk=128)
    got = ops.flash_attention_bwd(*t(q, k, v, o, lse, do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


def _lm_heads(seed, b, s, hd=128):
    """internlm2's grouped heads: q with 16 heads, k and v with 8."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
            for h in (16, 8, 8)]


def test_gqa_wrapper_at_the_lms_heads():
    """``flash_attention`` at internlm2's 16 query over 8 kv heads of 128,
    S = 256 (the tiled route's shape): o against the reference's
    ``gqa_attention``, and autograd's dq, dk, dv (each kv head's gradient
    summed over its two query heads) against ``jax.grad`` of it, on
    sum(o²)."""
    q, k, v = _lm_heads(16, 1, 256)

    def ref(*a):
        return gqa_attention(*a, n_heads=16, n_kv_heads=8, causal=True)
    np.testing.assert_allclose(
        ops.flash_attention(*t(q, k, v), n_kv_heads=8, causal=True).numpy(),
        np.asarray(ref(q, k, v)), **FWD_TOL)
    want = jax.grad(lambda *a: jnp.sum(ref(*a) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    leaves = [x.requires_grad_(True) for x in t(q, k, v)]
    torch.sum(ops.flash_attention(*leaves, n_kv_heads=8, causal=True) ** 2
              ).backward()
    for name, x, w in zip("qkv", leaves, want):
        assert x.grad.shape == x.shape
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **VJP_TOL)


def test_causal_attention_pads_to_the_blocks():
    """The LM's ``causal_attention`` at S = 200, which it pads to 256 for
    the kernel's blocks: its 200 rows against the reference's
    ``gqa_attention`` on the unpadded sequence (16 over 8 heads of 128)."""
    q, k, v = _lm_heads(200, 2, 200)
    got = causal_attention(*t(q, k, v), n_kv_heads=8)
    assert got.shape == (2, 200, 16, 128)
    want = gqa_attention(q, k, v, n_heads=16, n_kv_heads=8, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_no_grad_takes_the_plain_forward_and_counts_no_launch():
    """Without a gradient the wrapper builds no autograd node; on the CPU
    no kernel is launched, so no counter moves."""
    q, k, v = (x.requires_grad_(True) for x in t(*inputs(1, 2, 16, 4, 8)))
    counts = (ops.flash_attention_fwd.launches,
              ops.flash_attention_fwd_stats.launches,
              ops.flash_attention_bwd.launches)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=True).grad_fn is None
    ops.flash_attention(q, k, v, causal=False).sum().backward()
    assert q.grad is not None
    assert counts == (ops.flash_attention_fwd.launches,
                      ops.flash_attention_fwd_stats.launches,
                      ops.flash_attention_bwd.launches)


def test_rejects_what_the_reference_rejects():
    q = torch.zeros(2, 192, 8)           # 192 is not a multiple of 128
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="BH, S, hd"):
        ops.flash_attention_fwd(q[0], q[0], q[0])
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="n_kv_heads"):
        ops.flash_attention(x, x, x, n_kv_heads=1)
    ok = torch.zeros(1, 256, 4)          # a multiple of the block is taken
    assert ops.flash_attention_fwd(ok, ok, ok).shape == (1, 256, 4)


def _round_f32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even; normal range)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scale = Fraction(2) ** (23 - e)
    m = x * scale
    f, rest = divmod(m.numerator, m.denominator)
    rest = Fraction(rest, m.denominator)
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and f % 2):
        f += 1
    return sign * Fraction(f) / scale


def test_division_step_rounds_as_the_division():
    """The kernels' o = acc / d as q = acc·r, r = RN(1/d), then
    fma(fma(−q, d, acc), r, q): equal to the rounded quotient for every
    divisor d >= 1 the kernels see (a softmax denominator is at least 1)
    and numerators over twelve decades."""
    rng = np.random.default_rng(0)
    for _ in range(4000):
        d = Fraction(float(np.float32(rng.uniform(1.0, 64.0))))
        a = Fraction(float(np.float32(rng.normal() * 10.0 ** rng.integers(-8, 4))))
        r = _round_f32(1 / d)
        q = _round_f32(a * r)
        step = _round_f32(_round_f32(a - q * d) * r + q)
        assert step == _round_f32(a / d), (a, d)
