"""Port parity for the Eq. 9 mixture and its gradients.

- ``lsq_quantize`` (an ``autograd.Function`` with the Eq. 4–6 STE) against
  ``jax.vjp`` of the reference's jitted ``lsq_quantize``: the forward and the
  theta gradient to rtol 1e-5 / atol 1e-7 (the jitted reference may place
  its fused multiply-adds elsewhere), alpha and beta gradients, which are
  sums, to rtol 1e-4 / atol 1e-6.
- The plain forward and backward of ``kernels/mpe_qat/ref.py`` against the
  reference's Pallas kernels in interpret mode and against ``jax.vjp`` of
  its jitted ``mixed_expectation``: forward at the kernel contract rtol 1e-5
  / atol 1e-7, the backward at rtol 1e-4 / atol 1e-6
  (``tests/test_kernels.py``), the reductions being summed in another order.
- The CPU path of ``mixed_expectation_kernel`` (the ``autograd.Function``)
  against autograd through the ``lsq_quantize`` composition.
- The CUDA kernels' division ``(e − β) / α`` as a multiply by the correctly
  rounded reciprocal and one Markstein correction step, against the
  rounded quotient in exact arithmetic, over the range of α in use.

The CUDA kernels are held against ``ref.py`` on the card in
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jquantizer
from repro.kernels.mpe_qat.kernel import (mixed_expectation_bwd as j_bwd,
                                          mixed_expectation_fwd as j_fwd)
from repro_torch.core import quantizer
from repro_torch.kernels.mpe_qat import ops
from repro_torch.kernels.mpe_qat.ref import (mixed_expectation_bwd_ref,
                                             mixed_expectation_fwd_ref)
from test_torch_flash_attention import _round_f32

FWD = dict(rtol=1e-5, atol=1e-7)
RED = dict(rtol=1e-4, atol=1e-6)
BITS_GRID = [(0, 1, 2, 3, 4, 5, 6)] + [(0, b) for b in range(1, 9)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them, and its spinning threads
    then slow these many small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, t, d, bits, onehot=False):
    m = len(bits)
    rows = rng.normal(0, 3e-3, (t, d)).astype(np.float32)
    if onehot:
        probs = np.eye(m, dtype=np.float32)[rng.integers(0, m, t)]
    else:
        logits = rng.normal(0, 1, (t, m))
        probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                 ).astype(np.float32)
    alpha = np.asarray([jquantizer.init_alpha(3e-3, b) for b in bits],
                       np.float32) * rng.uniform(0.7, 1.3, m).astype(np.float32)
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    g = rng.normal(0, 1, (t, d)).astype(np.float32)
    return rows, probs, alpha, beta, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 7, 8])
def test_lsq_quantize_forward_and_ste_grads_match_reference(b, rng):
    theta = rng.normal(0, 3e-3, (64, 16)).astype(np.float32)
    alpha = np.float32(jquantizer.init_alpha(3e-3, b) * 0.8)
    beta = rng.normal(0, 1e-4, 16).astype(np.float32)
    g = rng.normal(0, 1, (64, 16)).astype(np.float32)

    def ref(th, a, be):
        return jax.vjp(lambda x, y, z: jquantizer.lsq_quantize(x, y, z, b),
                       th, a, be)

    out, vjp = jax.jit(ref)(theta, alpha, beta)
    want = [np.asarray(out)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]

    th, a, be = (torch.tensor(x, requires_grad=True)
                 for x in (theta, alpha, beta))
    got_out = quantizer.lsq_quantize(th, a, be, b)
    got_out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got_out.detach().numpy(), want[0], **FWD)
    np.testing.assert_allclose(th.grad.numpy(), want[1], **FWD)
    np.testing.assert_allclose(a.grad.numpy(), want[2], **RED)
    np.testing.assert_allclose(be.grad.numpy(), want[3], **RED)
    # the STE: gradient g exactly where the value is inside the code range
    assert set(np.unique(th.grad.numpy() / g)) <= {0.0, 1.0}


@pytest.mark.parametrize("bits", BITS_GRID, ids=str)
@pytest.mark.parametrize("onehot", [False, True], ids=["softmax", "onehot"])
def test_plain_version_matches_reference_pallas_interpret(bits, onehot, rng):
    rows, probs, alpha, beta, g = _inputs(rng, 300, 16, bits, onehot)
    want_out = np.asarray(j_fwd(rows, probs, alpha, beta, bits=bits))
    want = [np.asarray(x) for x in j_bwd(rows, probs, alpha, beta, g,
                                         bits=bits)]
    got_out = mixed_expectation_fwd_ref(*_t(rows, probs, alpha, beta), bits)
    got = mixed_expectation_bwd_ref(*_t(rows, probs, alpha, beta, g), bits)
    np.testing.assert_allclose(got_out.numpy(), want_out, **FWD)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w, **RED)
    assert (got[1].numpy()[:, 0] == 0).all()      # the b = 0 column


@pytest.mark.parametrize("bits", [(0, 1, 2, 3, 4, 5, 6), (0, 3), (5,)],
                         ids=str)
@pytest.mark.parametrize("d", [257, 2048])
def test_plain_version_matches_reference_pallas_interpret_wide_rows(d, bits,
                                                                    rng):
    """Rows wider than a warp's 256 lanes (the LM's token table is 2,048
    wide), which the CUDA kernels take in a block a row: the plain version
    the kernels are held against, with float32 and float64 sums, within
    the contract of the reference's Pallas kernel in interpret mode."""
    rows, probs, alpha, beta, g = _inputs(rng, 260, d, bits)
    want_out = np.asarray(j_fwd(rows, probs, alpha, beta, bits=bits))
    want = [np.asarray(x) for x in j_bwd(rows, probs, alpha, beta, g,
                                         bits=bits)]
    got_out = mixed_expectation_fwd_ref(*_t(rows, probs, alpha, beta), bits)
    np.testing.assert_allclose(got_out.numpy(), want_out, **FWD)
    for sums in (torch.float32, torch.float64):
        got = mixed_expectation_bwd_ref(*_t(rows, probs, alpha, beta, g),
                                        bits, sum_dtype=sums)
        for x, w in zip(got, want):
            np.testing.assert_allclose(x.numpy(), w, **RED)


@pytest.mark.parametrize("bits", BITS_GRID, ids=str)
def test_plain_version_summing_in_float64_matches_reference(bits, rng):
    """The sums as the CUDA kernel takes them, in float64 and rounded once:
    within the contract of the reference's Pallas kernel, ``drows`` as
    before (no sum), the sums within a few float32 steps of the float32
    ones."""
    rows, probs, alpha, beta, g = _inputs(rng, 300, 16, bits)
    want = [np.asarray(x) for x in j_bwd(rows, probs, alpha, beta, g,
                                         bits=bits)]
    got = mixed_expectation_bwd_ref(*_t(rows, probs, alpha, beta, g), bits,
                                    sum_dtype=torch.float64)
    f32 = mixed_expectation_bwd_ref(*_t(rows, probs, alpha, beta, g), bits)
    assert all(x.dtype == torch.float32 for x in got)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w, **RED)
    assert torch.equal(got[0], f32[0])
    for x, y in zip(got[1:], f32[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [8, 16, 50, 64])
def test_plain_version_matches_jitted_composition_grads(d, rng):
    bits = (0, 1, 2, 3, 4, 5, 6)
    rows, probs, alpha, beta, g = _inputs(rng, 257, d, bits)

    def ref(r, p, a, be):
        return jax.vjp(lambda *x: jquantizer.mixed_expectation(*x, bits),
                       r, p, a, be)

    out, vjp = jax.jit(ref)(rows, probs, alpha, beta)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got_out = mixed_expectation_fwd_ref(*_t(rows, probs, alpha, beta), bits)
    got = mixed_expectation_bwd_ref(*_t(rows, probs, alpha, beta, g), bits)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), **FWD)
    np.testing.assert_allclose(got[0].numpy(), want[0], **FWD)   # drows
    for x, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(x.numpy(), w, **RED)


@pytest.mark.parametrize("onehot", [False, True], ids=["softmax", "onehot"])
def test_autograd_function_cpu_path_matches_composition(onehot, rng):
    bits = (0, 1, 2, 3, 4, 5, 6)
    arrays = _inputs(rng, 120, 16, bits, onehot)
    g = torch.from_numpy(arrays[-1])

    def run(fn):
        leaves = [torch.tensor(x, requires_grad=True) for x in arrays[:4]]
        out = fn(leaves[0].reshape(8, 15, 16), leaves[1].reshape(8, 15, -1),
                 leaves[2], leaves[3], bits)
        out.backward(g.reshape(8, 15, 16))
        return [out.detach().reshape(120, 16)] + [x.grad for x in leaves]

    before = (ops.mixed_expectation_fwd.launches,
              ops.mixed_expectation_bwd.launches)
    got = run(ops.mixed_expectation_kernel)
    want = run(quantizer.mixed_expectation)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)  # same FMAs
    # drows: autograd sums the widths' p_i·g terms in its own order
    torch.testing.assert_close(got[1], want[1], **FWD)
    for x, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(x, w, **RED)
    # the CPU path is the plain version: no kernel was launched
    assert (ops.mixed_expectation_fwd.launches,
            ops.mixed_expectation_bwd.launches) == before


def test_wrapper_checks_what_the_kernels_take(rng):
    bits = (0, 2, 4)
    rows, probs, alpha, beta, g = _t(*_inputs(rng, 10, 16, bits))
    ops._check_inputs(rows, probs, alpha, beta, bits, g)
    with pytest.raises(TypeError):
        ops._check_inputs(rows.double(), probs, alpha, beta, bits)
    with pytest.raises(ValueError, match="shape"):
        ops._check_inputs(rows, probs[:, :2], alpha, beta, bits)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_inputs(rows, probs.t().contiguous().t(), alpha, beta, bits)
    with pytest.raises(ValueError, match="widths"):
        ops._check_inputs(rows, probs, alpha, beta, (0, 2, 25))
    with pytest.raises(ValueError, match="d=16385"):
        ops._check_inputs(torch.zeros(10, 16385), probs, alpha,
                          torch.zeros(16385), bits)
    # rows of any width up to it: the LM's token tables (2,048; 6,144)
    ops._check_inputs(torch.zeros(10, 2048), probs, alpha, torch.zeros(2048),
                      bits)
    # meta tensors take the shape rule (the dry run's route): no launch
    out = ops.mixed_expectation_fwd(rows.to("meta"), probs.to("meta"),
                                    alpha.to("meta"), beta.to("meta"), bits)
    assert out.is_meta and out.shape == rows.shape


def test_division_step_gives_the_division_over_the_alpha_range_in_use():
    """The kernels form v = t / α as q = t·r, r = RN(1/α), then
    fma(fma(−q, α, t), r, q): equal to the rounded quotient for step sizes
    α over six decades below 1 (the init gives 4.2e-4 .. 4.8e-3 at 8 .. 1
    bits, and training moves them by lr a step), α whose significand is all
    ones, and t = e − β over twelve decades of either sign."""
    rng = np.random.default_rng(0)
    alphas = [np.float32(10.0 ** rng.uniform(-6, 0)) for _ in range(4000)]
    alphas += [np.nextafter(np.float32(2.0 ** -k), np.float32(0))
               for k in range(1, 20)]
    alphas += [np.float32(jquantizer.init_alpha(3e-3, b)) for b in range(1, 9)]
    for alpha in alphas:
        t = np.float32(rng.choice([-1, 1]) * 10.0 ** rng.uniform(-12, 1))
        a, d = Fraction(float(t)), Fraction(float(alpha))
        r = _round_f32(1 / d)
        q = _round_f32(a * r)
        step = _round_f32(_round_f32(a - q * d) * r + q)
        assert step == _round_f32(a / d), (t, alpha)
