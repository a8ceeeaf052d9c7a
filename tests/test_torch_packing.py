"""Port parity: quantizer codes, dequant and bit packing are bit-exact
against the JAX reference over the (b, d) grid of ``test_kernels.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import quantizer as jquantizer
from repro_torch.core import packing, quantizer

BITS = [1, 2, 3, 4, 5, 6, 7, 8]
DIMS = [8, 16, 50, 64]


def _random_codes(rng, b, n, d):
    n_b, p_b = quantizer.int_bounds(b)
    return rng.integers(n_b, p_b + 1, (n, d)).astype(np.int32)


@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("d", DIMS)
def test_quantize_codes_bit_exact(b, d, rng):
    alpha = np.float32(quantizer.init_alpha(3e-3, b))
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    theta = rng.normal(0, 3e-3, (97, d)).astype(np.float32)
    want = np.asarray(jquantizer.quantize_codes(jnp.asarray(theta), alpha,
                                                beta, b))
    got = quantizer.quantize_codes(torch.from_numpy(theta),
                                   torch.tensor(alpha), torch.from_numpy(beta),
                                   b).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_rounds_half_to_even():
    theta = np.asarray([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    want = np.asarray(jquantizer.quantize_codes(jnp.asarray(theta),
                                                np.float32(1), np.float32(0), 4))
    got = quantizer.quantize_codes(torch.from_numpy(theta), torch.tensor(1.0),
                                   torch.tensor(0.0), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-4, -2, -2, 0, 0, 2, 2, 4])


@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("d", DIMS)
def test_pack_codes_bit_exact(b, d, rng):
    codes = _random_codes(rng, b, 64, d)
    want = np.asarray(jpacking.pack_codes(jnp.asarray(codes), b))
    got = packing.pack_codes(torch.from_numpy(codes), b)
    assert got.dtype == torch.int32
    assert got.shape == (64, packing.words_per_row(d, b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("b", [1, 3, 6, 8])
def test_pack_codes_in_row_chunks_bit_exact(b, rng, monkeypatch):
    """Rows packed a few at a time (``PACK_ROWS``, 2^20 in use: it bounds
    the int64 work of a whole table's export), a ragged last chunk
    included, give the reference's words."""
    monkeypatch.setattr(packing, "PACK_ROWS", 7)
    codes = _random_codes(rng, b, 64, 50)
    want = np.asarray(jpacking.pack_codes(jnp.asarray(codes), b))
    got = packing.pack_codes(torch.from_numpy(codes), b)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("b", BITS)
@pytest.mark.parametrize("d", DIMS)
def test_unpack_codes_bit_exact(b, d, rng):
    codes = _random_codes(rng, b, 64, d)
    words = np.array(jpacking.pack_codes(jnp.asarray(codes), b))
    want = np.asarray(jpacking.unpack_codes(jnp.asarray(words), b, d))
    got = packing.unpack_codes(torch.from_numpy(words.view(np.int32)), b, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)


@pytest.mark.parametrize("b", BITS)
def test_dequantize_matches_jitted_reference_bit_exact(b, rng):
    """The jitted reference contracts α·code + β into one FMA; the port's
    ``addcmul`` rounds once too, so the two agree bit for bit."""
    codes = _random_codes(rng, b, 300, 16)
    alpha = np.float32(quantizer.init_alpha(3e-3, b) * rng.uniform(0.5, 2))
    beta = rng.normal(0, 1e-3, 16).astype(np.float32)
    want = np.asarray(jax.jit(jquantizer.dequantize_codes)(codes, alpha, beta))
    got = quantizer.dequantize_codes(torch.from_numpy(codes),
                                     torch.tensor(alpha),
                                     torch.from_numpy(beta)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", range(0, 9))
def test_bounds_alpha_and_row_sizes_match(b):
    if b >= 1:
        assert quantizer.int_bounds(b) == jquantizer.int_bounds(b)
    assert quantizer.init_alpha(3e-3, b) == jquantizer.init_alpha(3e-3, b)
    for d in DIMS:
        assert packing.words_per_row(d, b) == jpacking.words_per_row(d, b)
        assert packing.row_bytes(d, b) == jpacking.row_bytes(d, b)


def test_int_bounds_rejects_zero_width():
    with pytest.raises(ValueError):
        quantizer.int_bounds(0)
