"""Port parity for the packed lookup: the plain PyTorch version is bit-exact
against the reference's jitted ``packed_lookup`` and matches its Pallas
kernel (interpret mode) at rtol 1e-6. The CUDA kernel is held against the
plain version on the card in ``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.inference import build_packed_table as j_build
from repro.core.inference import packed_lookup as j_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.kernels.mpe_lookup.ops import packed_lookup_kernel
from repro_torch.core import quantizer
from repro_torch.interop import to_torch
from repro_torch.kernels.mpe_lookup import ops
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref


def _table(rng, bits, n, d):
    """A reference packed table over random weights and widths, plus the
    same table carried into the port."""
    emb = rng.normal(0, 3e-3, (n, d)).astype(np.float32)
    widx = rng.integers(0, len(bits), n).astype(np.int32)
    alpha = np.asarray([quantizer.init_alpha(3e-3, b) for b in bits],
                       np.float32)
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    table, meta = j_build(emb, widx, alpha, beta, JMPEConfig(bits=tuple(bits)))
    np_table = jax.tree.map(np.asarray, table)
    return table, meta, to_torch(np_table, "cpu")


def _jitted_lookup(table, meta, ids):
    return np.asarray(jax.jit(lambda t, i: j_lookup(t, meta, i))(table, ids))


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("d", [8, 16, 50, 64])
def test_plain_lookup_bit_exact_vs_jitted_reference(b, d, rng):
    table, meta, t_table = _table(rng, (0, b), 64, d)
    ids = rng.integers(0, 64, (33,)).astype(np.int32)
    want = _jitted_lookup(table, meta, ids)
    got = ops.packed_lookup(t_table, meta, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [8, 16, 50])
def test_plain_lookup_multi_bucket_bit_exact(d, rng):
    bits = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    table, meta, t_table = _table(rng, bits, 700, d)
    ids = rng.integers(0, 700, (40, 6)).astype(np.int32)
    want = _jitted_lookup(table, meta, ids)
    got = ops.packed_lookup(t_table, meta, torch.from_numpy(ids))
    assert got.shape == (40, 6, d)
    np.testing.assert_array_equal(got.numpy(), want)
    # dropped (b = 0) features look up the zero vector
    zero = np.asarray(table["width_idx"])[ids] == 0
    assert zero.any() and (got.numpy()[zero] == 0).all()


@pytest.mark.parametrize("d", [16, 50])
def test_plain_lookup_matches_pallas_kernel(d, rng):
    bits = (0, 1, 2, 3, 5, 8)
    table, meta, t_table = _table(rng, bits, 300, d)
    ids = rng.integers(0, 300, (24,)).astype(np.int32)
    want = np.asarray(packed_lookup_kernel(table, meta, jnp.asarray(ids),
                                           interpret=True))
    got = packed_lookup_ref(t_table, meta, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cpu_lookup_counts_no_launch(rng):
    _, meta, t_table = _table(rng, (0, 4), 64, 16)
    before = ops.packed_lookup.launches
    ops.packed_lookup(t_table, meta, torch.arange(10, dtype=torch.int32))
    assert ops.packed_lookup.launches == before


def test_lookup_rejects_other_devices(rng):
    _, meta, t_table = _table(rng, (0, 4), 64, 16)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.packed_lookup(t_table, meta,
                          torch.zeros(4, dtype=torch.int32, device="meta"))
