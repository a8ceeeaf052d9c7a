"""Port parity for the packed lookup: the plain PyTorch version is bit-exact
against the reference's jitted ``packed_lookup`` and matches its Pallas
kernel (interpret mode) at rtol 1e-6. The kernel's launch descriptor
(``ops.lookup_plan``) gives each width bucket the rows, bits and words per
row of the reference's packing, and the cache (``ops.cached_plan``) builds
a new one when the table is written in place or its tensors replaced. The
CUDA kernel is held against the plain version on the card in
``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.inference import build_packed_table as j_build
from repro.core.inference import packed_lookup as j_lookup
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.core.packing import words_per_row as j_words_per_row
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
    # the meta device is no longer refused: there the wrapper computes
    # nothing and returns the kernel's output shape (the dry run's route),
    # launching nothing
    _, meta, t_table = _table(rng, (0, 4), 64, 16)
    before = ops.packed_lookup.launches
    out = ops.packed_lookup(t_table, meta,
                            torch.zeros((4, 3), dtype=torch.int32,
                                        device="meta"))
    assert out.is_meta and out.shape == (4, 3, 16)
    assert out.dtype == torch.float32
    assert ops.packed_lookup.launches == before


@pytest.mark.parametrize("b", range(9))
@pytest.mark.parametrize("d", [8, 16, 32, 50, 64])
def test_plan_gives_the_reference_packing(b, d, rng):
    """Each bucket's rows, bits and words per row, as the reference packs
    them; a width of 0 has no subtable (0, 0, 0)."""
    bits = (0, b) if b else (0,)
    table, meta, t_table = _table(rng, bits, 70, d)
    plan = ops.lookup_plan(t_table, meta, "cpu")
    want_rows = [0 if w == 0 else table["subtables"][f"b{w}"].shape[0]
                 for w in bits]
    want_wpr = [0 if w == 0 else j_words_per_row(d, w) for w in bits]
    assert plan.bits == bits and plan.d == d and plan.n_table == 70
    assert list(plan.rows) == want_rows
    assert list(plan.words_per_row) == want_wpr
    c = plan.c_plan
    assert (c.n_buckets, c.n_table, c.d) == (len(bits), 70, d)
    assert (c.max_words, c.max_bits) == (max(want_wpr), max(bits))
    assert list(c.bits[:len(bits)]) == list(bits)
    assert list(c.rows[:len(bits)]) == want_rows
    assert list(c.wpr[:len(bits)]) == want_wpr
    assert c.width_idx == t_table["width_idx"].data_ptr()
    assert c.beta == t_table["beta"].data_ptr()
    for i, w in enumerate(bits):
        assert (c.words[i] or 0) == (0 if w == 0 else
                                     t_table["subtables"][f"b{w}"].data_ptr())


WRITES = {
    "width_idx": lambda t: t["width_idx"].copy_((t["width_idx"] + 1) % 3),
    "local_idx": lambda t: t["local_idx"].zero_(),
    "subtable": lambda t: t["subtables"]["b4"].bitwise_xor_(0x0F0F0F0F),
    "alpha": lambda t: t["alpha"].mul_(2.0),
    "beta": lambda t: t["beta"].add_(1.0),
}


@pytest.mark.parametrize("what", list(WRITES))
def test_plan_is_rebuilt_after_an_in_place_write(what, rng):
    _, meta, t_table = _table(rng, (0, 2, 4), 90, 16)
    plan = ops.cached_plan(t_table, meta, "cpu")
    assert ops.cached_plan(t_table, meta, "cpu") is plan      # a hit
    WRITES[what](t_table)
    again = ops.cached_plan(t_table, meta, "cpu")
    assert again is not plan
    assert ops.cached_plan(t_table, meta, "cpu") is again


def test_plan_is_rebuilt_for_replaced_tensors_and_holds_no_table(rng):
    import gc
    import weakref
    _, meta, t_table = _table(rng, (0, 2, 4), 90, 16)
    plan = ops.cached_plan(t_table, meta, "cpu")
    swapped = dict(t_table, subtables=dict(
        t_table["subtables"], b2=t_table["subtables"]["b2"].clone()))
    other = ops.cached_plan(swapped, meta, "cpu")
    assert other is not plan
    assert other.c_plan.words[1] == swapped["subtables"]["b2"].data_ptr()
    gone = weakref.ref(t_table["width_idx"])
    assert plan in ops._PLANS.values() and other in ops._PLANS.values()
    del t_table, swapped
    gc.collect()
    assert gone() is None        # the cache keeps no table alive
    # and drops the descriptors of freed tensors
    assert plan not in ops._PLANS.values()
    assert other not in ops._PLANS.values()


@pytest.mark.parametrize("case", ["dtype", "contiguous", "shape", "buckets",
                                  "bits", "device"])
def test_plan_rejects_what_the_kernel_does_not_take(case, rng):
    _, meta, t = _table(rng, (0, 4), 64, 16)
    if case == "dtype":
        t, err = dict(t, local_idx=t["local_idx"].long()), TypeError
    elif case == "contiguous":
        sub = t["subtables"]["b4"]
        t = dict(t, subtables={"b4": sub.repeat(1, 2)[:, ::2]})
        err = ValueError
    elif case == "shape":
        t, err = dict(t, alpha=t["alpha"][:1]), ValueError
    elif case == "buckets":
        meta, err = dict(meta, bits=tuple(range(17))), ValueError
    elif case == "bits":
        meta, err = dict(meta, bits=(0, 32)), ValueError
        t = dict(t, subtables={"b32": t["subtables"]["b4"]},
                 alpha=t["alpha"])
    else:
        t, err = dict(t, beta=t["beta"].to("meta")), ValueError
    with pytest.raises(err):
        ops.lookup_plan(t, meta, "cpu")
