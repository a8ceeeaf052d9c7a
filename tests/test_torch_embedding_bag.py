"""Port parity for the embedding bag on the CPU, on the same seeded numpy
inputs:

- the kernel API ``embedding_bag_kernel`` against the reference's (its
  Pallas kernel in interpret mode) and ``embedding_bag_ref``, at the
  reference's shapes (4, 3, 16), (16, 7, 32), (8, 1, 8) and with bags whose
  every slot is masked, bool and float masks, int32 and int64 ids (rtol
  1e-5, atol 1e-6: the reference's kernel contract; the L slots are summed
  in another order);
- the table gradient against ``jax.grad`` through the reference's
  ``custom_vjp`` (the same contract), and the card's backward route
  (``embedding_bag_bwd_segments``: the segment sum's bag form, here through
  its plain version) against the ``custom_vjp``'s gradient and against
  ``embedding_bag_bwd_ref`` (float64 sums of the same float32 products,
  each rounded once: equal);
- ``embeddings.embedding_bag`` with ``combine`` sum, mean and max, with and
  without a mask, and ``reduce_bag``;
- ``ragged_embedding_bag`` (sum, mean, max, with empty segments) and
  ``segment_mean`` against the reference's ``segment_sum``/``segment_max``
  (rtol 1e-6: one sum per segment), including the fill of an empty segment.

The plain version is what CPU tensors take, so the launch counter stays 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embeddings import bag as jbag
from repro.kernels import embedding_bag_kernel as jembedding_bag_kernel
from repro.kernels.embedding_bag import embedding_bag_ref as jembedding_bag_ref
from repro_torch import embeddings, kernels
from repro_torch.embeddings import bag
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.segment_sum import ops as seg_ops

TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_kernels.py's bag contract
N_ROWS = 200


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bag_inputs(rng, b, l, d, *, id_dtype=np.int32, float_mask=False,
               all_masked=()):
    table = rng.normal(0, 1, (N_ROWS, d)).astype(np.float32)
    ids = rng.integers(0, N_ROWS, (b, l)).astype(id_dtype)
    mask = rng.random((b, l)) < 0.8
    for i in all_masked:
        mask[i] = False
    if float_mask:
        mask = (mask * rng.uniform(0.5, 1.5, (b, l))).astype(np.float32)
    return table, ids, mask


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


CASES = [((4, 3, 16), {}), ((16, 7, 32), {}), ((8, 1, 8), {}),
         ((6, 5, 16), {"all_masked": (0, 3)}),
         ((16, 7, 32), {"id_dtype": np.int64}),
         ((16, 7, 32), {"float_mask": True, "all_masked": (2,)})]


@pytest.mark.parametrize("shape,kw", CASES,
                         ids=[f"{s}-{'-'.join(k) or 'bool'}" for s, k in CASES])
def test_kernel_api_matches_reference(shape, kw, rng):
    table, ids, mask = bag_inputs(rng, *shape, **kw)
    jmask = jnp.asarray(mask)
    want_kernel = np.asarray(jembedding_bag_kernel(jnp.asarray(table),
                                                   jnp.asarray(ids), jmask))
    want_ref = np.asarray(jembedding_bag_ref(jnp.asarray(table),
                                             jnp.asarray(ids), jmask))
    ops.embedding_bag_fwd.launches = 0
    got = kernels.embedding_bag_kernel(t(table), t(ids), t(mask))
    assert got.shape == (shape[0], shape[2]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    for i in kw.get("all_masked", ()):
        assert not got[i].any()
    assert ops.embedding_bag_fwd.launches == 0   # CPU tensors: plain version


@pytest.mark.parametrize("float_mask", [False, True], ids=["bool", "weights"])
def test_table_gradient_matches_custom_vjp(float_mask, rng):
    table, ids, mask = bag_inputs(rng, 8, 5, 16, float_mask=float_mask,
                                  all_masked=(1,))
    ids[2] = ids[2, 0]                       # a bag that repeats one row
    want = jax.grad(lambda x: jnp.sum(jembedding_bag_kernel(
        x, jnp.asarray(ids), jnp.asarray(mask)) ** 2))(jnp.asarray(table))
    leaf = t(table).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (kernels.embedding_bag_kernel(leaf, t(ids), t(mask)) ** 2).sum(), leaf)
    assert got.shape == table.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    untouched = np.setdiff1d(np.arange(N_ROWS), ids[mask != 0])
    assert not got[torch.from_numpy(untouched)].any()


def test_plain_backward_is_the_reference_segment_sum(rng):
    _, ids, mask = bag_inputs(rng, 16, 7, 32, all_masked=(4,))
    g = rng.normal(0, 1, (16, 32)).astype(np.float32)
    contrib = (g[:, None, :] * mask[..., None]).reshape(-1, 32)
    want = jax.ops.segment_sum(contrib, ids.reshape(-1), num_segments=N_ROWS)
    got = embedding_bag_bwd_ref(t(g), t(ids), t(mask), N_ROWS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(ops.embedding_bag_bwd(t(g), t(ids), t(mask), N_ROWS),
                       got)


SEGMENT_CASES = [((8, 5, 16), {}), ((16, 7, 32), {"float_mask": True}),
                 ((12, 20, 32), {"id_dtype": np.int64, "all_masked": (0,)}),
                 ((6, 50, 50), {"float_mask": True})]


@pytest.mark.parametrize("shape,kw", SEGMENT_CASES,
                         ids=[f"{s}-{'-'.join(k) or 'bool'}"
                              for s, k in SEGMENT_CASES])
def test_segment_route_matches_custom_vjp_and_plain_backward(shape, kw, rng):
    """The card's backward route, taken on the CPU: the bag cotangent times
    the mask summed by ``segment_sum``'s plain version. Within the contract
    of the reference's ``custom_vjp`` gradient, and equal to
    ``embedding_bag_bwd_ref``; no kernel launches."""
    table, ids, mask = bag_inputs(rng, *shape, **kw)
    ids[1] = ids[1, 0]                       # a bag that repeats one row
    b, _, d = shape
    g = rng.normal(0, 1, (b, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jembedding_bag_kernel(
        x, jnp.asarray(ids), jnp.asarray(mask)), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    seg0 = seg_ops.segment_sum.launches
    got = ops.embedding_bag_bwd_segments(t(g), t(ids), t(mask), N_ROWS)
    assert got.shape == table.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), embedding_bag_bwd_ref(t(g), t(ids), t(mask),
                                           N_ROWS).numpy())
    assert seg_ops.segment_sum.launches == seg0


def test_masked_inf_row_gives_nan_as_in_reference(rng):
    """The mask multiplies, it does not select: an inf in a masked-out slot's
    row makes the bag NaN in both packages."""
    table, ids, mask = bag_inputs(rng, 4, 3, 8)
    table[7] = np.inf
    ids[1] = [7, 0, 1]
    mask[1] = [False, True, True]
    want = np.asarray(jembedding_bag_kernel(jnp.asarray(table),
                                            jnp.asarray(ids),
                                            jnp.asarray(mask)))
    got = kernels.embedding_bag_kernel(t(table), t(ids), t(mask)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(np.delete(got, 1, 0), np.delete(want, 1, 0),
                               **TOL)


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_embedding_bag_matches_reference(combine, with_mask, rng):
    table, ids, mask = bag_inputs(rng, 16, 7, 32, all_masked=(5,))
    jmask = jnp.asarray(mask) if with_mask else None
    want = jbag.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jmask,
                              combine=combine)
    got = embeddings.embedding_bag(t(table), t(ids),
                                   t(mask) if with_mask else None,
                                   combine=combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if with_mask and combine != "max":       # an all-masked bag: 0, not NaN
        assert not got[5].any()


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_embedding_bag_gradient_matches_reference(combine, rng):
    table, ids, mask = bag_inputs(rng, 8, 5, 16, all_masked=(3,))
    want = jax.grad(lambda x: jnp.sum(jnp.sin(jbag.embedding_bag(
        x, jnp.asarray(ids), jnp.asarray(mask), combine=combine))))(
            jnp.asarray(table))
    leaf = t(table).requires_grad_(True)
    out = embeddings.embedding_bag(leaf, t(ids), t(mask), combine=combine)
    (got,) = torch.autograd.grad(torch.sin(out).sum(), leaf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_reduce_bag_matches_reference(combine, rng):
    rows = rng.normal(0, 1, (6, 4, 8)).astype(np.float32)
    mask = rng.random((6, 4)) < 0.6
    mask[2] = False
    for m in (mask, None):
        want = jbag.reduce_bag(jnp.asarray(rows),
                               None if m is None else jnp.asarray(m),
                               combine=combine)
        got = bag.reduce_bag(t(rows), None if m is None else t(m),
                             combine=combine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_combine_raises(rng):
    table, ids, mask = bag_inputs(rng, 2, 3, 4)
    with pytest.raises(ValueError, match="unknown combine"):
        embeddings.embedding_bag(t(table), t(ids), t(mask), combine="min")


def ragged_inputs(rng, n_flat=40, num_bags=9, d=16):
    table = rng.normal(0, 1, (N_ROWS, d)).astype(np.float32)
    flat_ids = rng.integers(0, N_ROWS, n_flat).astype(np.int32)
    # segments 0, 4 and 8 stay empty
    segment_ids = rng.choice([1, 2, 3, 5, 6, 7], n_flat).astype(np.int32)
    return table, flat_ids, segment_ids, num_bags


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
def test_ragged_embedding_bag_matches_reference(combine, rng):
    table, flat_ids, segment_ids, num_bags = ragged_inputs(rng)
    want = np.asarray(jbag.ragged_embedding_bag(
        jnp.asarray(table), jnp.asarray(flat_ids), jnp.asarray(segment_ids),
        num_bags, combine=combine))
    got = bag.ragged_embedding_bag(t(table), t(flat_ids), t(segment_ids),
                                   num_bags, combine=combine).numpy()
    assert got.shape == (num_bags, 16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    empty = [0, 4, 8]
    # the fill of an empty segment is the reference's: 0, or segment_max's
    np.testing.assert_array_equal(got[empty], want[empty])
    if combine == "max":
        assert np.isneginf(want[empty]).all()
    else:
        assert not want[empty].any()


def test_ragged_embedding_bag_gradient_matches_reference(rng):
    table, flat_ids, segment_ids, num_bags = ragged_inputs(rng)
    for combine in ("sum", "mean"):
        want = jax.grad(lambda x, c=combine: jnp.sum(jnp.sin(
            jbag.ragged_embedding_bag(x, jnp.asarray(flat_ids),
                                      jnp.asarray(segment_ids), num_bags,
                                      combine=c))))(jnp.asarray(table))
        leaf = t(table).requires_grad_(True)
        out = bag.ragged_embedding_bag(leaf, t(flat_ids), t(segment_ids),
                                       num_bags, combine=combine)
        (got,) = torch.autograd.grad(torch.sin(out).sum(), leaf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(30, 5), (30, 3, 2)], ids=["2d", "3d"])
def test_segment_mean_matches_reference(shape, rng):
    data = rng.normal(0, 1, shape).astype(np.float32)
    segment_ids = rng.choice([0, 2, 3, 6], shape[0]).astype(np.int32)
    want = np.asarray(jbag.segment_mean(jnp.asarray(data),
                                        jnp.asarray(segment_ids), 7))
    got = embeddings.segment_mean(t(data), t(segment_ids), 7).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[[1, 4, 5]].any()


def test_plain_forward_is_the_reference_sum(rng):
    table, ids, mask = bag_inputs(rng, 16, 7, 32, float_mask=True)
    want = jbag.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(mask), combine="sum")
    np.testing.assert_allclose(
        embedding_bag_ref(t(table), t(ids), t(mask)).numpy(),
        np.asarray(want), **TOL)
