"""Port parity for the lookup's gathers and their backward (the
``segment_sum`` kernel's plain version, which CPU tensors take).

- ``gather``'s gradient on the CPU against ``jax.vjp`` of the reference's
  gathers ``p[group_of_feature[ids]]`` (the group probabilities, m = 7
  columns) and ``emb[ids]`` (the table rows), on Zipf-skewed ids with a hot
  segment holding half of them: rtol 1e-5 (the reference sums a row's
  contributions in float32 in its own order, the port in float64 and
  rounds once), atol 1e-6 times the largest entry;
- ``segment_sum`` on the CPU is ``F.embedding``'s dense backward in float64,
  rounded once, and launches nothing; a row with no id gets 0;
- ``gather`` of bf16 rows: the rows as they are, and the gradient the
  segment sum of the cotangent taken to float32, rounded once to bf16;
- the bag form (``bag_weights``, the embedding bag's backward) on the CPU
  sums the float32 products ``g[b] * w[b, j]`` in float64, rounded once;
- ``gather``'s gradient at the MoE's width (2,048) where the card kernel
  meets its hot segments: a 3,000-row segment, and the combine gather's
  clamped slots (every dropped choice on its expert's last slot), against
  ``jax.vjp`` with the tolerance above;
- the wrapper's checks.

The CUDA kernel is held against the plain version on the card in
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_sum import ops
from repro_torch.kernels.segment_sum.ref import segment_sum_ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them, and its spinning threads
    then slow these many small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zipf_ids(rng, t, n, hot_share):
    """Zipf(1.1)-ranked ids in [0, n), with ``hot_share`` of them on one id."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    ids = rng.choice(n, size=t, p=p / p.sum())
    ids[rng.random(t) < hot_share] = n // 3
    return ids.astype(np.int32)


@pytest.mark.parametrize("what", ["probabilities", "rows"])
def test_gather_gradient_matches_reference_vjp(what, rng):
    n_items, group_size, t = 4000, 128, 20_000
    gof = (rng.permutation(n_items) // group_size).astype(np.int32)
    ids = zipf_ids(rng, t, n_items, 0.5)
    if what == "probabilities":
        # three groups more than the features fill: rows no id reaches
        logits = rng.normal(0, 1, (int(gof.max()) + 4, 7))
        table = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                 ).astype(np.float32)
        index = gof[ids]
    else:
        table = rng.normal(0, 3e-3, (n_items, 50)).astype(np.float32)
        index = ids
    g = rng.normal(0, 1, (t, table.shape[1])).astype(np.float32)

    if what == "probabilities":
        def ref(x):
            return x[jnp.asarray(gof)[jnp.asarray(ids)]]
    else:
        def ref(x):
            return x[jnp.asarray(ids)]
    out, vjp = jax.vjp(ref, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))

    leaf = torch.from_numpy(table).requires_grad_(True)
    got = ops.gather(leaf, torch.from_numpy(index).long())
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    counts = np.bincount(index, minlength=table.shape[0])
    assert counts.max() >= 0.45 * t                     # the hot segment
    assert (counts == 0).any()                          # and rows with none
    want = np.asarray(want)
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert (leaf.grad.numpy()[counts == 0] == 0).all()


@pytest.mark.parametrize("what", ["hot", "clamped"])
def test_wide_gather_gradient_matches_reference_vjp(what, rng):
    w = 2048
    if what == "hot":
        # 6,000 rows, 3,000 of them on one id: a hot segment of wide rows
        n, t = 500, 6000
        index = rng.integers(0, n, t)
        index[rng.permutation(t)[:3000]] = 123
    else:
        # the MoE combine's gather: 8 experts of 100 slots, 6,000 choices;
        # the kept ones on slots of their own, the dropped ones clamped onto
        # their expert's last slot
        e, cap, t = 8, 100, 6000
        n = e * cap
        expert = rng.integers(0, e, t)
        kept = np.zeros(t, bool)
        kept[rng.permutation(t)[:(cap - 1) * e]] = True
        index = expert * cap + cap - 1
        index[kept] = rng.permutation(np.arange(n).reshape(e, cap)[:, :cap - 1]
                                      .reshape(-1))
    index = index.astype(np.int32)
    table = rng.normal(0, 1, (n, w)).astype(np.float32)
    g = rng.normal(0, 1, (t, w)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: x[jnp.asarray(index)], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(table).requires_grad_(True)
    ops.gather(leaf, torch.from_numpy(index).long()).backward(
        torch.from_numpy(g))
    counts = np.bincount(index, minlength=n)
    assert counts.max() >= (3000 if what == "hot" else 400)
    want = np.asarray(want)
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert (leaf.grad.numpy()[counts == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gather_of_narrow_rows_sums_in_float32(dtype, rng):
    n, t, w = 300, 5000, 24
    ids = torch.from_numpy(zipf_ids(rng, t, n, 0.3)).long()
    table = torch.from_numpy(rng.normal(0, 1, (n, w)).astype(np.float32)
                             ).to(dtype).requires_grad_(True)
    g = torch.from_numpy(rng.normal(0, 1, (t, w)).astype(np.float32)).to(dtype)
    got = ops.gather(table, ids)
    assert got.dtype == dtype and torch.equal(got, table.detach()[ids])
    got.backward(g)
    want = segment_sum_ref(g.float(), ids, n).to(dtype)
    assert table.grad.dtype == dtype
    assert torch.equal(table.grad, want)


@pytest.mark.parametrize("w", [1, 7, 16, 50])
def test_segment_sum_is_the_dense_backward_in_float64(w, rng):
    t, n = 3000, 400
    ids = torch.from_numpy(zipf_ids(rng, t, n, 0.3))
    grad = torch.from_numpy(rng.normal(0, 1, (t, w)).astype(np.float32))
    before = ops.segment_sum.launches
    got = ops.segment_sum(grad, ids, n)
    assert ops.segment_sum.launches == before            # the CPU: no kernel
    want = np.zeros((n, w), np.float64)
    np.add.at(want, ids.numpy(), grad.numpy().astype(np.float64))
    assert got.dtype == torch.float32 and got.shape == (n, w)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert torch.equal(got, segment_sum_ref(grad, ids.long(), n))


def test_wrapper_checks_what_the_kernel_takes(rng):
    grad = torch.zeros(10, 7)
    ids = torch.zeros(10, dtype=torch.int32)
    ops._check(grad, ids, 5)
    with pytest.raises(TypeError):
        ops._check(grad.double(), ids, 5)
    with pytest.raises(TypeError):
        ops._check(grad, ids.to(torch.int16), 5)
    with pytest.raises(ValueError, match="shape"):
        ops._check(grad, ids[:5], 5)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(torch.zeros(7, 10).t(), ids, 5)
    ops._check(torch.zeros(10, 300), ids, 5)     # wide rows: column tiles
    with pytest.raises(ValueError, match="w >= 1"):
        ops._check(torch.zeros(10, 0), ids, 5)
    # meta tensors take the shape rule (the dry run's route): no launch
    out = ops.segment_sum(grad.to("meta"), ids.to("meta"), 5)
    assert out.is_meta and out.shape == (5, grad.shape[1])


@pytest.mark.parametrize("w", [7, 32])
def test_bag_form_sums_the_weighted_cotangent_rows(w, rng):
    b, l, n = 300, 20, 500
    ids = torch.from_numpy(zipf_ids(rng, b * l, n, 0.3).reshape(b, l))
    g = torch.from_numpy(rng.normal(0, 1, (b, w)).astype(np.float32))
    weights = torch.from_numpy((rng.random((b, l)) < 0.7)
                               * rng.uniform(0.5, 1.5, (b, l))).float()
    before = ops.segment_sum.launches
    got = ops.segment_sum(g, ids, n, bag_weights=weights)
    assert ops.segment_sum.launches == before            # the CPU: no kernel
    prods = (g.numpy()[:, None, :] * weights.numpy()[..., None]).reshape(-1, w)
    want = np.zeros((n, w), np.float64)
    np.add.at(want, ids.numpy().reshape(-1), prods.astype(np.float64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_bag_form_checks_its_weights(rng):
    g = torch.zeros(4, 8)
    ids = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="bag_weights must be"):
        ops.segment_sum(g, ids, 5, bag_weights=torch.zeros(3, 3))
    with pytest.raises(TypeError, match="bag_weights"):
        ops.segment_sum(g, ids, 5, bag_weights=torch.zeros(4, 3).double())
    with pytest.raises(ValueError, match="entries"):
        ops.segment_sum(g, ids[:, :2], 5, bag_weights=torch.zeros(4, 3))
