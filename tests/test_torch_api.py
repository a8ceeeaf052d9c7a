"""The port's public surface and its last public functions, against the
reference.

- Surface: every name in the ``__all__`` of a reference package resolves in
  the port's package of the same path and stands in its ``__all__``; where
  the reference's function takes a parameter the port's does not, the
  parameter is parted by design and listed in ``PARTED`` with its reason.
- Numbers, on numpy inputs from a seed, on the CPU:
  - ``globalize_ids`` and ``binary_accuracy`` bit for bit, a tie at the
    threshold included;
  - ``apply_updates`` bit for bit on float32 and bfloat16 leaves;
  - ``clip_by_global_norm`` bit for bit below the norm (the scale is 1),
    within ``CLIP`` above it (each leaf's sum of squares is taken in
    another order), ``gnorm`` within ``CLIP`` both ways; a bfloat16 leaf
    comes out float32 in both;
  - ``mixed_expectation_ref``'s value and gradients within
    ``tests/test_torch_mpe_qat.py``'s tolerances;
  - ``core.inference.packed_lookup`` bit for bit against the reference's,
    and ``packed_specs`` shape for shape (int32 words for uint32);
  - the reference's kernel names: ``packed_lookup_kernel`` and
    ``flash_attention_kernel`` are the port's wrappers, the latter within
    ``tests/test_torch_flash_attention.py``'s forward tolerance of the
    reference's in interpret mode.
"""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inference as jinference
from repro.core.mpe import MPEConfig as JMPEConfig
from repro.embeddings.table import globalize_ids as j_globalize_ids
from repro.kernels.flash_attention import (flash_attention_kernel as
                                           j_flash_attention_kernel)
from repro.kernels.mpe_qat.ref import (mixed_expectation_ref as
                                       j_mixed_expectation_ref)
from repro.train.metrics import binary_accuracy as j_binary_accuracy
from repro.train.optimizer import apply_updates as j_apply_updates
from repro.train.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro_torch.core import MPEConfig, packed_lookup, packed_specs
from repro_torch.embeddings import field_offsets, globalize_ids
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import to_torch
from repro_torch.kernels import flash_attention_kernel, packed_lookup_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mpe_qat import mixed_expectation_ref
from repro_torch.train import (apply_updates, binary_accuracy,
                               clip_by_global_norm)
from test_torch_mpe_qat import FWD, RED, _inputs, _t

PACKAGES = ("analysis", "cache", "configs", "core", "data", "dist",
            "embeddings", "kernels", "kernels.mpe_lookup", "kernels.mpe_qat",
            "kernels.flash_attention", "kernels.embedding_bag", "models", "nn",
            "serve", "train")

_PALLAS = ("the Pallas interpreter; the port takes the kernel for a CUDA "
           "tensor and its plain version for a CPU tensor")
_TILES = "Pallas block sizes; the CUDA kernel picks its own tiles"
_SWITCH = ("the reference's jnp-or-Pallas switch; every gather of the port "
           "goes through the kernel wrappers")
_REQUEST_SPECS = ("the request's partition over the data axes; the port's "
                  "cells run whole on every rank (eager SPMD)")
# (package, name) -> {reference parameter the port does not take: reason}
PARTED = {
    **{("kernels", n): {"interpret": _PALLAS} for n in (
        "packed_lookup_kernel", "mixed_expectation_kernel",
        "embedding_bag_kernel", "packed_lookup_kernel_sharded",
        "mixed_expectation_kernel_sharded", "embedding_bag_kernel_sharded")},
    **{(p, "flash_attention_kernel"): {"interpret": _PALLAS, "bq": _TILES,
                                       "bk": _TILES}
       for p in ("kernels", "kernels.flash_attention")},
    ("kernels", "flash_attention_kernel_sharded"): {
        "interpret": _PALLAS, "bq": _TILES, "bk": _TILES},
    ("kernels.mpe_lookup", "packed_lookup_kernel"): {"interpret": _PALLAS},
    ("kernels.mpe_qat", "mixed_expectation_kernel"): {"interpret": _PALLAS},
    ("kernels.embedding_bag", "embedding_bag_kernel"): {"interpret": _PALLAS},
    ("kernels.mpe_lookup", "packed_lookup_ref"): {
        p: "the port's oracle is the whole table's lookup (table, meta, ids): "
           "its kernel gathers every width bucket in one launch, the "
           "reference's one bucket's words a call"
        for p in ("words", "alpha", "beta", "b", "d")},
    ("dist", "sharded_packed_lookup"): {"use_kernel": _SWITCH,
                                        "interpret": _PALLAS},
    ("dist", "sharded_embedding_bag"): {"use_kernel": _SWITCH,
                                        "interpret": _PALLAS},
    ("dist", "sharded_flash_attention"): {"interpret": _PALLAS, "bq": _TILES,
                                          "bk": _TILES},
    ("dist", "sharded_mixed_expectation"): {"interpret": _PALLAS},
    **{("serve", n): {"dp": _REQUEST_SPECS} for n in (
        "baseline_score_cell", "packed_score_cell", "packed_lookup_cell",
        "lm_decode_cell", "lm_decode_slotted_cell")},
    ("serve", "tiered_score_cell"): {
        "dp": _REQUEST_SPECS,
        "row_keys": "the wide and first-order weights' row partition; the "
                    "port binds them whole on every rank"},
    ("serve", "two_tower_retrieval_cell"): {
        "rows_axes": "the candidates' partition; the port's retrieve lane "
                     "runs whole on every rank"},
}


def _reference_names():
    return [(p, n) for p in PACKAGES
            for n in importlib.import_module(f"repro.{p}").__all__]


@pytest.mark.parametrize("package,name", _reference_names(),
                         ids=lambda x: x)
def test_reference_name_resolves_in_the_port(package, name):
    ref = getattr(importlib.import_module(f"repro.{package}"), name)
    port_pkg = importlib.import_module(f"repro_torch.{package}")
    assert name in port_pkg.__all__
    port = getattr(port_pkg, name)
    assert inspect.ismodule(port) == inspect.ismodule(ref)
    assert callable(port) == callable(ref)
    missing = set()
    if callable(ref) and not inspect.isclass(ref):
        params = inspect.signature(port).parameters
        missing = {p for p in inspect.signature(ref).parameters
                   if p not in params}
    assert missing == set(PARTED.get((package, name), {}))


def test_every_parted_entry_names_a_reference_export():
    assert set(PARTED) <= set(_reference_names())


def test_configs_fill_the_registry_on_import():
    import repro.configs as jconfigs
    import repro_torch.configs as configs
    assert configs.ALL_ARCHS() == jconfigs.ALL_ARCHS()
    assert len(configs.base._REGISTRY) == len(configs.ALL_ARCHS())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_globalize_ids_bit_exact(rng, dtype):
    fields = [FieldSpec(f"f{i}", v) for i, v in enumerate((7, 300, 41, 2))]
    offsets = field_offsets(fields)
    local = np.stack([rng.integers(0, f.vocab, 33) for f in fields],
                     1).astype(dtype)
    want = np.asarray(j_globalize_ids(local, offsets))
    got = globalize_ids(torch.from_numpy(local), offsets)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_binary_accuracy_bit_exact_with_a_tie(rng, threshold):
    labels = rng.integers(0, 2, 301).astype(np.float32)
    probs = rng.uniform(0, 1, 301).astype(np.float32)
    probs[::7] = threshold                    # ties count as 0 in both
    want = np.asarray(j_binary_accuracy(jnp.asarray(labels),
                                        jnp.asarray(probs), threshold))
    got = binary_accuracy(torch.from_numpy(labels), torch.from_numpy(probs),
                          threshold)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _trees(rng):
    """A float32 and a bfloat16 leaf (rounded from the same float32 numbers
    in both packages), as numpy arrays and in each package."""
    arrays = {"w": rng.normal(0, 1, (17, 5)).astype(np.float32),
              "b": [rng.normal(0, 1, (9,)).astype(np.float32)]}
    jtree = {"w": jnp.asarray(arrays["w"]),
             "b": [jnp.asarray(arrays["b"][0], jnp.bfloat16)]}
    tree = {"w": torch.from_numpy(arrays["w"]),
            "b": [torch.from_numpy(arrays["b"][0]).to(torch.bfloat16)]}
    return jtree, tree


def _leaves_equal(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))


def test_apply_updates_bit_exact(rng):
    jparams, params = _trees(rng)
    jupdates, updates = _trees(np.random.default_rng(9))
    updates["b"][0] = updates["b"][0].float()     # float32 into bfloat16
    jupdates["b"][0] = jupdates["b"][0].astype(jnp.float32)
    _leaves_equal(apply_updates(params, updates),
                  j_apply_updates(jparams, jupdates))


# each leaf's sum of squares and the sum over leaves, taken in another order
CLIP = dict(rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1e3, 0.5], ids=["below", "above"])
def test_clip_by_global_norm(rng, max_norm):
    jgrads, grads = _trees(rng)
    want, want_norm = j_clip_by_global_norm(jgrads, max_norm)
    got, gnorm = clip_by_global_norm(grads, max_norm)
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(want_norm), **CLIP)
    if max_norm > float(gnorm):
        _leaves_equal(got, want)
        return
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CLIP)


@pytest.mark.parametrize("bits", [(0, 1, 2, 3, 4, 5, 6), (0, 4)], ids=str)
def test_mixed_expectation_ref_value_and_gradients(rng, bits):
    rows, probs, alpha, beta, g = _inputs(rng, 129, 16, bits)
    out, vjp = jax.vjp(
        lambda *x: j_mixed_expectation_ref(*x, bits=bits),
        *map(jnp.asarray, (rows, probs, alpha, beta)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    args = [x.requires_grad_() for x in _t(rows, probs, alpha, beta)]
    got = mixed_expectation_ref(*args, bits=bits)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD)
    np.testing.assert_allclose(args[0].grad.numpy(), want[0], **FWD)
    for x, w in zip(args[1:], want[1:]):
        np.testing.assert_allclose(x.grad.numpy(), w, **RED)


def _packed_table(rng, bits, n, d):
    emb = rng.normal(0, 3e-3, (n, d)).astype(np.float32)
    widx = rng.integers(0, len(bits), n).astype(np.int32)
    alpha = rng.uniform(1e-4, 1e-3, len(bits)).astype(np.float32)
    beta = rng.normal(0, 1e-4, d).astype(np.float32)
    table, meta = jinference.build_packed_table(
        emb, widx, alpha, beta, JMPEConfig(bits=bits))
    return table, meta, to_torch(jax.tree.map(np.asarray, table), "cpu")


def test_packed_lookup_and_its_kernel_name_bit_exact(rng):
    table, meta, t_table = _packed_table(rng, (0, 1, 3, 4, 8), 500, 12)
    ids = rng.integers(0, 500, (21, 3)).astype(np.int32)
    want = np.asarray(jax.jit(
        lambda t, i: jinference.packed_lookup(t, meta, i))(table, ids))
    got = packed_lookup(t_table, meta, torch.from_numpy(ids))
    assert got.shape == want.shape == (21, 3, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert packed_lookup_kernel is packed_lookup     # one wrapper, one count


@pytest.mark.parametrize("n,d,hist,pad", [
    (100_000, 16, (0.0, 0.3, 0.2, 0.2, 0.1, 0.1, 0.1), 512),
    (3_000, 50, (0.1, 0.2, 0.1, 0.2, 0.1, 0.1, 0.2), 64)])
def test_packed_specs_match_reference(n, d, hist, pad):
    want = jinference.packed_specs(n, d, JMPEConfig(), hist, pad)
    got = packed_specs(n, d, MPEConfig(), hist, pad)
    assert set(got) == set(want)
    assert set(got["subtables"]) == set(want["subtables"])
    wanted = {"uint32": torch.int32, "int32": torch.int32,
              "float32": torch.float32}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape) and g.is_meta
        assert g.dtype == wanted[str(w.dtype)]


@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attention_kernel_matches_reference(rng, hkv):
    q = rng.normal(0, 1, (2, 48, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 48, hkv, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_flash_attention_kernel(q, k, v, n_kv_heads=hkv,
                                               bq=16, bk=16, interpret=True))
    got = flash_attention_kernel(*_t(q, k, v), n_kv_heads=hkv)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert flash_attention_kernel is flash_attention
