"""The global-norm clip's wrapper (``kernels/global_norm``) on the CPU, where
it takes its plain version, against the reference:

- the norm and the scale against ``repro.train.optimizer.clip_by_global_norm``
  (rtol 1e-6: the leaves' squares are summed in another order), on float32
  trees and on bfloat16 leaves, which both widen to float32 before
  squaring;
- a NaN leaf, an inf leaf, and a float32 leaf whose squares sum past
  float32's range each give a non-finite norm, so the trainer's guard skips
  the step;
- a zero-size leaf adds nothing; a tree of more leaves than one launch of
  the card's pass takes sums them all here, and the card's path refuses
  it;
- the wrapper's checks (no leaf, too many, a non-contiguous leaf, an
  unsupported dtype, mixed devices), which the card's path runs, and its
  one launch: what it hands the pass's C interface, through a stand-in
  for the library;
- ``clip_scale`` and ``clip_by_global_norm`` go through the wrapper, and
  on meta leaves, or under an op walk, the wrapper is one region charged
  a read of every leaf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import clip_by_global_norm as j_clip_by_global_norm
from repro_torch import kernels
from repro_torch.kernels.global_norm import ops
from repro_torch.kernels.global_norm.ops import MAX_LEAVES, global_norm_clip
from repro_torch.train.optimizer import clip_by_global_norm, clip_scale
from repro_torch.train.tree import leaves

# the leaves' squares summed in another order (the reference's tolerance in
# tests/test_torch_api.py)
CLIP = dict(rtol=1e-6, atol=0)
# DLRM's leaf shapes, the table cut to 4,096 rows
DLRM_SHAPES = [(4096, 16), (32, 7), (7,), (16,), (624, 1024), (1024,),
               (1024, 512), (512,), (512, 256), (256,), (1024,), (1024,),
               (512,), (512,), (256,), (256,), (256, 1), (1,)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(rng, shapes, scale=1.0):
    return [rng.normal(0, scale, s).astype(np.float32) for s in shapes]


def _reference(arrays, max_norm):
    """The reference's (scale, gnorm) as numpy float32."""
    _, gnorm = j_clip_by_global_norm([jnp.asarray(a) for a in arrays],
                                     max_norm)
    scale = jnp.minimum(1.0, max_norm / (gnorm + 1e-12))
    return np.asarray(scale), np.asarray(gnorm)


def _float64_norm(grads) -> float:
    return float(np.sqrt(sum(np.sum(g.double().numpy() ** 2)
                             for g in grads)))


@pytest.mark.parametrize("max_norm", [1e3, 10.0, 0.5],
                         ids=["below", "near", "above"])
def test_plain_norm_and_scale_match_the_reference(rng, max_norm):
    arrays = _leaves(rng, DLRM_SHAPES, 0.05)
    scale, gnorm = global_norm_clip([torch.from_numpy(a) for a in arrays],
                                    max_norm)
    want_scale, want_norm = _reference(arrays, max_norm)
    assert scale.dtype == gnorm.dtype == torch.float32
    assert scale.shape == gnorm.shape == ()
    np.testing.assert_allclose(gnorm.numpy(), want_norm, **CLIP)
    np.testing.assert_allclose(scale.numpy(), want_scale, **CLIP)


@pytest.mark.parametrize("case", ["nan", "inf", "overflow"])
def test_a_non_finite_leaf_gives_a_non_finite_norm(rng, case):
    """NaN or inf in any leaf, or float32 squares (1e38 each, finite)
    whose sum passes float32's range: the norm is not finite, so the
    trainer's guard (``isfinite(gnorm)``) skips the step."""
    grads = [torch.from_numpy(a) for a in _leaves(rng, [(300, 4), (17,)])]
    bad = {"nan": float("nan"), "inf": float("inf"), "overflow": 1e19}[case]
    grads.append(torch.full((10,), bad) if case == "overflow"
                 else torch.tensor([1.0, bad, 2.0]))
    scale, gnorm = global_norm_clip(grads, 10.0)
    assert not bool(torch.isfinite(gnorm))
    assert bool(torch.isnan(gnorm)) == (case == "nan")
    want_scale, want_norm = _reference([g.numpy() for g in grads], 10.0)
    np.testing.assert_array_equal(gnorm.numpy(), want_norm)
    np.testing.assert_array_equal(scale.numpy(), want_scale)


def test_bf16_leaves_widen_before_squaring(rng):
    arrays = _leaves(rng, [(999,), (64, 8), (13,)], 3.0)
    grads = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    scale, gnorm = global_norm_clip(grads, 0.5)
    np.testing.assert_allclose(float(gnorm), _float64_norm(grads), rtol=1e-6)
    widened = [g.float().numpy() for g in grads]
    want_scale, want_norm = _reference(widened, 0.5)
    np.testing.assert_allclose(gnorm.numpy(), want_norm, **CLIP)
    np.testing.assert_allclose(scale.numpy(), want_scale, **CLIP)


def test_a_zero_size_leaf_adds_nothing(rng):
    grads = [torch.from_numpy(a) for a in _leaves(rng, [(100, 3), (7,)])]
    with_empty = [grads[0], torch.zeros((0, 4)), grads[1], torch.zeros(0)]
    for x, y in zip(global_norm_clip(with_empty, 1.0),
                    global_norm_clip(grads, 1.0)):
        assert torch.equal(x, y)


def test_a_tree_of_more_leaves_than_one_launch_takes(rng):
    """The plain version sums any number of leaves; the card's one launch
    takes ``MAX_LEAVES``, and its path refuses one more."""
    shapes = [(int(n),) for n in rng.integers(0, 40, MAX_LEAVES + 1)]
    grads = [torch.from_numpy(a) for a in _leaves(rng, shapes)]
    _, gnorm = global_norm_clip(grads, 1.0)
    np.testing.assert_allclose(float(gnorm), _float64_norm(grads), **CLIP)
    ops._check(grads[:MAX_LEAVES])
    with pytest.raises(ValueError, match=f"at most {MAX_LEAVES} leaves"):
        ops._check(grads)


class _FakeLib:
    """Stands in for the pass's library: records what one call of its C
    interface receives and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def global_norm(self, ptrs, counts, types, n, scratch, max_norm, out,
                    stream):
        self.calls.append({"ptrs": list(ptrs[:n]), "counts": list(counts[:n]),
                           "types": list(types[:n]), "n": n,
                           "scratch": scratch, "max_norm": max_norm,
                           "out": out, "stream": stream})
        return self.err


@pytest.mark.parametrize("tree", ["float32", "mixed", "zero-size",
                                  "max leaves"])
def test_the_card_path_hands_every_leaf_to_one_launch(rng, monkeypatch,
                                                      tree):
    """``_launch`` passes every leaf, in order, with its element count and
    type code, the scratch, the clip norm, the output and the stream to one
    call of the pass, and counts one launch."""
    grads = {"float32": lambda: [torch.zeros(40, 3), torch.zeros(9)],
             "mixed": lambda: [torch.zeros(5, dtype=torch.bfloat16),
                               torch.zeros(7, 2)],
             "zero-size": lambda: [torch.zeros(0, 4), torch.zeros(3),
                                   torch.zeros(0)],
             "max leaves": lambda: [torch.zeros(int(n)) for n in
                                    rng.integers(0, 9, MAX_LEAVES)]}[tree]()
    lib = _FakeLib()
    monkeypatch.setattr(ops, "_lib", lambda: lib)
    scratch, out = torch.zeros(64, dtype=torch.uint8), torch.empty(2)
    before = global_norm_clip.launches
    ops._launch(grads, 0.5, scratch, out, 1234)
    assert global_norm_clip.launches - before == 1
    (call,) = lib.calls
    assert call["n"] == len(grads)
    assert call["ptrs"] == [g.data_ptr() or None for g in grads]
    assert call["counts"] == [g.numel() for g in grads]
    assert call["types"] == [ops.TYPES[g.dtype] for g in grads]
    assert (call["scratch"], call["out"], call["stream"]) == (
        scratch.data_ptr(), out.data_ptr(), 1234)
    assert call["max_norm"] == 0.5


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch):
    monkeypatch.setattr(ops, "_lib", lambda: _FakeLib(err=700))
    before = global_norm_clip.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ops._launch([torch.zeros(3)], 1.0, torch.zeros(8, dtype=torch.uint8),
                    torch.empty(2), 0)
    assert global_norm_clip.launches == before


@pytest.mark.parametrize("case", ["non-contiguous", "dtype", "devices",
                                  "too many"])
def test_the_card_path_checks_raise(case):
    good = torch.zeros(4, 3)
    if case == "too many":
        with pytest.raises(ValueError, match=f"not {MAX_LEAVES + 1}"):
            ops._check([good] * (MAX_LEAVES + 1))
        return
    bad = {"non-contiguous": torch.zeros(3, 4).t(),
           "dtype": torch.zeros(4, dtype=torch.float64),
           "devices": torch.zeros(4, device="meta")}[case]
    error = TypeError if case == "dtype" else ValueError
    with pytest.raises(error, match="leaf 1"):
        ops._check([good, bad])
    ops._check([good, good.to(torch.bfloat16)])
    with pytest.raises(ValueError, match="at least one leaf"):
        ops._check([])


def test_clip_scale_goes_through_the_wrapper(rng, monkeypatch):
    tree = {"a": torch.from_numpy(_leaves(rng, [(40, 3)])[0]),
            "b": {"c": torch.from_numpy(_leaves(rng, [(9,)])[0])}}
    calls = []

    def counted(grads, max_norm):
        calls.append([g.data_ptr() for g in grads])
        return global_norm_clip(grads, max_norm)
    monkeypatch.setattr("repro_torch.train.optimizer.global_norm_clip",
                        counted)
    scale, gnorm = clip_scale(tree, 0.5)
    clipped, gnorm2 = clip_by_global_norm(tree, 0.5)
    assert calls == [[g.data_ptr() for g in leaves(tree)]] * 2
    assert torch.equal(gnorm, gnorm2) and float(scale) < 1.0
    for c, g in zip(leaves(clipped), leaves(tree)):
        assert torch.equal(c, g * scale)
    assert kernels.COUNTERS["global_norm"] is global_norm_clip


def test_meta_leaves_are_one_region_charged_a_read_of_every_leaf():
    from repro_torch.analysis.op_walk import OpWalk
    grads = [torch.empty(1000, 16, device="meta"),
             torch.empty(7, dtype=torch.bfloat16, device="meta")]
    scale, gnorm = global_norm_clip(grads, 10.0)
    assert scale.is_meta and gnorm.is_meta and scale.shape == ()
    grads = [torch.ones(1000, 16), torch.ones(7)]
    with OpWalk() as w:
        global_norm_clip(grads, 10.0)
    (reg,) = w.regions()
    assert reg.name == "global_norm"
    assert reg.bytes == 1000 * 16 * 4 + 7 * 4 + 8
    assert [it for it in w.items if it.kind == "op"] == []
